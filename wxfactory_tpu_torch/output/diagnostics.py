"""Shallow-water diagnostics: vorticity, energy, enstrophy, global integrals.

Capability parity with the reference's output/diagnostic.py. One deliberate
correction: relative vorticity here is the mathematically standard
(1/sqrt(g)) * (d(u_2cov)/dx1 - d(u_1cov)/dx2); the reference
(diagnostic.py:9-20) differentiates the components the other way around.
"""

import numpy as np

from ..common.constants import GRAVITY
from ..geometry.metric import Metric2D
from ..ops.dfr import DFROperators


def _covariant(u1, u2, metric: Metric2D):
    u1_cov = metric.H_cov_11 * u1 + metric.H_cov_12 * u2
    u2_cov = metric.H_cov_21 * u1 + metric.H_cov_22 * u2
    return u1_cov, u2_cov


def relative_vorticity(u1, u2, metric: Metric2D, ops: DFROperators):
    u1_cov, u2_cov = _covariant(u1, u2, metric)
    du2_dx1 = u2_cov @ ops.derivative_x
    du1_dx2 = u1_cov @ ops.derivative_z
    return metric.inv_sqrtG * (du2_dx1 - du1_dx2)


def absolute_vorticity(u1, u2, metric: Metric2D, ops: DFROperators):
    return relative_vorticity(u1, u2, metric, ops) + metric.coriolis_f


def potential_vorticity(h, u1, u2, metric: Metric2D, ops: DFROperators):
    return absolute_vorticity(u1, u2, metric, ops) / h


def potential_enstrophy(h, u1, u2, metric: Metric2D, ops: DFROperators):
    return absolute_vorticity(u1, u2, metric, ops) ** 2 / (2.0 * h)


def total_energy(h, u1, u2, metric: Metric2D, topo=None):
    u1_cov, u2_cov = _covariant(u1, u2, metric)
    kinetic = 0.5 * h * (u1_cov * u1 + u2_cov * u2)
    if topo is not None:
        potential = 0.5 * GRAVITY * ((h + topo.hsurf) ** 2 - topo.hsurf**2)
    else:
        potential = 0.5 * GRAVITY * h**2
    return kinetic + potential


def global_integral_2d(field, ops: DFROperators, metric: Metric2D) -> float:
    """Quadrature-weighted global integral over all panels (a psum under
    sharding; reference diagnostic.py:60-65)."""
    w = np.asarray(ops.quad_weights).reshape(-1)
    return float(np.sum(np.asarray(field) * metric.sqrtG * w))
