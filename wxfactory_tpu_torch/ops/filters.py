"""Post-step exponential modal filter and Rayleigh sponge.

Counterpart of ``wxfactory_tpu/ops/filters.py`` (the reference's
DFROperators filter machinery, operators.py:101-138, 210-261): the
exponential modal filter applied to sqrt(g)*Q after each step, the 3D
Kronecker lift of the 1D filter (``ops/dfr.py::make_filter_matrix``) or its
2D lift on the shallow-water sphere and the Cartesian plane (there with
sqrt(g) = 1: no metric). On the state's device it is one per-element
product with an s^3 (s^2) matrix, weighted by sqrt(g): a ``torch.matmul``
there, as the JAX package computes it in XLA. The Rayleigh sponge of the
Cartesian plane (``apply_sponge`` with ``grid_type = cartesian2d``)
multiplies rho*w by 1/(1 + beta(z) dt) after each step, beta made once in
numpy and kept on the device: one elementwise torch product a step, as
the JAX package computes it in XLA.

As in the JAX package only ``expfilter_apply`` builds a filter:
``filter_apply`` (the reference's older modal filter knob) has no effect
there either.
"""

from typing import Callable, Optional

import numpy as np
import torch

from ..common.constants import IDX_2D_RHO_W
from .dfr import make_filter_matrix


def make_expfilter_3d(num_solpts: int, strength: float, order: int, cutoff: float) -> np.ndarray:
    """3D-lifted exponential modal filter (operators.py:110-119)."""
    f1 = make_filter_matrix(num_solpts, strength, order, cutoff)
    s = num_solpts
    i2, i3 = np.eye(s), np.eye(s * s)
    fx = np.kron(i3, f1).T
    fy = np.kron(i2, np.kron(f1, i2)).T
    fz = np.kron(f1, i3).T
    return (fx @ fy) @ fz


def make_expfilter_2d(num_solpts: int, strength: float, order: int, cutoff: float) -> np.ndarray:
    f1 = make_filter_matrix(num_solpts, strength, order, cutoff)
    s = num_solpts
    ident = np.eye(s)
    return (np.kron(ident, f1).T) @ (np.kron(f1, ident).T)


def sponge_beta(config, geom) -> np.ndarray:
    """The sponge's damping rate beta(z) (1/s) at every node of a
    ``Cartesian2D``: sin^2(pi/2 (z - zs)/(z1 - zs)) / sponge_tscale above
    zs = z1 - sponge_zscale, 0 below (the JAX package's
    ops/filters.py:62-72)."""
    zs = config.z1 - config.sponge_zscale
    x3 = np.asarray(geom.X3)
    return np.where(
        x3 > zs,
        np.sin(0.5 * np.pi * (x3 - zs) / max(config.z1 - zs, 1e-300)) ** 2 / config.sponge_tscale,
        0.0,
    )


def make_apply_filters(config, metric, device="cpu", dtype=torch.float64, geom=None) -> Optional[Callable]:
    """The post-step filter ``(q, dt) -> q`` on ``device``, or None if no
    filter is active (reference operators.apply_filters,
    simulation.py:148): the exponential filter, then (Cartesian plane,
    ``geom`` given) the sponge."""
    fns = []
    if config.expfilter_apply:
        three_d = config.equations == "euler" and config.grid_type == "cubed_sphere"
        make = make_expfilter_3d if three_d else make_expfilter_2d
        filt = torch.as_tensor(make(config.num_solpts, config.expfilter_strength, config.expfilter_order,
                                    config.expfilter_cutoff), dtype=dtype, device=device)
        if metric is None:
            fns.append(lambda q, dt: q @ filt)
        else:
            sqrt_g = torch.as_tensor(metric.sqrtG, dtype=dtype, device=device)
            inv_sqrt_g = torch.as_tensor(metric.inv_sqrtG, dtype=dtype, device=device)
            fns.append(lambda q, dt: ((sqrt_g * q) @ filt) * inv_sqrt_g)

    if config.apply_sponge and config.grid_type == "cartesian2d":
        beta = torch.as_tensor(sponge_beta(config, geom), dtype=dtype, device=device)

        def sponge(q, dt):
            factor = 1.0 / (1.0 + beta * dt)
            return torch.cat([q[:IDX_2D_RHO_W], (q[IDX_2D_RHO_W] * factor)[None], q[IDX_2D_RHO_W + 1:]])

        fns.append(sponge)

    if not fns:
        return None

    def apply_all(q, dt):
        for fn in fns:
            q = fn(q, dt)
        return q

    return apply_all
