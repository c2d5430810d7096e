"""Post-step exponential modal filter.

Counterpart of ``wxfactory_tpu/ops/filters.py`` (the reference's
DFROperators filter machinery, operators.py:101-138, 210-261): the
exponential modal filter applied to sqrt(g)*Q after each step, the 3D
Kronecker lift of the 1D filter (``ops/dfr.py::make_filter_matrix``) or its
2D lift on the shallow-water sphere. On the state's device it is one
per-element product with an s^3 (s^2) matrix, weighted by sqrt(g): a
``torch.matmul`` there, as the JAX package computes it in XLA.

As in the JAX package only ``expfilter_apply`` builds a filter:
``filter_apply`` (the reference's older modal filter knob) has no effect
there either. Its Rayleigh sponge of the Cartesian plane (``apply_sponge``
with ``grid_type = cartesian2d``) comes with the Cartesian grid (ROADMAP
queue 1, item 15); the port's ``Simulation`` refuses that grid first.
"""

from typing import Callable, Optional

import numpy as np
import torch

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


def make_apply_filters(config, metric, device="cpu", dtype=torch.float64) -> Optional[Callable]:
    """The post-step filter ``(q, dt) -> q`` on ``device``, or None if no
    filter is active (reference operators.apply_filters,
    simulation.py:148)."""
    if not config.expfilter_apply:
        return None
    three_d = config.equations == "euler" and config.grid_type == "cubed_sphere"
    make = make_expfilter_3d if three_d else make_expfilter_2d
    filt = torch.as_tensor(make(config.num_solpts, config.expfilter_strength, config.expfilter_order,
                                config.expfilter_cutoff), dtype=dtype, device=device)
    sqrt_g = torch.as_tensor(metric.sqrtG, dtype=dtype, device=device)
    inv_sqrt_g = torch.as_tensor(metric.inv_sqrtG, dtype=dtype, device=device)

    def expfilter(q, dt):
        return ((sqrt_g * q) @ filt) * inv_sqrt_g

    return expfilter
