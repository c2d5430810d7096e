"""Hand the JAX package's host data to the port.

The JAX package builds its setup objects (``DFROperators``, ``Metric2D``,
``Metric3D``, ``CubedSphere2D``, ``CubedSphere3D``, initial states) in float64 numpy with the same code the
port carries, so the port's setup functions accept them as they are. These helpers
turn them into the port's tensors and constant structs on a given device,
so a test can drive both packages from identical inputs. Nothing here
imports JAX: arrays arrive as numpy (``np.asarray`` of a JAX array).
"""

import numpy as np
import torch

from .models.euler_cubesphere import Euler3DRHS
from .models.shallow_water import ShallowWaterRHS
from .ops import euler3d_operator
from .ops.sw_operator import SWConstants, build_constants


def to_tensor(a, device="cpu", dtype=torch.float64) -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a tensor."""
    return torch.as_tensor(np.ascontiguousarray(np.asarray(a)), dtype=dtype, device=device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def sw_constants(ops, metric, nel: int, device="cpu", dtype=torch.float64) -> SWConstants:
    """The SW operator's constants from DFR operators and a 2D metric."""
    return build_constants(ops, metric, nel, dtype=dtype, device=device)


def shallow_water_rhs(geom, ops, metric, device="cpu", dtype=torch.float64,
                      perturbation_base=None) -> ShallowWaterRHS:
    """The port's SW RHS on a geometry, operators and metric built by
    either package (``perturbation_base``: the base state q0 of the
    perturbation form, a numpy array as the JAX factory takes it)."""
    return ShallowWaterRHS(geom, ops, metric, dtype=dtype, device=device, perturbation_base=perturbation_base)


def euler3d_constants(ops, metric, nel_h: int, nel_v: int, device="cpu",
                      dtype=torch.float64) -> euler3d_operator.E3Constants:
    """The 3D Euler operator's constants from 3D DFR operators and a 3D metric."""
    return euler3d_operator.build_constants(ops, metric, nel_h, nel_v, dtype=dtype, device=device)


def euler3d_rhs(geom, ops, metric, device="cpu", dtype=torch.float64, base_state=None,
                perturbation_base=None) -> Euler3DRHS:
    """The port's 3D Euler RHS on a geometry, operators and metric built by
    either package (``base_state``: the well-balanced offset's state;
    ``perturbation_base``: the base state q0 of the perturbation form, a
    numpy array as the JAX factory takes it)."""
    return Euler3DRHS(geom, ops, metric, dtype=dtype, device=device, base_state=base_state,
                      perturbation_base=perturbation_base)
