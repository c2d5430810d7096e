"""First-order finite-volume 2D Cartesian Euler RHS.

Counterpart of ``wxfactory_tpu/models/euler_cartesian_fv.py`` (the
reference's rhs/rhs_fv.py with the FV common fluxes of pde/fluxes.py):
cell-centred states serve as both interface states, a selectable common
flux (ausm, rusanov, upwind), rigid walls, gravity; one cell per element of
the geometry. It is the coarse operator of the Cartesian multigrid
families, which take only its Jacobian action. On a GPU an RHS call is one
launch of ``euler_cartesian_fv_kernel`` and the Jacobian action one launch
of ``euler_cartesian_fv_tangent_kernel`` (``ops.euler_cartesian_operator``);
on the CPU their plain versions run.

State: ``Q[4, ncell_z, ncell_x]`` (rho, rho*u, rho*w, rho*theta), or the
same with a trailing axis of 1 (the multigrid levels' s = 1 view). Where the
JAX factory returns (4, ncell_z, ncell_x) for either, this RHS returns the
input's shape, so a level needs no reshaping wrapper.
"""

import torch

from ..common.device import resolve_device
from ..ops.euler_cartesian_operator import build_fv_constants, euler_cartesian_fv, euler_cartesian_fv_tangent
from .euler_cartesian import CartesianOperator

__all__ = ["EulerCartesianFVRHS", "make_rhs_euler_cartesian_fv"]


class EulerCartesianFVRHS(CartesianOperator):
    """The FV RHS of a ``Cartesian2D``'s element grid with one flux, dtype
    and device (the card unless the caller asks for the CPU)."""

    def __init__(self, geom, flux: str = "ausm", dtype=torch.float64, device="cuda"):
        super().__init__(build_fv_constants(geom, flux, dtype=dtype, device=resolve_device(device)),
                         euler_cartesian_fv, euler_cartesian_fv_tangent)


def make_rhs_euler_cartesian_fv(geom, flux: str = "ausm", dtype=torch.float64, device="cuda") -> EulerCartesianFVRHS:
    """Build the FV RHS on the element grid of ``geom`` (the JAX factory's
    name and arguments, with the dtype and device)."""
    return EulerCartesianFVRHS(geom, flux, dtype=dtype, device=device)
