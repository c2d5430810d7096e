"""2D Cartesian compressible Euler equations (x-z slice, rising-bubble lab).

Counterpart of ``wxfactory_tpu/models/euler_cartesian.py``: the state is
``Q[4, nel_z, nel_x, s^2]`` (rho, rho*u, rho*w, rho*theta), node ``kz*s +
kx``, bounded by rigid walls on all four sides; the whole spatial operator
is ``ops.euler_cartesian_operator.euler_cartesian`` — one launch of the
hand-written CUDA kernel on a GPU, its plain torch version on the CPU. The
JAX module's functions on arrays (``pressure``, ``pointwise_fluxes``,
``ausm_flux``, ``wall_flux``) are here on tensors.

``EulerCartesianRHS`` is the RHS ``q -> dq/dt`` with the fused stage API the
explicit integrators chain (as ``ShallowWaterRHS``'s state mode): each
element reads its neighbours' faces from the state itself, so
``stage(x, y, a, b, cdt, traces)`` returns ``(a*x + b*y + cdt*RHS(y),
None)`` from one launch and ``traces`` is None; ``pack``/``unpack`` are the
identity. The Jacobian action ``jtv_prep(q)`` (q itself) and
``jtv_apply(prep, v)`` (one launch of the tangent kernel, the element body
over a dual number; ``torch.func.jvp`` of the plain RHS on the CPU) is
what the exponential, Rosenbrock and implicit integrators and the
multigrid levels take, where the JAX package takes ``jax.jvp`` of its XLA
RHS. The JAX package builds no float32 companion and no metric for this
grid, and neither does the port.
"""

import torch

from ..common.device import resolve_device
from ..ops.euler_cartesian_operator import (
    ausm_flux,
    build_constants,
    euler_cartesian,
    euler_cartesian_tangent,
    pointwise_fluxes,
    pressure,
    wall_flux,
)

__all__ = ["CartesianOperator", "EulerCartesianRHS", "make_rhs_euler_cartesian", "pressure", "pointwise_fluxes",
           "ausm_flux", "wall_flux"]


class CartesianOperator:
    """A right-hand side of the Cartesian plane with its Jacobian action:
    ``op(q, con)`` and ``tangent(q, v, con)`` on the constants ``con`` (one
    device and dtype; the card unless the caller asks for the CPU, where the
    plain versions run). The DFR and FV models are its two kinds."""

    def __init__(self, con, op, tangent):
        self.con = con
        self.dtype = con.dtype
        self.device = con.device
        self._op = op
        self._tangent = tangent

    def __call__(self, q: torch.Tensor) -> torch.Tensor:
        return self._op(q, self.con)

    def jtv_prep(self, q: torch.Tensor) -> torch.Tensor:
        """The linearisation point of ``jtv_apply``: q in this RHS's dtype
        (the tangent kernel reads q and v in one launch; no prep launch)."""
        return q.to(self.dtype).contiguous()

    def jtv_apply(self, prep: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """J(q).v for the ``prep`` of q: one launch of the tangent kernel on
        a GPU, ``torch.func.jvp`` of the plain RHS on the CPU."""
        return self._tangent(prep, v.to(self.dtype).contiguous(), self.con)

    def jtv(self, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return self.jtv_apply(self.jtv_prep(q), v)


class EulerCartesianRHS(CartesianOperator):
    """The DFR RHS of a ``Cartesian2D`` at one order, dtype and device (the
    card unless the caller asks for the CPU; a CUDA request without a card
    raises), with the explicit integrators' stage API."""

    def __init__(self, geom, ops, dtype=torch.float64, device="cuda"):
        super().__init__(build_constants(geom, ops, dtype=dtype, device=resolve_device(device)), euler_cartesian,
                         euler_cartesian_tangent)

    def traces(self, q: torch.Tensor) -> None:
        """The chain's bootstrap: none, since every stage reads its
        neighbours' faces from its input state (no launch)."""
        return None

    def stage(self, x, y, a: float, b: float, cdt: float, traces=None):
        """One fused RK stage ``a*x + b*y + cdt*RHS(y)`` (``x`` unused when
        ``a == 0``), one launch on a GPU; ``traces`` is ignored. Returns
        (output, None)."""
        return euler_cartesian(y, self.con, x=x, a=a, b=b, cdt=cdt), None

    def pack(self, q: torch.Tensor) -> torch.Tensor:
        return q

    def unpack(self, qp: torch.Tensor) -> torch.Tensor:
        return qp


def make_rhs_euler_cartesian(geom, ops, dtype=torch.float64, device="cuda") -> EulerCartesianRHS:
    """Build the DFR RHS of the 2D Cartesian Euler system (the JAX factory's
    name and arguments, with the device)."""
    return EulerCartesianRHS(geom, ops, dtype=dtype, device=device)
