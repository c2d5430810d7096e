"""3D compressible Euler equations on the cubed sphere (DFR discretization).

Counterpart of ``wxfactory_tpu/models/euler_cubesphere.py`` (absolute form
and its well-balanced ``base_state`` offset): the state is
``Q[5, 6, nk, ny, nx, s^3]`` (rho, rho*u1, rho*u2, rho*w, rho*theta) and the
whole spatial operator is ``ops.euler3d_operator`` — the hand-written CUDA
kernel on a GPU, its plain torch version on the CPU — composed with the
torch halo glue.

The returned object is the RHS ``q -> dq/dt`` and exposes the fused stage
API the explicit integrators chain (the same as ``ShallowWaterRHS``):
``stage(x, y, a, b, cdt, traces)`` returns ``a*x + b*y + cdt*RHS(y)`` and
the output's panel-edge traces, one operator launch per RK stage;
``traces(q)`` bootstraps the chain; ``pack``/``unpack`` are the identity.
The exponential integrators' Jacobian action J(q).v comes in two stages,
as the JAX package's ``jtv_prep``/``jtv_apply`` (models/
euler_cubesphere.py:846-888 there): ``jtv_prep(q)`` once per linearisation
point (q's traces and halo), ``jtv_apply(prep, v)`` once per Krylov
iteration (the direction's traces and halo, then one launch of the
kernel's tangent mode on a GPU, the plain tangent on the CPU).
The JAX factory's ``advection_only`` (DCMIP 11/12) and ``extra_forcing``
(DCMIP 21/22) run through XLA there, not through its kernel; the port's
``initial_state_3d`` refuses those cases (ROADMAP queue 1, item 9).
"""

from typing import Optional

import numpy as np
import torch

from ..common.device import resolve_device
from ..ops.euler3d_operator import (
    build_constants,
    edge_traces,
    edge_traces_tangent,
    euler3d_operator,
    euler3d_tangent,
    halo_from_traces,
)
from ..parallel.topology import CubedSphereTopology


class Euler3DRHS:
    """The 3D Euler RHS at one discretization, dtype and device (the card
    unless the caller asks for the CPU; a CUDA request without a card
    raises).

    With ``base_state`` (a balanced state, usually the initial condition)
    the operator adds the well-balanced offset ``bal = RHS_f64(q0) -
    K(q0)``, K the operator in this RHS's dtype: in float32 the hydrostatic
    balance is a ~1e-9-relative cancellation of the pressure gradient and
    gravity, below float32 resolution; the offset restores it exactly at
    q0 and to first order nearby. ``RHS_f64`` runs once, at setup, on the
    same device (the kernel on a GPU, the plain version on the CPU)."""

    def __init__(self, geom, ops, metric, dtype=torch.float64, device="cuda", topology=None,
                 base_state=None):
        self.dtype = dtype
        self.device = resolve_device(device)
        self.topology = topology if topology is not None else CubedSphereTopology(geom)
        self.con = build_constants(ops, metric, geom.nel_h, geom.nel_v, dtype=dtype, device=self.device)
        self.bal = None
        if base_state is not None:
            con64 = build_constants(ops, metric, geom.nel_h, geom.nel_v, dtype=torch.float64, device=self.device)
            q64 = torch.as_tensor(np.asarray(base_state), dtype=torch.float64, device=self.device)
            rhs64 = euler3d_operator(q64, self.halo(edge_traces(q64, con64)), con64)
            k0 = self(q64.to(dtype))
            self.bal = (rhs64 - k0.double()).to(dtype)

    def traces(self, q: torch.Tensor) -> torch.Tensor:
        """Panel-edge traces of ``q`` (5, 4, 6, nk, nh, s^2): the chain's bootstrap."""
        return edge_traces(q, self.con)

    def halo(self, traces: torch.Tensor) -> torch.Tensor:
        return halo_from_traces(traces, self.topology)

    def __call__(self, q: torch.Tensor) -> torch.Tensor:
        return euler3d_operator(q, self.halo(self.traces(q)), self.con, bal=self.bal)

    def stage(self, x, y, a: float, b: float, cdt: float, traces: Optional[torch.Tensor] = None):
        """One fused RK stage ``a*x + b*y + cdt*RHS(y)`` (``x`` unused when
        ``a == 0``); ``traces`` are y's panel-edge traces (bootstrapped when
        None). Returns (output, output traces)."""
        if traces is None:
            traces = self.traces(y)
        return euler3d_operator(y, self.halo(traces), self.con, x=x, a=a, b=b, cdt=cdt, bal=self.bal,
                                emit_traces=True)

    def jtv_prep(self, q: torch.Tensor):
        """What every Jacobian action at ``q`` shares: (q, its panel-edge
        traces, its halo)."""
        traces = self.traces(q)
        return q, traces, self.halo(traces)

    def jtv_apply(self, prep, v: torch.Tensor) -> torch.Tensor:
        """J(q).v for the ``prep`` of q: one tangent glue pass and one
        launch of the tangent kernel (the plain tangent on the CPU). The
        well-balanced offset is a constant and has no derivative."""
        q, traces, halo_q = prep
        halo_v = self.halo(edge_traces_tangent(q, v, self.con, traces))
        return euler3d_tangent(q, v, halo_q, halo_v, self.con)

    def jtv(self, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return self.jtv_apply(self.jtv_prep(q), v)

    @staticmethod
    def pack(q: torch.Tensor) -> torch.Tensor:
        return q

    @staticmethod
    def unpack(q: torch.Tensor) -> torch.Tensor:
        return q

