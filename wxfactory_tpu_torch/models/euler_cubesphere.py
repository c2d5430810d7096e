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
With ``perturbation_base=q0`` the RHS is the perturbation (base-state-split)
form, as the JAX package's ``rhs_pert``/``rhs_fast`` (models/
euler_cubesphere.py:674-720, :827-899 there): the absolute state goes in,
``rhs0 + delta`` comes out, and the Jacobian action is the kernel's
perturbation tangent mode, J(q0 + dq).v — the float32 companion of the
mixed-precision Krylov loop.
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
    build_pert_base,
    edge_traces,
    edge_traces_delta,
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
    same device (the kernel on a GPU, the plain version on the CPU).

    With ``perturbation_base`` (a balanced state q0 of the 5 dynamical
    variables) the operator runs in perturbation form around it: calls take
    the absolute state and return ``rhs0 + delta``; ``delta(qprime)`` takes
    the perturbation itself; the base (``pert``: q0, the float64 base RHS,
    q0's halo and traces) is built once in float64 on the same device
    (``base_state`` is then ignored, as in the JAX package)."""

    def __init__(self, geom, ops, metric, dtype=torch.float64, device="cuda", topology=None,
                 base_state=None, perturbation_base=None):
        self.dtype = dtype
        self.device = resolve_device(device)
        self.topology = topology if topology is not None else CubedSphereTopology(geom)
        self.con = build_constants(ops, metric, geom.nel_h, geom.nel_v, dtype=dtype, device=self.device)
        # The halo exchange's device tables are made here, not at the first
        # call: a copy from the host inside a step would wait for the card.
        # They are keyed by the tensors' own device ("cuda:0", not "cuda").
        self.topology.gather_index_3d(geom.nel_v, self.con.device)
        self.topology.conv_coefficients(self.con.device, dtype)
        self.bal = None
        self.pert = None
        base = perturbation_base if perturbation_base is not None else base_state
        if base is None:
            return
        q64 = torch.as_tensor(np.asarray(base), dtype=torch.float64, device=self.device)
        con64 = build_constants(ops, metric, geom.nel_h, geom.nel_v, dtype=torch.float64, device=self.device)
        if perturbation_base is not None:
            if q64.shape != self.con.state_shape:
                raise ValueError("perturbation_base supports the plain 5-variable system "
                                 f"{self.con.state_shape}, not {tuple(q64.shape)}")
            self.pert = build_pert_base(q64, con64, self.topology, dtype)
        else:
            rhs64 = euler3d_operator(q64, self.halo(edge_traces(q64, con64)), con64)
            k0 = self(q64.to(dtype))
            self.bal = (rhs64 - k0.double()).to(dtype)

    @property
    def base_state(self) -> Optional[torch.Tensor]:
        """The perturbation base q0 in the working dtype (None in absolute form)."""
        return self.pert.q0 if self.pert is not None else None

    def traces(self, q: torch.Tensor) -> torch.Tensor:
        """Panel-edge traces of ``q`` (5, 4, 6, nk, nh, s^2): the chain's bootstrap."""
        return edge_traces(q, self.con)

    def halo(self, traces: torch.Tensor) -> torch.Tensor:
        return halo_from_traces(traces, self.topology)

    def __call__(self, q: torch.Tensor) -> torch.Tensor:
        if self.pert is not None:
            return self.delta((q - self.pert.q0.to(q.dtype)).to(self.dtype))
        return euler3d_operator(q, self.halo(self.traces(q)), self.con, bal=self.bal)

    def delta(self, qprime: torch.Tensor) -> torch.Tensor:
        """RHS(q0 + qprime), the perturbation passed as it is (perturbation form)."""
        if self.pert is None:
            raise ValueError("delta needs a perturbation_base")
        halo = self.halo(edge_traces_delta(qprime, self.pert, self.con))
        return euler3d_operator(qprime, halo, self.con, pert=self.pert)

    def stage(self, x, y, a: float, b: float, cdt: float, traces: Optional[torch.Tensor] = None):
        """One fused RK stage ``a*x + b*y + cdt*RHS(y)`` (``x`` unused when
        ``a == 0``); ``traces`` are y's panel-edge traces (bootstrapped when
        None). Returns (output, output traces). Absolute form only: the
        perturbation form's stage and emitted delta traces are not ported
        (ROADMAP queue 1)."""
        if self.pert is not None:
            raise NotImplementedError("the perturbation form's fused RK stage is not ported (ROADMAP queue 1)")
        if traces is None:
            traces = self.traces(y)
        return euler3d_operator(y, self.halo(traces), self.con, x=x, a=a, b=b, cdt=cdt, bal=self.bal,
                                emit_traces=True)

    def jtv_prep(self, q: torch.Tensor):
        """What every Jacobian action at ``q`` shares: (the operator's state
        input, the absolute state and its panel-edge traces for the tangent
        glue, the input's halo). In perturbation form (the JAX ``jtv_prep``,
        models/euler_cubesphere.py:846-858 there) the input is dq =
        q.to(dtype) - q0 in the working dtype with its delta halo, and the
        absolute state and traces are q0 + dq and t0 + dt."""
        if self.pert is None:
            traces = self.traces(q)
            return q, q, traces, self.halo(traces)
        dq = q.to(self.dtype) - self.pert.q0
        dtraces = edge_traces_delta(dq, self.pert, self.con)
        return dq, self.pert.q0 + dq, self.pert.traces0 + dtraces, self.halo(dtraces)

    def jtv_apply(self, prep, v: torch.Tensor) -> torch.Tensor:
        """J(q).v for the ``prep`` of q: one tangent glue pass and one
        launch of the tangent kernel, in perturbation mode with a base (the
        plain tangent on the CPU). The well-balanced offset is a constant
        and has no derivative."""
        q_in, qa, traces, halo_q = prep
        halo_v = self.halo(edge_traces_tangent(qa, v, self.con, traces))
        return euler3d_tangent(q_in, v, halo_q, halo_v, self.con, pert=self.pert)

    def jtv(self, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return self.jtv_apply(self.jtv_prep(q), v)

    @staticmethod
    def pack(q: torch.Tensor) -> torch.Tensor:
        return q

    @staticmethod
    def unpack(q: torch.Tensor) -> torch.Tensor:
        return q

