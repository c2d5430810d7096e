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
the output's panel-edge traces, one operator launch per RK stage, on the
packed states ``pack(q)``; ``traces`` bootstraps the chain; in absolute
form ``pack``/``unpack`` are the identity.
The exponential integrators' Jacobian action J(q).v comes in two stages,
as the JAX package's ``jtv_prep``/``jtv_apply`` (models/
euler_cubesphere.py:846-888 there): ``jtv_prep(q)`` once per linearisation
point (q's traces and halo, then one launch of the tangent prep kernel,
which writes the linearisation's coefficients), ``jtv_apply(prep, v)`` once
per Krylov iteration (the direction's traces and halo, then one launch of
the linear tangent apply kernel); on the CPU the plain tangent
(``torch.func.jvp`` of the plain operator).
With ``perturbation_base=q0`` the RHS is the perturbation (base-state-split)
form, as the JAX package's ``rhs_pert``/``rhs_fast`` (models/
euler_cubesphere.py:674-720, :827-899 there): the absolute state goes in,
``rhs0 + delta`` comes out, and the Jacobian action is J(q0 + dq).v from
the perturbation form's prep and the same apply — the float32 companion of the
mixed-precision Krylov loop. There ``pack(q) = q - q0`` and ``unpack(dq) =
q0 + dq``, and ``stage``/``traces`` work on the packed deltas (the JAX
package's ``packed_stage_chained`` with ``pert=``, :797-822 and :889-899
there): one launch of the kernel's perturbation stage mode a stage, which
emits the output's delta traces — the JAX package's production float32
explicit point (bench.py:623-685). The integrators step the absolute
trajectory exactly, since every TVD-RK3 and Euler stage has a + b = 1.
On a geometry with bottom topography (DCMIP 20, 21, 22) the constants keep
every panel's metric and the operator, prep and apply launch their terrain
instantiations; ``damping`` (DCMIP 21/22, ``RayleighDamping``) adds the
Rayleigh sponge the JAX factory takes as ``extra_forcing`` (there through
XLA only, not through its kernel) to the momentum forcing, in the RHS and
in the Jacobian action; the perturbation form refuses it, as the JAX one
does. The JAX factory's ``advection_only`` (DCMIP 11/12, which it runs
through XLA) is ``Euler3DAdvectionRHS``: the tracer-advection operator
under prescribed winds on a state of 5 + nt rows, one launch of its own
kernel (``ops.euler3d_advection``) an RHS call or RK stage, with the same
fused stage API, and its Jacobian action in two stages as the five-variable
RHS's: ``jtv_prep(q)`` (q's traces and halo, then one launch of the
advection tangent's prep kernel) and ``jtv_apply(prep, v)`` (the
direction's traces and halo, then one launch of its linear apply kernel),
the kernels' plain versions on the CPU; no well-balanced offset (the JAX
factory ignores ``base_state`` there).
"""

from dataclasses import dataclass
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
    euler3d_advection,
    euler3d_advection_tangent_apply,
    euler3d_advection_tangent_prep,
    euler3d_operator,
    euler3d_tangent_apply,
    euler3d_tangent_pert_plain,
    euler3d_tangent_plain,
    euler3d_tangent_prep,
    halo_from_traces,
    has_topography,
)
from ..parallel.topology import CubedSphereTopology


@dataclass(frozen=True)
class RayleighDamping:
    """The Rayleigh sponge of DCMIP 21/22 (``testcases.make_schar_damping``),
    host float64 planes (6, nk, ny, nx, s^3): the mask (1/s) and the
    reference contravariant winds. Its momentum forcing is ``rho mask (u_i
    - u_ref_i)`` (the JAX package's ``extra_forcing``)."""

    mask: np.ndarray
    u1ref: np.ndarray
    u2ref: np.ndarray
    u3ref: np.ndarray


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
    (``base_state`` is then ignored, as in the JAX package).

    A geometry with topography keeps every panel's metric (the terrain
    kernels); ``damping`` (a ``RayleighDamping`` on such a geometry) adds
    the Rayleigh sponge, and is refused with ``perturbation_base``."""

    def __init__(self, geom, ops, metric, dtype=torch.float64, device="cuda", topology=None,
                 base_state=None, perturbation_base=None, damping: Optional[RayleighDamping] = None):
        self.dtype = dtype
        self.device = resolve_device(device)
        self.topology = topology if topology is not None else CubedSphereTopology(geom)
        if damping is not None and perturbation_base is not None:
            raise ValueError("perturbation_base takes no Rayleigh damping (the JAX perturbation form refuses "
                             "extra_forcing, models/euler_cubesphere.py:679 there)")
        panel_metric = has_topography(geom)
        self.con = build_constants(ops, metric, geom.nel_h, geom.nel_v, dtype=dtype, device=self.device,
                                   panel_metric=panel_metric, damping=damping)
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
        con64 = build_constants(ops, metric, geom.nel_h, geom.nel_v, dtype=torch.float64, device=self.device,
                                panel_metric=panel_metric, damping=damping)
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
        """Panel-edge traces of a packed state (5, 4, 6, nk, nh, s^2): the
        chain's bootstrap (delta traces in perturbation form)."""
        if self.pert is not None:
            return edge_traces_delta(q, self.pert, self.con)
        return edge_traces(q, self.con)

    def halo(self, traces: torch.Tensor) -> torch.Tensor:
        return halo_from_traces(traces, self.topology)

    def __call__(self, q: torch.Tensor) -> torch.Tensor:
        if self.pert is not None:
            return self.delta(self.pack(q))
        return euler3d_operator(q, self.halo(self.traces(q)), self.con, bal=self.bal)

    def delta(self, qprime: torch.Tensor) -> torch.Tensor:
        """RHS(q0 + qprime), the perturbation passed as it is (perturbation form)."""
        if self.pert is None:
            raise ValueError("delta needs a perturbation_base")
        halo = self.halo(edge_traces_delta(qprime, self.pert, self.con))
        return euler3d_operator(qprime, halo, self.con, pert=self.pert)

    def stage(self, x, y, a: float, b: float, cdt: float, traces: Optional[torch.Tensor] = None):
        """One fused RK stage ``a*x + b*y + cdt*RHS(y)`` on packed states
        (``x`` unused when ``a == 0``); ``traces`` are y's panel-edge traces
        (bootstrapped when None). Returns (output, output traces): in
        perturbation form the stage combination of deltas and the output's
        delta traces, from one launch of the perturbation stage mode."""
        if traces is None:
            traces = self.traces(y)
        return euler3d_operator(y, self.halo(traces), self.con, x=x, a=a, b=b, cdt=cdt, bal=self.bal,
                                emit_traces=True, pert=self.pert)

    def jtv_prep(self, q: torch.Tensor):
        """What every Jacobian action at ``q`` shares: (the operator's state
        input, the absolute state and its panel-edge traces for the tangent
        glue, the input's halo, the linearisation's coefficients from one
        launch of the tangent prep kernel; None on the CPU). In perturbation
        form (the JAX ``jtv_prep``, models/euler_cubesphere.py:846-858 there)
        the input is dq = q.to(dtype) - q0 in the working dtype with its delta
        halo, and the absolute state and traces are q0 + dq and t0 + dt."""
        if self.pert is None:
            q_in, qa, traces = q, q, self.traces(q)
            halo = self.halo(traces)
        else:
            q_in = q.to(self.dtype) - self.pert.q0
            dtraces = edge_traces_delta(q_in, self.pert, self.con)
            qa, traces, halo = self.pert.q0 + q_in, self.pert.traces0 + dtraces, self.halo(dtraces)
        coef = None if q_in.device.type == "cpu" else euler3d_tangent_prep(q_in, halo, self.con, pert=self.pert)
        return q_in, qa, traces, halo, coef

    def jtv_apply(self, prep, v: torch.Tensor) -> torch.Tensor:
        """J(q).v for the ``prep`` of q: one tangent glue pass and one
        launch of the linear tangent apply kernel. On the CPU the plain
        tangent (``torch.func.jvp`` of the plain operator): the CPU Ros2
        test against the JAX ``Ros2`` sits closer to its bound than the
        split's rounding allows (ROADMAP.md §3); the split's plain versions
        run in ``euler3d_tangent``. The well-balanced offset is a constant
        and has no derivative."""
        q_in, qa, traces, halo_q, coef = prep
        halo_v = self.halo(edge_traces_tangent(qa, v, self.con, traces))
        if coef is None:
            if self.pert is not None:
                return euler3d_tangent_pert_plain(q_in, v, halo_q, halo_v, self.con, self.pert)
            return euler3d_tangent_plain(q_in, v, halo_q, halo_v, self.con)
        return euler3d_tangent_apply(v, halo_v, coef, self.con)

    def jtv(self, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return self.jtv_apply(self.jtv_prep(q), v)

    def pack(self, q: torch.Tensor) -> torch.Tensor:
        """The integrators' state: q itself, or q - q0 in the working dtype
        in perturbation form (q0 in q's dtype)."""
        if self.pert is None:
            return q
        return (q - self.pert.q0.to(q.dtype)).to(self.dtype).contiguous()

    def unpack(self, qp: torch.Tensor) -> torch.Tensor:
        """The model-layout state of a packed one: q0 + dq in perturbation form."""
        if self.pert is None:
            return qp
        return self.pert.q0 + qp


class Euler3DAdvectionRHS:
    """The RHS of DCMIP 11/12 (the JAX factory's ``advection_only``) at one
    discretization, dtype and device (the card unless the caller asks for
    the CPU): tracer transport under the winds the state's momenta carry,
    rows 0-4 of the RHS exactly 0, on states of 5 + nt rows (the kernel
    takes nt = 1 or 4; the CPU's plain version any). The fused stage API
    of ``Euler3DRHS`` (``traces``, ``halo``, ``stage``, identity ``pack`` /
    ``unpack``, ``__call__``): one advection launch an RHS call or stage.
    The Jacobian action J(q).v (what the exponential, Rosenbrock and
    implicit integrators and the lu/ilu preconditioners take; the JAX
    package takes jax.jvp of its XLA RHS) through ``jtv_prep``/``jtv_apply``:
    one launch of the advection tangent's prep kernel a linearisation point
    and one of its apply kernel a J.v on the card, their plain versions on
    the CPU. The geometry must be flat (one panel's metric)."""

    def __init__(self, geom, ops, metric, dtype=torch.float64, device="cuda", topology=None):
        if has_topography(geom):
            raise ValueError("the advection operator of DCMIP 11/12 takes a geometry without topography")
        self.dtype = dtype
        self.device = resolve_device(device)
        self.topology = topology if topology is not None else CubedSphereTopology(geom)
        self.con = build_constants(ops, metric, geom.nel_h, geom.nel_v, dtype=dtype, device=self.device)
        # The halo exchange's device tables, made here rather than inside a step.
        self.topology.gather_index_3d(geom.nel_v, self.con.device)
        self.topology.conv_coefficients(self.con.device, dtype)

    def traces(self, q: torch.Tensor) -> torch.Tensor:
        """Panel-edge traces of every row of a state: the chain's bootstrap."""
        return edge_traces(q, self.con)

    def halo(self, traces: torch.Tensor) -> torch.Tensor:
        return halo_from_traces(traces, self.topology)

    def __call__(self, q: torch.Tensor) -> torch.Tensor:
        return euler3d_advection(q, self.halo(self.traces(q)), self.con)

    def stage(self, x, y, a: float, b: float, cdt: float, traces: Optional[torch.Tensor] = None):
        """One fused RK stage ``a*x + b*y + cdt*RHS(y)`` (``x`` unused when
        ``a == 0``); ``traces`` are y's panel-edge traces (bootstrapped when
        None). Returns (output, its traces), from one advection launch."""
        if traces is None:
            traces = self.traces(y)
        return euler3d_advection(y, self.halo(traces), self.con, x=x, a=a, b=b, cdt=cdt, emit_traces=True)

    def jtv_prep(self, q: torch.Tensor):
        """What every Jacobian action at ``q`` shares: (q, its panel-edge
        traces for the direction's glue, the linearisation's coefficients
        from one prep launch)."""
        traces = self.traces(q)
        return q, traces, euler3d_advection_tangent_prep(q, self.halo(traces), self.con)

    def jtv_apply(self, prep, v: torch.Tensor) -> torch.Tensor:
        """J(q).v for the ``prep`` of q: the direction's traces and halo, then
        one apply launch; rows 0-4 exactly 0."""
        q, traces, coef = prep
        halo_v = self.halo(edge_traces_tangent(q, v, self.con, traces))
        return euler3d_advection_tangent_apply(v, halo_v, coef, self.con)

    def jtv(self, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return self.jtv_apply(self.jtv_prep(q), v)

    def pack(self, q: torch.Tensor) -> torch.Tensor:
        return q

    def unpack(self, qp: torch.Tensor) -> torch.Tensor:
        return qp
