"""Shallow-water equations on the rotated cubed sphere (DFR discretization).

Counterpart of ``wxfactory_tpu/models/shallow_water.py`` (absolute and
perturbation forms, no topography): the state is ``Q[3, 6, ny, nx, s^2]``
(h, h*u1, h*u2) and the whole spatial operator is ``ops.sw_operator`` — the
hand-written CUDA kernel on a GPU, its plain torch version on the CPU —
composed with the halo glue (``sw_edges``, ``sw_halo``: kernels on a GPU,
plain torch on the CPU).

The returned object is the RHS ``q -> dq/dt`` and also exposes the fused
stage API the explicit integrators chain: ``stage(x, y, a, b, cdt, traces)``
returns ``a*x + b*y + cdt*RHS(y)`` and the output's panel-edge traces, so
the next stage's halo needs no separate pass (one operator launch and one
halo launch per RK stage). ``traces(q)`` bootstraps the chain.

In absolute form ``pack``/``unpack`` are the identity: the kernel works in
the model layout. With ``perturbation_base=q0`` the RHS is the perturbation
(base-state-split) form of the JAX package's ``rhs_pert``/``rhs_fast``
(models/shallow_water.py:254-481 and :640-655 there): ``RHS(q) =
RHS_f64(q0) + [RHS(q) - RHS(q0)]`` with the bracket expanded term by term,
so the geostrophic cancellation never has to survive float32 rounding.
Calls take the absolute state; ``delta(dq)`` takes the perturbation as it
is; ``pack(q) = q - q0`` and ``unpack(dq) = q0 + dq``, and ``stage`` and
``traces`` work on the packed deltas — the integrators step the absolute
trajectory exactly, since every TVD-RK3 and Euler stage has a + b = 1.

At s=4 with nel a multiple of 32 (the JAX package's ``run_supported``) the
RHS also exposes ``packed_run(qp, nsteps, abc)``: ``nsteps`` whole TVD-RK3
steps of a packed state in one launch of the whole-run kernel on a GPU.
"""

from typing import Optional

import numpy as np
import torch

from ..common.device import resolve_device
from ..ops.sw_operator import (
    build_base_planes,
    build_constants,
    halo_tables,
    run_supported,
    sw_edges,
    sw_halo,
    sw_operator,
    sw_run,
)
from ..parallel.topology import CubedSphereTopology


class ShallowWaterRHS:
    """The SW RHS at one discretization, dtype and device (the card unless
    the caller asks for the CPU; a CUDA request without a card raises).

    With ``perturbation_base`` (a balanced state q0, usually the initial
    condition) the RHS runs in perturbation form around it; its base planes
    (q0, hu0/h0, q0's face traces and halo, the float64 base RHS) are built
    once in float64 on the same device and cast to ``dtype``."""

    def __init__(self, geom, ops, metric, dtype=torch.float64, device="cuda", topology=None,
                 perturbation_base=None):
        self.dtype = dtype
        self.device = resolve_device(device)
        self.topology = topology if topology is not None else CubedSphereTopology(geom)
        self.con = build_constants(ops, metric, geom.num_elements, dtype=dtype, device=self.device)
        # The halo's device tables are made here, not inside a step.
        if self.device.type == "cuda":
            halo_tables(self.topology, self.con.device, dtype)
        self.base = None
        if perturbation_base is not None:
            con64 = build_constants(ops, metric, geom.num_elements, dtype=torch.float64, device=self.device)
            q64 = torch.as_tensor(np.asarray(perturbation_base), dtype=torch.float64, device=self.device)
            state = (3, 6, self.con.nel, self.con.nel, self.con.s**2)
            if tuple(q64.shape) != state:
                raise ValueError(f"perturbation_base has shape {tuple(q64.shape)}, not {state}")
            self.base = build_base_planes(q64, con64, self.topology, dtype)
        if run_supported(self.con.s, self.con.nel):
            self.packed_run = self._packed_run

    @property
    def base_state(self) -> Optional[torch.Tensor]:
        """The perturbation base q0 in the working dtype (None in absolute form)."""
        return self.base.q0 if self.base is not None else None

    def traces(self, q: torch.Tensor) -> torch.Tensor:
        """Panel-edge traces of a packed state (3, 4, 6, nel, s): the
        chain's bootstrap (delta traces in perturbation form)."""
        return sw_edges(q, self.con)

    def halo(self, traces: torch.Tensor) -> torch.Tensor:
        return sw_halo(traces, self.topology)

    def __call__(self, q: torch.Tensor) -> torch.Tensor:
        if self.base is not None:
            return self.delta(self.pack(q))
        return self.xla(q)

    def delta(self, qprime: torch.Tensor) -> torch.Tensor:
        """RHS(q0 + qprime), the perturbation passed as it is (full
        working-dtype resolution, no absolute-state quantization)."""
        if self.base is None:
            raise ValueError("delta needs a perturbation_base")
        return sw_operator(qprime, self.halo(self.traces(qprime)), self.con, base=self.base)

    def xla(self, q: torch.Tensor) -> torch.Tensor:
        """The absolute-form operator of this dtype on the absolute state
        (what the JAX package's ``rhs_pert.xla`` is)."""
        return sw_operator(q, self.halo(self.traces(q)), self.con)

    def stage(self, x, y, a: float, b: float, cdt: float, traces: Optional[torch.Tensor] = None):
        """One fused RK stage ``a*x + b*y + cdt*RHS(y)`` on packed states
        (``x`` unused when ``a == 0``); ``traces`` are y's panel-edge traces
        (bootstrapped when None). Returns (output, output traces)."""
        if traces is None:
            traces = self.traces(y)
        return sw_operator(y, self.halo(traces), self.con, x=x, a=a, b=b, cdt=cdt, emit_traces=True,
                           base=self.base)

    def pack(self, q: torch.Tensor) -> torch.Tensor:
        """The integrators' state: q itself, or q - q0 in perturbation form."""
        if self.base is None:
            return q
        return (q - self.base.q0.to(q.dtype)).to(self.dtype).contiguous()

    def unpack(self, qp: torch.Tensor) -> torch.Tensor:
        """The model-layout state of a packed one: q0 + dq in perturbation form."""
        if self.base is None:
            return qp
        return self.base.q0 + qp

    def _packed_run(self, qp: torch.Tensor, nsteps: int, abc) -> torch.Tensor:
        """``nsteps`` whole TVD-RK3 steps of the packed state ``qp`` with the
        per-stage rows ``abc`` (``ops.sw_operator.tvdrk3_abc``): one launch
        of the whole-run kernel on a GPU, the plain stages on the CPU."""
        return sw_run(qp, nsteps, abc, self.con, self.topology, base=self.base)


def make_rhs_shallow_water(geom, ops, metric, dtype=torch.float64, device="cuda",
                           topo=None, topology=None, perturbation_base=None) -> ShallowWaterRHS:
    """Build the shallow-water RHS (absolute form, or with
    ``perturbation_base`` the perturbation form; no topography).

    ``topo`` (bottom topography) waits for ROADMAP queue 1, item 4; a
    topography case raises instead of running without its source terms (the
    JAX package's fast paths need ``topo is None`` too)."""
    if topo is not None:
        raise NotImplementedError(
            "shallow water with topography is not ported yet (ROADMAP queue 1, item 4)"
        )
    return ShallowWaterRHS(geom, ops, metric, dtype=dtype, device=device, topology=topology,
                           perturbation_base=perturbation_base)
