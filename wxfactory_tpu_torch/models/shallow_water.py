"""Shallow-water equations on the rotated cubed sphere (DFR discretization).

Counterpart of ``wxfactory_tpu/models/shallow_water.py`` (absolute and
perturbation forms, each with or without bottom topography): the state
is ``Q[3, 6, ny, nx, s^2]``
(h, h*u1, h*u2) and the whole spatial operator is ``ops.sw_operator`` — the
hand-written CUDA kernel on a GPU, its plain torch version on the CPU —
with its halo taken from the state (``halo=None``): on a GPU one launch
whose panel-edge faces read the neighbour panels' state, so an RHS call or
an RK stage is one launch and no halo glue runs between them.

The returned object is the RHS ``q -> dq/dt`` and also exposes the fused
stage API the explicit integrators chain: ``stage(x, y, a, b, cdt, traces)``
returns ``a*x + b*y + cdt*RHS(y)`` and ``None`` in place of the output's
traces, which no stage needs (``traces(q)`` is ``None`` too, with no
launch; the 3D model's stages carry real traces through the same chain).

The Jacobian action ``jtv(q, v)`` (``jtv_prep``/``jtv_apply``, which the
exponential and Rosenbrock integrators take) is J(q).v of the absolute
operator of the RHS's dtype: on a GPU one launch of the tangent prep kernel
a linearisation point and one of the linear apply kernel a J.v;
``torch.func.jvp`` of the plain operator on the CPU.

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

With ``topo`` (a ``Topography``: Williamson cases 5 and 10) the RHS, its
stages and its Jacobian action carry the bottom topography (the JAX
package's models/shallow_water.py:166-249: h + hsurf at the faces, each
interface's hsurf taken from both sides before the flux, the forcing's
g h H^ab dz_b), on a GPU through the operator's and the tangent pair's
kernels with topography. In perturbation form the topography rides the
float64 base (its traces those of h0 + hsurf less each interface's hsurf,
its RHS the absolute one with topography; models/shallow_water.py:254-299
there) and the deltas' forcing gains g dh H^ab dz_b, on a GPU through the
perturbation kernel with topography; the Jacobian action stays the
absolute operator's with topography (the JAX companion's rule).
``packed_run`` refuses it: the whole-run kernel has no topography, and the
JAX package has no such path either.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..common.device import resolve_device
from ..ops.sw_operator import (
    build_base_planes,
    build_constants,
    build_topography,
    halo_tables,
    run_supported,
    sw_operator,
    sw_run,
    sw_tangent,
    sw_tangent_apply,
    sw_tangent_prep,
)
from ..parallel.topology import CubedSphereTopology

_NO_PACKED_TOPO = ("packed_run with topography: the whole-run kernel has none, and neither has the JAX package "
                   "(its kr_run path takes no topography, models/shallow_water.py:441 and :482 there; ROADMAP "
                   "queue 1, item 14)")


@dataclass(frozen=True)
class Topography:
    """Bottom topography fields, host float64 numpy (the JAX package's
    ``models.shallow_water.Topography``, reference init/initialize.py Topo)."""

    hsurf: np.ndarray  # (6, ny, nx, s^2)
    hsurf_itf_x1: np.ndarray  # (6, ny, nx+1, s) at x1 interfaces
    hsurf_itf_x2: np.ndarray  # (6, ny+1, nx, s) at x2 interfaces
    dzdx1: np.ndarray  # (6, ny, nx, s^2)
    dzdx2: np.ndarray


class ShallowWaterRHS:
    """The SW RHS at one discretization, dtype and device (the card unless
    the caller asks for the CPU; a CUDA request without a card raises).

    With ``perturbation_base`` (a balanced state q0, usually the initial
    condition) the RHS runs in perturbation form around it; its base planes
    (q0, hu0/h0, q0's face traces and halo, the float64 base RHS) are built
    once in float64 on the same device and cast to ``dtype``.

    With ``topo`` (a ``Topography``) both forms carry the bottom
    topography: its device planes (``ops.sw_operator.SWTopography``) are
    built once in float64 and cast to ``dtype``; in perturbation form the
    base is built with the float64 planes."""

    def __init__(self, geom, ops, metric, dtype=torch.float64, device="cuda", topology=None,
                 perturbation_base=None, topo=None):
        self.dtype = dtype
        self.device = resolve_device(device)
        self.topology = topology if topology is not None else CubedSphereTopology(geom)
        self.con = build_constants(ops, metric, geom.num_elements, dtype=dtype, device=self.device)
        # The halo's device tables are made here, not inside a step.
        if self.device.type == "cuda":
            halo_tables(self.topology, self.con.device, dtype)
        self.topo = None
        if topo is not None:
            self.topo = build_topography(topo, metric, dtype=dtype, device=self.device)
        self.base = None
        if perturbation_base is not None:
            con64 = build_constants(ops, metric, geom.num_elements, dtype=torch.float64, device=self.device)
            q64 = torch.as_tensor(np.asarray(perturbation_base), dtype=torch.float64, device=self.device)
            state = (3, 6, self.con.nel, self.con.nel, self.con.s**2)
            if tuple(q64.shape) != state:
                raise ValueError(f"perturbation_base has shape {tuple(q64.shape)}, not {state}")
            topo64 = None
            if topo is not None:
                topo64 = (self.topo if dtype == torch.float64 else
                          build_topography(topo, metric, dtype=torch.float64, device=self.device))
            self.base = build_base_planes(q64, con64, self.topology, dtype, topo=topo64)
        if run_supported(self.con.s, self.con.nel):
            self.packed_run = self._packed_run

    @property
    def base_state(self) -> Optional[torch.Tensor]:
        """The perturbation base q0 in the working dtype (None in absolute form)."""
        return self.base.q0 if self.base is not None else None

    def traces(self, q: torch.Tensor) -> None:
        """The chain's bootstrap: none, since every stage takes its halo
        from its input state (no launch)."""
        return None

    def __call__(self, q: torch.Tensor) -> torch.Tensor:
        if self.base is not None:
            return self.delta(self.pack(q))
        return self.xla(q)

    def delta(self, qprime: torch.Tensor) -> torch.Tensor:
        """RHS(q0 + qprime), the perturbation passed as it is (full
        working-dtype resolution, no absolute-state quantization)."""
        if self.base is None:
            raise ValueError("delta needs a perturbation_base")
        return sw_operator(qprime, None, self.con, base=self.base, topology=self.topology, topo=self.topo)

    def xla(self, q: torch.Tensor) -> torch.Tensor:
        """The absolute-form operator of this dtype on the absolute state
        (what the JAX package's ``rhs_pert.xla`` is)."""
        return sw_operator(q, None, self.con, topology=self.topology, topo=self.topo)

    def jtv_prep(self, q: torch.Tensor) -> torch.Tensor:
        """The linearisation of ``jtv_apply`` at the absolute state q, in this
        RHS's dtype: on a GPU the coefficient buffer of one launch of the
        tangent prep kernel (``ops.sw_operator.sw_tangent_prep``), once per
        linearisation point; on the CPU q itself (no launch)."""
        q = q.to(self.dtype).contiguous()
        if q.device.type == "cpu":
            return q
        return sw_tangent_prep(q, self.con, self.topology, self.topo)

    def jtv_apply(self, prep: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """J(q).v of the ABSOLUTE operator of this RHS's dtype for the
        ``prep`` of the absolute state q (``jtv_prep(q)``): one launch of the
        linear tangent apply kernel on a GPU (``ops.sw_operator.
        sw_tangent_apply``); on the CPU ``torch.func.jvp`` of the plain
        operator (``sw_tangent``, which runs ``sw_tangent_plain`` for a CPU
        tensor: the CPU integrators' tests sit near their bounds and move
        with J.v's rounding, so the CPU keeps the function's own derivative;
        the split's plain versions are held in
        tests/test_torch_sw_tangent_split.py). In perturbation form too this
        is the absolute operator's action, the JAX package's rule for its SW
        companion (``jax.jvp`` of ``rhs32.xla``, integrators/epi.py:197-200
        there), not the tangent of the perturbation form."""
        v = v.to(self.dtype).contiguous()
        if v.device.type == "cpu":
            return sw_tangent(prep, v, self.con, self.topology, self.topo)
        return sw_tangent_apply(prep, v, self.con, self.topology, self.topo)

    def jtv(self, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """J(q).v: ``jtv_apply(jtv_prep(q), v)``."""
        return self.jtv_apply(self.jtv_prep(q), v)

    def stage(self, x, y, a: float, b: float, cdt: float, traces: Optional[torch.Tensor] = None):
        """One fused RK stage ``a*x + b*y + cdt*RHS(y)`` on packed states
        (``x`` unused when ``a == 0``), one launch on a GPU; ``traces`` is
        ignored (the halo comes from ``y``). Returns (output, None)."""
        return sw_operator(y, None, self.con, x=x, a=a, b=b, cdt=cdt, base=self.base,
                           topology=self.topology, topo=self.topo), None

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
        of the whole-run kernel on a GPU, the plain stages on the CPU; with
        topography it raises (the whole-run kernel has no topography)."""
        if self.topo is not None:
            raise NotImplementedError(_NO_PACKED_TOPO)
        return sw_run(qp, nsteps, abc, self.con, self.topology, base=self.base)


def make_rhs_shallow_water(geom, ops, metric, dtype=torch.float64, device="cuda",
                           topo=None, topology=None, perturbation_base=None) -> ShallowWaterRHS:
    """Build the shallow-water RHS: the absolute form or, with
    ``perturbation_base``, the perturbation form, either with ``topo`` (a
    ``Topography``) carrying its bottom topography."""
    return ShallowWaterRHS(geom, ops, metric, dtype=dtype, device=device, topology=topology,
                           perturbation_base=perturbation_base, topo=topo)
