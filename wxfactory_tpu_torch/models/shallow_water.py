"""Shallow-water equations on the rotated cubed sphere (DFR discretization).

Counterpart of ``wxfactory_tpu/models/shallow_water.py`` (absolute form):
the state is ``Q[3, 6, ny, nx, s^2]`` (h, h*u1, h*u2) and the whole spatial
operator is ``ops.sw_operator`` — the hand-written CUDA kernel on a GPU, its
plain torch version on the CPU — composed with the torch halo glue.

The returned object is the RHS ``q -> dq/dt`` and also exposes the fused
stage API the explicit integrators chain: ``stage(x, y, a, b, cdt, traces)``
returns ``a*x + b*y + cdt*RHS(y)`` and the output's panel-edge traces, so
the next stage's halo needs no separate pass (one operator launch per RK
stage). ``traces(q)`` bootstraps the chain. ``pack``/``unpack`` are the
identity: the kernel works in the model layout.
"""

from typing import Optional

import torch

from ..ops.sw_operator import build_constants, edge_traces, halo_from_traces, sw_operator
from ..parallel.topology import CubedSphereTopology


class ShallowWaterRHS:
    """The SW RHS at one discretization, dtype and device."""

    def __init__(self, geom, ops, metric, dtype=torch.float64, device="cpu", topology=None):
        self.dtype = dtype
        self.device = torch.device(device)
        self.topology = topology if topology is not None else CubedSphereTopology(geom)
        self.con = build_constants(ops, metric, geom.num_elements, dtype=dtype, device=self.device)

    def traces(self, q: torch.Tensor) -> torch.Tensor:
        """Panel-edge traces of ``q`` (3, 4, 6, nel, s): the chain's bootstrap."""
        return edge_traces(q, self.con)

    def halo(self, traces: torch.Tensor) -> torch.Tensor:
        return halo_from_traces(traces, self.topology)

    def __call__(self, q: torch.Tensor) -> torch.Tensor:
        return sw_operator(q, self.halo(self.traces(q)), self.con)

    def stage(self, x, y, a: float, b: float, cdt: float, traces: Optional[torch.Tensor] = None):
        """One fused RK stage ``a*x + b*y + cdt*RHS(y)`` (``x`` unused when
        ``a == 0``); ``traces`` are y's panel-edge traces (bootstrapped when
        None). Returns (output, output traces)."""
        if traces is None:
            traces = self.traces(y)
        return sw_operator(y, self.halo(traces), self.con, x=x, a=a, b=b, cdt=cdt, emit_traces=True)

    @staticmethod
    def pack(q: torch.Tensor) -> torch.Tensor:
        return q

    @staticmethod
    def unpack(q: torch.Tensor) -> torch.Tensor:
        return q


def make_rhs_shallow_water(geom, ops, metric, dtype=torch.float64, device="cpu",
                           topo=None, topology=None) -> ShallowWaterRHS:
    """Build the shallow-water RHS (absolute form, no topography).

    ``topo`` (bottom topography) and the perturbation form of the JAX
    package wait for ROADMAP queue 1, item 4; a topography case raises
    instead of running without its source terms."""
    if topo is not None:
        raise NotImplementedError(
            "shallow water with topography is not ported yet (ROADMAP queue 1, item 4)"
        )
    return ShallowWaterRHS(geom, ops, metric, dtype=dtype, device=device, topology=topology)
