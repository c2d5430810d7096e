"""The TVD-RK3 chain of a tile-parallel run, shared by both models.

The body of the JAX package's tile step (``shard_map_sw_fused.py:300-341``,
``shard_map_euler3d_fused.py:430-448``) without ``shard_map``: a step takes
the global-layout state, runs three stages, each one halo exchange and one
launch of the tile kernel per owned tile (which also emits the tile's edge
traces for the next exchange), and returns the global-layout state. As the
explicit integrators do (``integrators/explicit.py``), the packed tiles and
their traces ride along in a one-entry cache keyed on the identity of the
last returned state, so a run slices and bootstraps once, at its first
step. In a run over several ranks a step writes the tiles this rank owns
into a copy of its input; the other tiles keep the input's values.
"""

from typing import Callable, List

import torch

from .mesh import TileMesh, tile_view

# (a, b, c) per stage: y_out = a*x + b*y + c*dt*RHS(y) (integrators.Tvdrk3)
TVDRK3 = ((0.0, 1.0, 1.0), (0.75, 0.25, 0.25), (1.0 / 3.0, 2.0 / 3.0, 2.0 / 3.0))


class TileStep:
    """One TVD-RK3 step of ``dt`` over the owned tiles of ``mesh``.

    ``operator(i, y, halo, x, a, b, cdt)`` runs tile i's stage and returns
    (output, its edge traces); ``edges(i, y)`` bootstraps tile i's traces;
    ``pack(i, q_tile)`` / ``unpack(i, y)`` convert a tile of the global
    state to the chained state and back (the perturbation around the base
    in perturbation form); ``exchange`` turns every owned tile's traces
    into its halos."""

    def __init__(self, mesh: TileMesh, nt: int, dt: float, operator: Callable, edges: Callable, pack: Callable,
                 unpack: Callable, exchange: Callable):
        self.mesh, self.nt, self.dt = mesh, nt, float(dt)
        self._operator, self._edges, self._pack, self._unpack = operator, edges, pack, unpack
        self.exchange = exchange
        tiles = mesh.tiles()
        self.positions = [tiles[t] for t in mesh.owned()]
        self._cache = None  # (returned state, its packed tiles, their traces)

    def tiles_of(self, q: torch.Tensor) -> List[torch.Tensor]:
        """The owned tiles of a global-layout state, packed."""
        return [self._pack(i, tile_view(q, *pos, self.nt).contiguous()) for i, pos in enumerate(self.positions)]

    def __call__(self, q: torch.Tensor) -> torch.Tensor:
        if self._cache is not None and self._cache[0] is q:
            ys, traces = self._cache[1], self._cache[2]
        else:
            ys = self.tiles_of(q)
            traces = [self._edges(i, y) for i, y in enumerate(ys)]
        x = ys
        for a, b, c in TVDRK3:
            halos = self.exchange(traces)
            stage = [self._operator(i, y, halos[i], x[i], a, b, c * self.dt) for i, y in enumerate(ys)]
            ys, traces = [o[0] for o in stage], [o[1] for o in stage]
        out = torch.empty_like(q) if self.mesh.owns_all else q.clone()
        for i, pos in enumerate(self.positions):
            tile_view(out, *pos, self.nt).copy_(self._unpack(i, ys[i]))
        self._cache = (out, ys, traces)
        return out
