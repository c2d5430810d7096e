"""The neighbour tables of the cubed sphere's 6N^2 tiles.

Counterpart of ``_build_tile_tables`` in ``wxfactory_tpu/parallel/
shard_map_sw.py`` (:327-407): for every tile and side, which tile's which
side feeds its halo, whether that edge runs opposite, and the 2x2
contravariant rotation of the momenta sliced to the tile's segment of the
edge. The JAX package realises the relation as eight ``lax.ppermute``
rounds (four cyclic shifts inside the panels, four colour classes of panel
edges) with one-hot route tables; the port sends to each neighbour directly
(``parallel/exchange.py``) and needs only the relation itself.
"""

from dataclasses import dataclass

import numpy as np

from .mesh import tile_index
from .topology import EAST, NORTH, SOUTH, WEST

# The side of the neighbour that faces each side inside a panel, and the
# tile step toward it.
OPPOSITE = {SOUTH: NORTH, NORTH: SOUTH, WEST: EAST, EAST: WEST}
_STEP = {SOUTH: (-1, 0), NORTH: (1, 0), WEST: (0, -1), EAST: (0, 1)}


@dataclass(frozen=True)
class TileTables:
    """The halo relation of a (6, n, n) tile mesh, sides in (S, N, W, E)
    order and tiles in flat ``tile_index`` order: side d of tile t reads
    side ``nb_side[t, d]`` of tile ``nb_tile[t, d]``, reversed along the
    edge where ``flip[t, d]``, its momenta rotated by ``conv[t, d]`` (the
    identity inside a panel)."""

    n: int
    nt: int  # elements along a tile side
    s: int
    nb_tile: np.ndarray  # (6n^2, 4) int
    nb_side: np.ndarray  # (6n^2, 4) int
    flip: np.ndarray  # (6n^2, 4) bool
    conv: np.ndarray  # (6n^2, 4, nt*s, 2, 2)


def _edge_tiles(p: int, d: int, n: int):
    """The tiles along side d of panel p, in the edge's own order."""
    if d == SOUTH:
        return [(p, 0, tx) for tx in range(n)]
    if d == NORTH:
        return [(p, n - 1, tx) for tx in range(n)]
    if d == WEST:
        return [(p, ty, 0) for ty in range(n)]
    return [(p, ty, n - 1) for ty in range(n)]


def build_tile_tables(topology, n: int, s: int) -> TileTables:
    """The halo relation of the (6, n, n) tiles of ``topology``'s sphere
    (n must divide its nel)."""
    nel = topology.nel_h
    if nel % n:
        raise ValueError(f"nel={nel} is not divisible by N={n}")
    nt = nel // n
    npts_t = nt * s
    ntile = 6 * n * n
    nb_tile = np.zeros((ntile, 4), np.int64)
    nb_side = np.zeros((ntile, 4), np.int64)
    flip = np.zeros((ntile, 4), bool)
    conv = np.zeros((ntile, 4, npts_t, 2, 2))
    conv[..., 0, 0] = conv[..., 1, 1] = 1.0
    for p in range(6):
        for ty in range(n):
            for tx in range(n):
                t = tile_index(p, ty, tx, n)
                for d in range(4):
                    dy, dx = _STEP[d]
                    if 0 <= ty + dy < n and 0 <= tx + dx < n:
                        nb_tile[t, d] = tile_index(p, ty + dy, tx + dx, n)
                        nb_side[t, d] = OPPOSITE[d]
                        continue
                    edge = topology.edges[p][d]
                    i = tx if d in (SOUTH, NORTH) else ty  # our place along the panel edge
                    j = n - 1 - i if edge.flip else i
                    nb_tile[t, d] = tile_index(*_edge_tiles(edge.neighbor, edge.neighbor_side, n)[j], n)
                    nb_side[t, d] = edge.neighbor_side
                    flip[t, d] = edge.flip
                    conv[t, d] = edge.conv_contra[i * npts_t : (i + 1) * npts_t]
    return TileTables(n=n, nt=nt, s=s, nb_tile=nb_tile, nb_side=nb_side, flip=flip, conv=conv)
