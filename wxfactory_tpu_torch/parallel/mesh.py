"""The tile mesh of the cubed sphere and the integrator over its tile step.

Counterpart of ``wxfactory_tpu/parallel/mesh.py``: the reference runs one
MPI rank per cubed-sphere tile (``mpirun -n 6N^2``), the JAX package one
device per tile of a ('panel', 'y', 'x') = (6, N, N) mesh. Here a
``TileMesh(n)`` names the 6N^2 tiles and says which of them a process owns:
all of them in a single process (the analogue of the JAX tests' virtual
24-device mesh, used by the tests and on one card), one each when the world
has 6N^2 ranks, any equal share when the world size divides 6N^2.
"""

import math
from dataclasses import dataclass
from typing import List, Tuple

from ..integrators.base import Integrator, SolverInfo


def tile_index(p: int, ty: int, tx: int, n: int) -> int:
    """Flat index of tile (panel, ty, tx) of a (6, n, n) mesh
    (``shard_map_sw._tile_index`` of the JAX package)."""
    return (p * n + ty) * n + tx


@dataclass(frozen=True)
class TileMesh:
    """The (6, n, n) tiles and this process's share of them: rank ``rank``
    of ``world`` owns the contiguous block of 6n^2 / world tiles starting
    at ``rank * 6n^2 / world``."""

    n: int
    rank: int = 0
    world: int = 1

    def __post_init__(self):
        if self.n < 1 or (6 * self.n * self.n) % self.world or not 0 <= self.rank < self.world:
            raise ValueError(f"TileMesh(n={self.n}, rank={self.rank}, world={self.world}): the world size must "
                             f"divide the {6 * self.n * self.n} tiles")

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (6, self.n, self.n)

    @property
    def ntiles(self) -> int:
        return 6 * self.n * self.n

    @property
    def per_rank(self) -> int:
        return self.ntiles // self.world

    def tiles(self) -> List[Tuple[int, int, int]]:
        """Every tile (panel, ty, tx) in flat-index order."""
        n = self.n
        return [(p, ty, tx) for p in range(6) for ty in range(n) for tx in range(n)]

    def owner(self, t: int) -> int:
        """The rank that owns flat tile ``t``."""
        return t // self.per_rank

    def owned(self) -> List[int]:
        """Flat indices of this rank's tiles."""
        return list(range(self.rank * self.per_rank, (self.rank + 1) * self.per_rank))

    @property
    def owns_all(self) -> bool:
        return self.world == 1


def is_tile_mesh(mesh) -> bool:
    """True for a mesh whose shape is (6, N, N): the tile step's."""
    shape = tuple(mesh.shape)
    return len(shape) == 3 and shape[0] == 6 and shape[1] == shape[2]


def tile_view(q, p: int, ty: int, tx: int, nt: int):
    """Tile (p, ty, tx) of a global state (nvar, 6, [nk,] nel, nel, nodes)
    as a view in the tile layout (nvar, 1, [nk,] nt, nt, nodes)."""
    index = (slice(None), slice(p, p + 1)) + (slice(None),) * (q.ndim - 5)
    return q[index + (slice(ty * nt, (ty + 1) * nt), slice(tx * nt, (tx + 1) * nt))]


def tile_n_for_world(world: int):
    """N with 6 N^2 == world, or None."""
    root = math.isqrt(world // 6) if world >= 6 else 0
    return root if root and 6 * root * root == world else None


class ShardMapTvdrk3(Integrator):
    """TVD-RK3 through the tile step (one launch of the tile kernel per
    owned tile and stage, halos exchanged between stages). ``maker(dt)``
    builds the step for one dt; steps are cached per distinct dt (the
    t_end-clamped final step is the only second value a run produces), as
    ``wxfactory_tpu/parallel/mesh.py:101-118`` does."""

    def __init__(self, maker, **kwargs) -> None:
        super().__init__(**kwargs)
        self._maker = maker
        self._steps = {}

    def __step__(self, q, dt: float):
        self.solver_info = SolverInfo(total_num_it=1)
        key = float(dt)
        if key not in self._steps:
            self._steps[key] = self._maker(key)
        return self._steps[key](q)
