"""The tile-parallel TVD-RK3 step of the shallow-water model.

Counterpart of ``wxfactory_tpu/parallel/shard_map_sw_fused.py``
(:100-359): each of the 6N^2 tiles of a ``TileMesh`` (one per rank in a run
over 6N^2 ranks, all of them in one process) runs the whole spatial operator
with the RK stage combination and its edge-trace emission in one launch of
the tile kernel (``ops.sw_operator.sw_tile_operator``, the port of
``pallas_sw_gen.km_tile``), and the halo exchange between stages is
``parallel/exchange.py``. In the perturbation form every tile expands
around its slice of the global float64 base (``ops.sw_operator.tile_base``);
callers still pass and receive the absolute state.
"""

from typing import Optional

import numpy as np
import torch

from ..common.device import resolve_device
from ..ops.sw_operator import (
    build_base_planes,
    build_constants,
    sw_tile_operator,
    tile_base,
    tile_constants,
    tile_edge_traces,
)
from .exchange import TileExchange
from .mesh import TileMesh
from .shard_map_sw import build_tile_tables
from .tile_step import TileStep
from .topology import CubedSphereTopology


def make_shard_map_sw_step_fused(geom, ops, metric, mesh: TileMesh, dt: float, dtype=torch.float32,
                                 perturbation_base: Optional[np.ndarray] = None, device="cuda",
                                 topology=None) -> TileStep:
    """The TVD-RK3 step of ``dt`` over ``mesh``'s tiles on the global state
    layout (3, 6, nel, nel, s^2) (N = mesh.n must divide nel). With
    ``perturbation_base`` (the global state q0) the tiles run the
    perturbation form around it. The JAX factory returns (step, sharding);
    a ``TileStep`` is both the step and its tiles' placement."""
    device = resolve_device(device)
    n, s, nel = mesh.n, ops.num_solpts, geom.num_elements
    if nel % n:
        raise ValueError(f"nel={nel} not divisible by mesh N={n}")
    nt = nel // n
    topology = topology if topology is not None else CubedSphereTopology(geom)
    con = build_constants(ops, metric, nel, dtype=dtype, device=device)
    tiles = mesh.tiles()
    owned = [tiles[t] for t in mesh.owned()]
    cons = [tile_constants(con, ty * nt, tx * nt, nt, p) for p, ty, tx in owned]
    bases = [None] * len(owned)
    if perturbation_base is not None:
        con64 = build_constants(ops, metric, nel, dtype=torch.float64, device=device)
        q64 = torch.as_tensor(np.asarray(perturbation_base), dtype=torch.float64, device=device)
        base64 = build_base_planes(q64, con64, topology, torch.float64)
        bases = [tile_base(base64, ty * nt, tx * nt, nt, p, dtype) for p, ty, tx in owned]
    exchange = TileExchange(build_tile_tables(topology, n, s), mesh, (3, 4, 1, nt, s), (1, nt, 1, s), device=device,
                            dtype=dtype)

    def operator(i, y, halo, x, a, b, cdt):
        return sw_tile_operator(y, halo, cons[i], x=x, a=a, b=b, cdt=cdt, emit_traces=True, base=bases[i])

    def pack(i, qt):
        if bases[i] is None:
            return qt.to(dtype).contiguous()
        return (qt - bases[i].q0.to(qt.dtype)).to(dtype).contiguous()

    def unpack(i, y):
        return y if bases[i] is None else bases[i].q0 + y

    return TileStep(mesh, nt, dt, operator, lambda i, y: tile_edge_traces(y, cons[i]), pack, unpack, exchange)
