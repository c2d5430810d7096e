"""The tile-parallel TVD-RK3 step of the 3D Euler model.

Counterpart of ``wxfactory_tpu/parallel/shard_map_euler3d_fused.py``
(:122-469): each of the 6N^2 tiles of a ``TileMesh`` (columns of nt x nt
elements; the vertical stays tile-local, as in the reference) runs the
whole spatial operator with the RK stage combination and its four edges'
trace emission in one launch of the tile kernel
(``ops.euler3d_operator.euler3d_tile_operator``, the port of
``pallas_euler3d.km3_tile``); the halo exchange between stages is
``parallel/exchange.py``. In the perturbation form (the float32 operating
point) every tile expands around its slice of the global float64 base
(``ops.euler3d_operator.tile_pert_base``); callers still pass and receive
the absolute state.
"""

from typing import Optional

import numpy as np
import torch

from ..common.device import resolve_device
from ..ops.euler3d_operator import (
    build_constants,
    build_pert_base,
    euler3d_tile_operator,
    has_topography,
    tile_constants,
    tile_edge_traces,
    tile_pert_base,
)
from .exchange import TileExchange
from .mesh import TileMesh
from .shard_map_sw import build_tile_tables
from .tile_step import TileStep
from .topology import CubedSphereTopology


def make_shard_map_euler3d_step_fused(geom, ops, metric, mesh: TileMesh, dt: float, dtype=torch.float32,
                                      perturbation_base: Optional[np.ndarray] = None, device="cuda",
                                      topology=None) -> TileStep:
    """The TVD-RK3 step of ``dt`` over ``mesh``'s tiles on the global state
    layout (5, 6, nk, nel_h, nel_h, s^3) (N = mesh.n must divide nel_h).
    With ``perturbation_base`` (the global state q0) the tiles run the
    perturbation form around it. The JAX factory returns (step, sharding);
    a ``TileStep`` is both the step and its tiles' placement."""
    device = resolve_device(device)
    n, s, nel_h, nk = mesh.n, ops.num_solpts, geom.nel_h, geom.nel_v
    if nel_h % n:
        raise ValueError(f"nel_h={nel_h} not divisible by mesh N={n}")
    nt = nel_h // n
    topology = topology if topology is not None else CubedSphereTopology(geom)
    panel_metric = has_topography(geom)  # each tile then takes its own panel's metric
    con = build_constants(ops, metric, nel_h, nk, dtype=dtype, device=device, panel_metric=panel_metric)
    tiles = mesh.tiles()
    owned = [tiles[t] for t in mesh.owned()]
    cons = [tile_constants(con, ty * nt, tx * nt, nt, p) for p, ty, tx in owned]
    del con
    perts = [None] * len(owned)
    if perturbation_base is not None:
        con64 = build_constants(ops, metric, nel_h, nk, dtype=torch.float64, device=device,
                                panel_metric=panel_metric)
        q64 = torch.as_tensor(np.asarray(perturbation_base), dtype=torch.float64, device=device)
        base64 = build_pert_base(q64, con64, topology, torch.float64)
        perts = [tile_pert_base(base64, ty * nt, tx * nt, nt, p, dtype) for p, ty, tx in owned]
        del con64, base64
    exchange = TileExchange(build_tile_tables(topology, n, s), mesh, (5, 4, 1, nk, nt, s * s), (nk, nt, s, s),
                            device=device, dtype=dtype)

    def operator(i, y, halo, x, a, b, cdt):
        return euler3d_tile_operator(y, halo, cons[i], x=x, a=a, b=b, cdt=cdt, emit_traces=True, pert=perts[i])

    def pack(i, qt):
        if perts[i] is None:
            return qt.to(dtype).contiguous()
        return (qt - perts[i].q0.to(qt.dtype)).to(dtype).contiguous()

    def unpack(i, y):
        return y if perts[i] is None else perts[i].q0 + y

    return TileStep(mesh, nt, dt, operator, lambda i, y: tile_edge_traces(y, cons[i], perts[i]), pack, unpack,
                    exchange)
