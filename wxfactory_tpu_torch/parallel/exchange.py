"""Halo exchange between the tiles of a tile-parallel run.

Counterpart of the eight ``lax.ppermute`` rounds of the JAX package's tile
step (``shard_map_euler3d_fused.py:397-426``, ``shard_map_sw_fused.py``
``halos_of``): every tile emits the traces of its four edges; each tile's
halo on side d is the trace of side ``nb_side`` of tile ``nb_tile``
(``shard_map_sw.build_tile_tables``), reversed along the edge where the
edge runs opposite, with the momenta rotated into the tile's contravariant
basis (the identity inside a panel, where the halo is therefore the
neighbour's trace bit for bit).

Traces of tiles this rank owns move by one gather on the device. Traces of
tiles another rank owns travel by ``torch.distributed.batch_isend_irecv``,
one message each way per neighbouring rank and stage: device tensors under
NCCL, host tensors under gloo (which takes no CUDA tensor), staged
explicitly through host memory. The relation is an involution: side d of
tile t feeds side e of tile u exactly when side e of u feeds side d of t,
so every rank knows what to send from what it must receive.
"""

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .distributed import halo_staged
from .mesh import TileMesh
from .shard_map_sw import TileTables


class TileExchange:
    """The halo exchange of one rank's tiles for traces of the shape
    ``trace_shape`` = (nvar, 4, 1, ...) in (S, N, W, E) order, whose one
    side's values have the structure ``side_shape`` = (a, nt, b, s): (1, nt,
    1, s) for shallow water (traces (3, 4, 1, nt, s), edge point e*s + k),
    (nk, nt, s, s) for 3D Euler (traces (5, 4, 1, nk, nt, s^2): vertical
    element, element along the edge, vertical face point, point along the
    edge). Rows 1 and 2 (the horizontal momenta) are rotated.

    ``__call__`` takes the owned tiles' traces and returns their halos, each
    a contiguous view of ``trace_shape``."""

    def __init__(self, tables: TileTables, mesh: TileMesh, trace_shape: Sequence[int], side_shape: Sequence[int],
                 device="cpu", dtype=torch.float64):
        a, nt, b, s = side_shape
        nvar = trace_shape[0]
        if nt != tables.nt or s != tables.s or mesh.n != tables.n:
            raise ValueError(f"side shape {tuple(side_shape)} does not fit tables with n={tables.n}, "
                             f"nt={tables.nt}, s={tables.s}")
        self.mesh, self.trace_shape = mesh, tuple(trace_shape)
        self.device = torch.device(device)
        self.staged = halo_staged(self.device) and not mesh.owns_all
        owned = mesh.owned()
        local = {t: i for i, t in enumerate(owned)}
        nl, r = len(owned), int(np.prod(side_shape))
        v_r = nvar * r
        # Messages between ranks, in the receiver's (tile, side) order.
        sends: Dict[int, list] = {}
        recvs: Dict[int, list] = {}
        for t in owned:
            for d in range(4):
                u, e = int(tables.nb_tile[t, d]), int(tables.nb_side[t, d])
                if u not in local:
                    peer = mesh.owner(u)
                    sends.setdefault(peer, []).append(((u, e), (local[t], d)))
                    recvs.setdefault(peer, []).append(((t, d), (u, e)))
        self.peers = sorted(sends)
        self._send_rows = {
            peer: tuple(torch.as_tensor([row[k] for _, row in sorted(sends[peer])], device=self.device)
                        for k in range(2))
            for peer in self.peers
        }
        self._recv_counts = {peer: len(recvs[peer]) for peer in self.peers}
        # Where every received (t, d) lands in the pool that follows the
        # local traces: (nl, nvar, 4, r) values, then each peer's (k, nvar, r).
        offset, recv_at = nl * 4 * v_r, {}
        for peer in self.peers:
            for k, ((t, d), _) in enumerate(sorted(recvs[peer])):
                recv_at[(t, d)] = offset + k * v_r
            offset += self._recv_counts[peer] * v_r

        # Point permutation of a side's values: identity, or reversed along
        # the edge (element along and point along; the vertical kept).
        ar = np.arange(r).reshape(side_shape)
        perm = {False: ar.reshape(-1), True: ar[:, ::-1, :, ::-1].reshape(-1)}
        index = np.empty((nl, nvar, 4, r), np.int64)
        coef = np.empty((4, nl, 4, r))
        for li, t in enumerate(owned):
            for d in range(4):
                u, e = int(tables.nb_tile[t, d]), int(tables.nb_side[t, d])
                pts = perm[bool(tables.flip[t, d])]
                for v in range(nvar):
                    if u in local:
                        index[li, v, d] = ((local[u] * nvar + v) * 4 + e) * r + pts
                    else:
                        index[li, v, d] = recv_at[(t, d)] + v * r + pts
                # The rotation at edge point (element along, point along).
                conv = tables.conv[t, d].reshape(nt, s, 2, 2)
                full = np.broadcast_to(conv[None, :, None], (a, nt, b, s, 2, 2)).reshape(r, 2, 2)
                coef[:, li, d] = [full[:, i, j] for i in (0, 1) for j in (0, 1)]
        self._index = torch.as_tensor(index.reshape(-1), device=self.device)
        self._coef = tuple(torch.as_tensor(c, dtype=dtype, device=self.device) for c in coef)
        self._out_shape = (nl, nvar, 4, r)

    def __call__(self, traces: List[torch.Tensor]) -> List[torch.Tensor]:
        nl, nvar, _, r = self._out_shape
        pool = [torch.stack(traces).reshape(-1)]
        if self.peers:
            pool += self._trade(pool[0].view(nl, nvar, 4, r))
        flat = pool[0] if len(pool) == 1 else torch.cat(pool)
        out = torch.index_select(flat, 0, self._index).view(nl, nvar, 4, r)
        c11, c12, c21, c22 = self._coef
        a1, a2 = out[:, 1], out[:, 2]
        b1, b2 = c11 * a1 + c12 * a2, c21 * a1 + c22 * a2
        out[:, 1], out[:, 2] = b1, b2
        return [out[li].view(self.trace_shape) for li in range(nl)]

    def _trade(self, local: torch.Tensor) -> List[torch.Tensor]:
        """Send the traces other ranks' tiles read and receive the ones this
        rank's tiles read, one message each way per neighbouring rank;
        returns the received values, flat, in peer order."""
        nvar, r = self._out_shape[1], self._out_shape[3]
        host = torch.device("cpu") if self.staged else self.device
        ops, received = [], []
        for peer in self.peers:
            tiles, sides = self._send_rows[peer]
            out = local[tiles, :, sides].contiguous()  # (k, nvar, r)
            if self.staged:
                out = out.cpu()
            buf = torch.empty((self._recv_counts[peer], nvar, r), dtype=local.dtype, device=host)
            ops += [dist.P2POp(dist.isend, out, peer), dist.P2POp(dist.irecv, buf, peer)]
            received.append(buf)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [buf.to(self.device).reshape(-1) for buf in received]
