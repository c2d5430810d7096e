"""Cubed-sphere panel topology and panel-edge halo exchange (torch).

Counterpart of ``wxfactory_tpu/parallel/topology.py``. The static tables —
panel adjacency, edge flips and the exact 2x2 vector-conversion matrices
``J_local @ J_neighbor^-1`` — are derived at setup in float64 numpy exactly
as there (same code). The exchange itself is one torch index gather over the
stacked (side, panel) trace pool, with the edge flips folded into the index
table, followed by the 2x2 contravariant rotation of vector components.

The state is global, ``(nvar, 6, ny, nx, ...)``; there are no ranks.
"""

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..geometry.cubed_sphere import gnomonic_to_cartesian, wind_jacobian

SOUTH, NORTH, WEST, EAST = 0, 1, 2, 3
_SIDE_NAMES = ("south", "north", "west", "east")


def _edge_gnomonic(geom, side: int) -> Tuple[np.ndarray, np.ndarray]:
    """Panel-local gnomonic (X, Y) of the boundary solution points along the
    given panel side, ordered along the local edge coordinate."""
    along = np.tan(geom.x1)  # (nel * s,)
    ones = np.ones_like(along)
    if side == SOUTH:
        return along, -ones
    if side == NORTH:
        return along, ones
    if side == WEST:
        return -ones, along
    return ones, along


def _edge_xyz(geom, panel: int, side: int) -> np.ndarray:
    """Physical unit-sphere coordinates (npts, 3) of a panel edge's boundary
    solution points, in local edge ordering."""
    X, Y = _edge_gnomonic(geom, side)
    x, y, z = gnomonic_to_cartesian(X, Y, geom.lon_p[panel], geom.lat_p[panel], geom.angle_p[panel])
    return np.stack([x, y, z], axis=-1)


def _edge_mid_xyz(geom, panel: int, side: int) -> np.ndarray:
    """Physical coordinates of the continuous midpoint of a panel edge."""
    mids = {SOUTH: (0.0, -1.0), NORTH: (0.0, 1.0), WEST: (-1.0, 0.0), EAST: (1.0, 0.0)}
    X, Y = mids[side]
    x, y, z = gnomonic_to_cartesian(
        np.array(X), np.array(Y), geom.lon_p[panel], geom.lat_p[panel], geom.angle_p[panel]
    )
    return np.stack([x, y, z], axis=-1)


def _scaled_jacobian(X, Y, lat_p, angle_p, dx1, dx2) -> np.ndarray:
    """(npts, 2, 2) Jacobian mapping (lambda_dot, phi_dot) to reference-element
    contravariant components (u1, u2) at the given gnomonic points."""
    dx1dlon, dx1dlat, dx2dlon, dx2dlat = wind_jacobian(X, Y, lat_p, angle_p)
    row1 = np.stack([dx1dlon * 2.0 / dx1, dx1dlat * 2.0 / dx1], axis=-1)
    row2 = np.stack([dx2dlon * 2.0 / dx2, dx2dlat * 2.0 / dx2], axis=-1)
    return np.stack([row1, row2], axis=-2)


@dataclass(frozen=True)
class PanelEdge:
    """One side of one panel: who is on the other side and how their data
    maps into our coordinates."""

    neighbor: int  # neighbor panel index
    neighbor_side: int  # the neighbor's side that faces us
    flip: bool  # neighbor's edge coordinate runs opposite to ours
    conv_contra: np.ndarray  # (npts, 2, 2): neighbor contravariant -> local
    conv_cov: np.ndarray  # (npts, 2, 2): neighbor covariant -> local


class CubedSphereTopology:
    """Static panel-edge tables (numpy) + the torch halo-exchange functions.

    Device copies of the tables are built on first use per (device, dtype)
    and kept on the object."""

    def __init__(self, geom):
        """geom: CubedSphere2D or CubedSphere3D (only the horizontal panel
        structure — x1, panel rotations, delta_x — is used)."""
        self.geom = geom
        self.nel_h = getattr(geom, "num_elements", None) or geom.nel_h
        self.num_points = self.nel_h * geom.num_solpts

        # --- Derive adjacency from edge-midpoint coincidence.
        mids = np.array([[_edge_mid_xyz(geom, p, d) for d in range(4)] for p in range(6)])
        self.edges: List[List[PanelEdge]] = []
        for p in range(6):
            row = []
            for d in range(4):
                matches = [
                    (q, e)
                    for q in range(6)
                    for e in range(4)
                    if (q, e) != (p, d) and np.allclose(mids[p, d], mids[q, e], atol=1e-12)
                ]
                if len(matches) != 1:
                    raise RuntimeError(f"Panel {p} side {_SIDE_NAMES[d]}: ambiguous neighbors {matches}")
                q, e = matches[0]

                # --- Derive flip by comparing physical edge-point orderings.
                my_xyz = _edge_xyz(geom, p, d)
                nb_xyz = _edge_xyz(geom, q, e)
                if np.allclose(my_xyz, nb_xyz, atol=1e-10):
                    flip = False
                elif np.allclose(my_xyz, nb_xyz[::-1], atol=1e-10):
                    flip = True
                else:
                    raise RuntimeError(f"Panel {p}/{_SIDE_NAMES[d]} and {q}/{_SIDE_NAMES[e]} edges do not align")

                # --- Exact vector conversion: A = J_local @ J_neighbor^-1,
                # evaluated at the edge points in LOCAL ordering.
                Xl, Yl = _edge_gnomonic(geom, d)
                Xn, Yn = _edge_gnomonic(geom, e)
                if flip:
                    Xn, Yn = Xn[::-1], Yn[::-1]
                j_loc = _scaled_jacobian(Xl, Yl, geom.lat_p[p], geom.angle_p[p], geom.delta_x1, geom.delta_x2)
                j_nb = _scaled_jacobian(Xn, Yn, geom.lat_p[q], geom.angle_p[q], geom.delta_x1, geom.delta_x2)
                conv = j_loc @ np.linalg.inv(j_nb)
                conv_cov = np.linalg.inv(conv).transpose(0, 2, 1)
                row.append(PanelEdge(neighbor=q, neighbor_side=e, flip=flip, conv_contra=conv, conv_cov=conv_cov))
            self.edges.append(row)

        # --- Batched exchange tables over the stacked (side, panel) pool.
        npts = self.num_points
        src = np.empty((4, 6), dtype=np.int32)
        flips = np.empty((4, 6), dtype=bool)
        conv_c = np.empty((4, 6, npts, 2, 2))
        conv_v = np.empty((4, 6, npts, 2, 2))
        for d in range(4):
            for p in range(6):
                edge = self.edges[p][d]
                src[d, p] = edge.neighbor_side * 6 + edge.neighbor
                flips[d, p] = edge.flip
                conv_c[d, p] = edge.conv_contra
                conv_v[d, p] = edge.conv_cov
        self._edge_src = src.reshape(-1)
        self._flip_mask = flips.reshape(-1)
        self._conv_contra_all = conv_c
        self._conv_cov_all = conv_v

        # Flat gather index over a (24 * npts) pool: output point i of
        # (side, panel) row r reads the neighbour row src[r] at i, or at
        # npts-1-i when that edge runs opposite.
        along = np.arange(npts)
        rows = [
            self._edge_src[r] * npts + (along[::-1] if self._flip_mask[r] else along)
            for r in range(24)
        ]
        self._gather_index = np.concatenate(rows).astype(np.int64)
        self._device_tables: Dict[tuple, object] = {}

    # ------------------------------------------------------------------
    # Device tables

    def gather_index(self, device) -> torch.Tensor:
        key = ("index", torch.device(device))
        if key not in self._device_tables:
            self._device_tables[key] = torch.as_tensor(self._gather_index, device=device)
        return self._device_tables[key]

    def gather_index_3d(self, nk: int, device) -> torch.Tensor:
        """Flat gather index over a 3D (24 * nk * nh * s^2) trace pool: the
        neighbour row, and where the edge runs opposite, the horizontal
        element and the horizontal face point reversed (the vertical face
        point kz kept; the reference's flip_dim=(-3, -1))."""
        key = ("index3d", nk, torch.device(device))
        if key not in self._device_tables:
            s = self.geom.num_solpts
            m = self.nel_h * s * s
            flipped = np.arange(m).reshape(self.nel_h, s, s)[::-1, :, ::-1].reshape(m)
            rows = [
                self._edge_src[r] * nk * m + np.arange(nk)[:, None] * m
                + (flipped if self._flip_mask[r] else np.arange(m))[None, :]
                for r in range(24)
            ]
            index = np.concatenate([r.reshape(-1) for r in rows]).astype(np.int64)
            self._device_tables[key] = torch.as_tensor(index, device=device)
        return self._device_tables[key]

    def conv_coefficients(self, device, dtype, covariant: bool = False) -> Tuple[torch.Tensor, ...]:
        """(c11, c12, c21, c22), each (4, 6, npts), of the 2x2 contravariant
        (or covariant) rotation."""
        key = ("cov" if covariant else "contra", torch.device(device), dtype)
        if key not in self._device_tables:
            conv = self._conv_cov_all if covariant else self._conv_contra_all
            self._device_tables[key] = tuple(
                torch.as_tensor(np.ascontiguousarray(conv[..., i, j]), device=device, dtype=dtype)
                for i in (0, 1)
                for j in (0, 1)
            )
        return self._device_tables[key]

    # ------------------------------------------------------------------
    # Exchange

    def exchange_pool(self, pool: torch.Tensor) -> torch.Tensor:
        """Exchange a prebuilt outgoing-trace pool (..., 4, 6, npts) in
        (S, N, W, E) side order: returns, for each (side, panel), the
        neighbour's facing trace in local edge ordering (flips applied)."""
        lead = pool.shape[:-3]
        flat = pool.reshape(lead + (24 * self.num_points,))
        out = torch.index_select(flat, -1, self.gather_index(pool.device))
        return out.reshape(pool.shape)

    def rotate_vectors(self, a1: torch.Tensor, a2: torch.Tensor):
        """2x2 panel-basis rotation of exchanged contravariant components
        (..., 4, 6, npts) into the receiving panel's basis."""
        c11, c12, c21, c22 = self.conv_coefficients(a1.device, a1.dtype)
        return c11 * a1 + c12 * a2, c21 * a1 + c22 * a2

    def _trace_pool(self, itf_i: torch.Tensor, itf_j: torch.Tensor) -> torch.Tensor:
        """All 24 outgoing boundary traces, stacked (..., 4, 6, npts) in
        (side, panel) order with sides (S, N, W, E).

        itf_i: (..., 6, ny, nx, 2s) west|east element-face values.
        itf_j: (..., 6, ny, nx, 2s) south|north element-face values."""
        s = self.geom.num_solpts
        lead = itf_i.shape[:-4]
        shp = lead + (6, self.num_points)
        south = itf_j[..., :, 0, :, :s].reshape(shp)
        north = itf_j[..., :, -1, :, s:].reshape(shp)
        west = itf_i[..., :, :, 0, :s].reshape(shp)
        east = itf_i[..., :, :, -1, s:].reshape(shp)
        return torch.stack([south, north, west, east], dim=-3)

    def halo_scalars(self, itf_i: torch.Tensor, itf_j: torch.Tensor) -> Dict[int, torch.Tensor]:
        """Halo traces of a scalar field for every panel and side:
        {side: (..., 6, npts)}, the neighbour's facing trace in local edge
        ordering."""
        g = self.exchange_pool(self._trace_pool(itf_i, itf_j))
        return {d: g[..., d, :, :] for d in range(4)}

    def halo_vectors(self, itf_i_1, itf_j_1, itf_i_2, itf_j_2) -> Dict[int, Tuple[torch.Tensor, torch.Tensor]]:
        """Halo traces of a contravariant 2-vector field, rotated into the
        local panel basis: {side: (comp1, comp2)}, each (..., 6, npts)."""
        a1 = self.exchange_pool(self._trace_pool(itf_i_1, itf_j_1))
        a2 = self.exchange_pool(self._trace_pool(itf_i_2, itf_j_2))
        b1, b2 = self.rotate_vectors(a1, a2)
        return {d: (b1[..., d, :, :], b2[..., d, :, :]) for d in range(4)}

    # ------------------------------------------------------------------
    # 3D variants: traces carry a vertical element axis (nk) and s^2 faces
    # (kz, k_horizontal) of which only the horizontal half flips and rotates.

    def _trace_pool_3d(self, itf_i: torch.Tensor, itf_j: torch.Tensor) -> torch.Tensor:
        """All 24 outgoing boundary traces, 3D: (..., 4, 6, nk, nh, s^2) in
        (side, panel) order with sides (S, N, W, E).

        itf_i: (..., 6, nk, ny, nx, 2s^2) west|east faces (face kz*s+ky).
        itf_j: (..., 6, nk, ny, nx, 2s^2) south|north faces (face kz*s+kx)."""
        ss = self.geom.num_solpts ** 2
        south = itf_j[..., :, :, 0, :, :ss]
        north = itf_j[..., :, :, -1, :, ss:]
        west = itf_i[..., :, :, :, 0, :ss]
        east = itf_i[..., :, :, :, -1, ss:]
        return torch.stack([south, north, west, east], dim=-5)

    def exchange_pool_3d(self, pool: torch.Tensor) -> torch.Tensor:
        """Exchange a 3D trace pool (..., 4, 6, nk, nh, s^2): for each
        (side, panel), the neighbour's facing trace in local ordering, edge
        flips applied. One index gather."""
        lead, nk = pool.shape[:-5], pool.shape[-3]
        flat = pool.reshape(lead + (-1,))
        out = torch.index_select(flat, -1, self.gather_index_3d(nk, pool.device))
        return out.reshape(pool.shape)

    def rotate_vectors_3d(self, a1: torch.Tensor, a2: torch.Tensor, covariant: bool = False):
        """2x2 panel-basis rotation of exchanged horizontal vector components
        (..., 4, 6, nk, nh, s^2), by horizontal edge point (broadcast over
        nk and kz)."""
        s, nh = self.geom.num_solpts, self.nel_h
        coef = [c.reshape(4, 6, 1, nh, 1, s)
                for c in self.conv_coefficients(a1.device, a1.dtype, covariant)]
        split = a1.shape[:-1] + (s, s)
        v1, v2 = a1.reshape(split), a2.reshape(split)
        b1 = coef[0] * v1 + coef[1] * v2
        b2 = coef[2] * v1 + coef[3] * v2
        return b1.reshape(a1.shape), b2.reshape(a2.shape)

    def halo_scalars_3d(self, itf_i: torch.Tensor, itf_j: torch.Tensor) -> Dict[int, torch.Tensor]:
        """{side: (..., 6, nk, nh, s^2)} halo traces of a scalar field."""
        g = self.exchange_pool_3d(self._trace_pool_3d(itf_i, itf_j))
        return {d: g[..., d, :, :, :, :] for d in range(4)}

    def halo_state_3d(self, itf_i: torch.Tensor, itf_j: torch.Tensor, vec_rows: Tuple[int, int] = (1, 2),
                      covariant: bool = False) -> torch.Tensor:
        """Exchange all state rows at once: itf_i/itf_j (nv, 6, nk, ny, nx,
        2s^2); rows ``vec_rows`` are the horizontal vector pair and get the
        2x2 rotation, every other row passes through like a scalar. Returns
        (nv, 4, 6, nk, nh, s^2) in (S, N, W, E) side order."""
        return self.halo_from_pool_3d(self._trace_pool_3d(itf_i, itf_j), vec_rows, covariant)

    def halo_from_pool_3d(self, pool: torch.Tensor, vec_rows: Tuple[int, int] = (1, 2),
                          covariant: bool = False) -> torch.Tensor:
        """``halo_state_3d`` on a prebuilt outgoing pool (nv, 4, 6, nk, nh, s^2)."""
        a = self.exchange_pool_3d(pool)
        r1, r2 = vec_rows
        b1, b2 = self.rotate_vectors_3d(a[r1], a[r2], covariant)
        rows = list(a.unbind(0))
        rows[r1], rows[r2] = b1, b2
        return torch.stack(rows)

    def halo_vectors_3d(self, itf_i_1, itf_j_1, itf_i_2, itf_j_2, itf_i_3, itf_j_3,
                        covariant: bool = False) -> Dict[int, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """3-vector halo: components 1/2 rotate with the 2x2 edge matrices,
        component 3 (vertical) passes through unchanged. {side: (c1, c2, c3)},
        each (..., 6, nk, nh, s^2)."""
        pool = torch.stack([
            self._trace_pool_3d(itf_i_1, itf_j_1),
            self._trace_pool_3d(itf_i_2, itf_j_2),
            self._trace_pool_3d(itf_i_3, itf_j_3),
        ])
        h = self.halo_from_pool_3d(pool, (0, 1), covariant)
        return {d: (h[0][..., d, :, :, :, :], h[1][..., d, :, :, :, :], h[2][..., d, :, :, :, :])
                for d in range(4)}
