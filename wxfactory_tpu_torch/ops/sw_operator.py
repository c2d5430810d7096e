"""The whole shallow-water DFR spatial operator: CUDA kernels, their
wrappers, their plain torch versions, the operator's constants and the halo
glue.

Counterpart of ``wxfactory_tpu/ops/pallas_sw_gen.py`` (``km_gen`` with its
perturbation mode and base planes, and the glue ``packed_slabs`` /
``halo_from_slabs``) and of ``wxfactory_tpu/ops/pallas_sw.py`` (``km_fused``,
``ke_edges``, ``kh_exchange`` and the whole-run ``kr_run``) without the TPU
layout machinery: the state stays in the model layout ``Q[3, 6, nel, nel,
s^2]`` (h, h*u1, h*u2), element ``(panel, ey, ex)``, node ``ky * s + kx``.

One operator call computes, for every element, the extrapolation to faces,
the sqrt(g)-weighted pointwise fluxes, the interior divergence, the AUSM
Mach-splitting interface fluxes, the boundary correction and the
Coriolis/Christoffel forcing (reference rhs_sw.py:81-238), optionally fused
with an RK stage combination ``a*x + b*q + cdt*RHS(q)`` and the output
state's panel-edge traces. With a perturbation
base (``SWPertBase``, the 14 base planes) the state, halo, output and traces
carry deltas around the base state q0 and the output is ``rhs0 + delta``,
every flux expanded term by term around the base (never F(q0 + dq) -
F(q0), which float32 could not resolve).

Panel-edge data travel as TRACES ``(3, 4, 6, nel, s)``: variable, side
(S, N, W, E — the topology's side order), panel, element along the edge,
point along the edge. ``edge_traces`` extracts them from a state, the
operator can emit them from its output, and ``halo_from_traces`` turns them
into the neighbour halos (same layout; exchange with edge flips + 2x2
contravariant rotation of the momenta). West/south panel-edge interfaces
take qL from the halo, east/north take qR from it. A whole-sphere call with
``halo=None`` takes its halo from the state itself: on the card one launch
whose panel-edge faces compute ``halo_from_traces(edge_traces(q))`` at the
points they need (``panel_edge_plan`` mirrors that indexing in numpy), so
an RHS or a stage is one launch; the halo glue runs on its own only at
setup (the perturbation base's halo). ``sw_run`` runs whole TVD-RK3 steps
at s=4 (one launch for all of them on a GPU).

One tile of the sphere (the port of ``pallas_sw_gen.km_tile``, the per-rank
kernel of the tile-parallel step): ``tile_constants`` slices the constants
to an nt x nt tile of one panel (layout ``(3, 1, nt, nt, s^2)``, halos and
traces ``(3, 4, 1, nt, s)``), ``tile_base`` the float64 perturbation base,
and ``sw_tile_operator`` launches the same kernel with one panel whose four
edges all take the halo.

The Jacobian action J(q).v of the absolute operator (the exponential and
Rosenbrock integrators' matvec), its halos from the state, is split in two
kernels: ``sw_tangent_prep`` once per linearisation point writes the
coefficient buffer (``sw_tangent_layout``), ``sw_tangent_apply`` once per
direction is linear in v; ``sw_tangent`` is the two in one call. Their
plain versions ``sw_tangent_prep_plain`` and ``sw_tangent_apply_plain`` are
the split in torch; ``sw_tangent_plain`` is ``torch.func.jvp`` of the plain
operator, the JAX package's ``jax.jvp`` of its XLA RHS, which the CPU path
runs.

Bottom topography (``SWTopography``, from ``build_topography``): the
absolute form takes it in its state mode (RHS and stages) and in the
tangent pair, on the card through their kernels with topography. The faces
extrapolate h + hsurf, the panel-edge faces the neighbour's h + hsurf, both
sides of an interface subtract its hsurf before the flux, and the forcing
gains g h (H^a1 dz1 + H^a2 dz2) (models/shallow_water.py:166-249 of the JAX
package). The perturbation form takes it in its state mode (RHS and
stages; on the card the perturbation kernel with topography): its base
traces and halo are those of h0 + hsurf with each interface's hsurf taken
away, made once in float64 with the base (``build_base_planes(...,
topo=)``), the deltas' are those of dh alone, and the forcing gains the
delta g dh (H^a1 dz1 + H^a2 dz2) (models/shallow_water.py:254-421 there).
The halo-plane mode, trace emission, the tile kernel and the whole-run
kernel refuse it; the JAX package has no tile step and no whole-run
kernel with topography either.

The tangent pair also runs at s = 1 (the pure finite-volume levels of the
fv-mg preconditioner); the operator needs s >= 2.

Each wrapper (``sw_operator``, ``sw_tangent_prep``, ``sw_tangent_apply``,
``sw_tile_operator``, ``sw_edges``, ``sw_halo``, ``sw_run``) runs its CUDA kernel for a CUDA
tensor and its plain version for a CPU tensor; there is no fallback between
them.
"""

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..common.constants import GRAVITY

# Kernel launches made by the wrappers (the plain versions do not count):
# the operator in absolute and in perturbation form (``state_launches``
# counts those of them that took the halo from the state, ``topo_launches``
# the absolute ones with topography, ``pert_topo_launches`` the
# perturbation ones with topography; ``topo_tangent_*_launches`` the tangent pair's with
# topography and ``s1_tangent_*_launches`` its launches at s = 1, counted in
# the prep and apply counts too), its tile
# launches in both forms, the edge-trace and halo kernels and the whole-run
# kernel, the tangent prep (once per linearisation point) and apply (once
# per J(q).v) kernels; and calls of the plain versions (the plain tangent's
# and the plain apply's apart).
launches = 0
pert_launches = 0
state_launches = 0
tile_launches = 0
pert_tile_launches = 0
edge_launches = 0
halo_launches = 0
run_launches = 0
tangent_prep_launches = 0
tangent_apply_launches = 0
topo_launches = 0
pert_topo_launches = 0
topo_tangent_prep_launches = 0
topo_tangent_apply_launches = 0
s1_tangent_prep_launches = 0
s1_tangent_apply_launches = 0
plain_calls = 0
plain_tangent_calls = 0


@dataclass(frozen=True)
class SWConstants:
    """Device constants of the operator at one (nel, s, dtype, device).

    The metric at solution points and interfaces is identical on all six
    panels (it depends on the panel-local gnomonic coordinates only), so
    one panel's copy is kept; the panel dependence of the time Christoffels
    is factored into ``gridrot`` (christoffel_a_0b = coriolis_factor_a_0b *
    gridrot), as the TPU kernel does."""

    nel: int
    s: int
    ops: torch.Tensor  # flat [EE (s^2, 4s) | DD (2s^2, s^2) | CC (4s, s^2)]
    # (13, nel, nel, s^2) single-panel metric, rows in the order of
    # build_constants' ``names`` (the kernel and the plain version rely on it)
    fields: torch.Tensor
    gridrot: torch.Tensor  # (6, nel, nel, s^2)
    itf_x: torch.Tensor  # (3, nel, nel+1, s): sqrt(g), H^11, H^21 at x1 interfaces
    itf_y: torch.Tensor  # (3, nel+1, nel, s): sqrt(g), H^22, H^12 at x2 interfaces
    # 6: the whole cubed sphere (gridrot (6, nel, nel, s^2)); 1: one tile of
    # nel x nel elements (``tile_constants``: the tile's slices of the metric,
    # gridrot (1, nel, nel, s^2) of its own panel)
    npanel: int = 6

    @property
    def ee(self) -> torch.Tensor:
        """(s^2, 4s) extrapolation to the [west | east | south | north] faces."""
        s2 = self.s * self.s
        return self.ops[: s2 * 4 * self.s].view(s2, 4 * self.s)

    @property
    def dd(self) -> torch.Tensor:
        """(2s^2, s^2) [fx | fy] -> x+y divergence sum."""
        s2 = self.s * self.s
        off = s2 * 4 * self.s
        return self.ops[off : off + 2 * s2 * s2].view(2 * s2, s2)

    @property
    def cc(self) -> torch.Tensor:
        """(4s, s^2) face fluxes [west | east | south | north] -> correction."""
        s2 = self.s * self.s
        off = s2 * 4 * self.s + 2 * s2 * s2
        return self.ops[off:].view(4 * self.s, s2)

    @property
    def dtype(self) -> torch.dtype:
        return self.ops.dtype

    @property
    def device(self) -> torch.device:
        return self.ops.device


def _one_panel(a: np.ndarray, name: str) -> np.ndarray:
    a = np.asarray(a, np.float64)
    if not np.array_equal(a, np.broadcast_to(a[:1], a.shape)):
        raise ValueError(f"metric field {name} differs across panels")
    return a[0]


def build_constants(ops, metric, nel: int, dtype=torch.float64, device="cpu") -> SWConstants:
    """Operator constants from the DFR operators and the 2D metric (host
    float64 numpy, cast once to ``dtype`` on ``device``)."""
    s = ops.num_solpts
    ee = np.concatenate([ops.extrap_x, ops.extrap_z], axis=1)
    dd = np.concatenate([ops.derivative_x, ops.derivative_z], axis=0)
    cc = np.concatenate([ops.correction_WE, ops.correction_DU], axis=0)
    flat = np.concatenate([ee.reshape(-1), dd.reshape(-1), cc.reshape(-1)])
    names = (
        "sqrtG", "H_contra_11", "H_contra_12", "H_contra_22",
        "coriolis_factor_1_01", "coriolis_factor_1_02",
        "coriolis_factor_2_01", "coriolis_factor_2_02",
        "christoffel_1_11", "christoffel_1_12", "christoffel_2_12", "christoffel_2_22",
        "inv_sqrtG",
    )
    fields = np.stack([_one_panel(getattr(metric, n), n) for n in names])
    gridrot = np.broadcast_to(np.asarray(metric.gridrot, np.float64), metric.sqrtG.shape)
    # Per-interface metric: interface m (0..nel) is the west (south) face of
    # halo-layout element m+1.
    itf_x = np.stack([
        _one_panel(np.asarray(getattr(metric, n))[:, :, 1:, :s], n)
        for n in ("sqrtG_itf_i", "H_contra_11_itf_i", "H_contra_21_itf_i")
    ])
    itf_y = np.stack([
        _one_panel(np.asarray(getattr(metric, n))[:, 1:, :, :s], n)
        for n in ("sqrtG_itf_j", "H_contra_22_itf_j", "H_contra_12_itf_j")
    ])
    t = lambda a: torch.as_tensor(np.array(a, dtype=np.float64, order="C"), dtype=dtype, device=device)
    return SWConstants(nel=nel, s=s, ops=t(flat), fields=t(fields), gridrot=t(gridrot),
                       itf_x=t(itf_x), itf_y=t(itf_y))


@dataclass(frozen=True)
class SWTopography:
    """Device planes of the bottom topography at one (nel, s, dtype,
    device), built once in float64 (``build_topography``) and cast: it
    varies from panel to panel, so unlike the metric it keeps a panel
    index."""

    hsurf: torch.Tensor  # (6, nel, nel, s^2) at the nodes
    hsurf_x: torch.Tensor  # (6, nel, nel+1, s) at the x1 interfaces
    hsurf_y: torch.Tensor  # (6, nel+1, nel, s) at the x2 interfaces
    # (2, 6, nel, nel, s^2): g (H^11 dz1 + H^12 dz2), g (H^21 dz1 + H^22 dz2),
    # the forcing's coefficients of h
    force: torch.Tensor

    @property
    def dtype(self) -> torch.dtype:
        return self.hsurf.dtype

    @property
    def device(self) -> torch.device:
        return self.hsurf.device


def build_topography(topo, metric, dtype=torch.float64, device="cpu") -> SWTopography:
    """The device planes of a ``Topography`` (host float64 numpy: hsurf,
    hsurf_itf_x1, hsurf_itf_x2, dzdx1, dzdx2) on the 2D metric, the forcing
    coefficients formed in float64 and everything cast once to ``dtype``."""
    dz1, dz2 = np.asarray(topo.dzdx1, np.float64), np.asarray(topo.dzdx2, np.float64)
    h = lambda n: np.asarray(getattr(metric, n), np.float64)
    force = np.stack([GRAVITY * (h("H_contra_11") * dz1 + h("H_contra_12") * dz2),
                      GRAVITY * (h("H_contra_21") * dz1 + h("H_contra_22") * dz2)])
    t = lambda a: torch.as_tensor(np.array(a, dtype=np.float64, order="C"), dtype=dtype, device=device)
    return SWTopography(hsurf=t(topo.hsurf), hsurf_x=t(topo.hsurf_itf_x1), hsurf_y=t(topo.hsurf_itf_x2),
                        force=t(force))


def _with_hsurf(q: torch.Tensor, topo: Optional[SWTopography]) -> torch.Tensor:
    """(h + hsurf, hu1, hu2): what the faces extrapolate (q without topography)."""
    return q if topo is None else torch.cat([(q[0] + topo.hsurf)[None], q[1:]])


def _without_hsurf(states, topo: Optional[SWTopography]):
    """(qL_x, qR_x, qL_y, qR_y) with each interface's hsurf taken from h on
    both sides (``_interface_states`` of the h + hsurf traces)."""
    if topo is None:
        return states
    qL_x, qR_x, qL_y, qR_y = states
    less = lambda a, hs: torch.cat([(a[0] - hs)[None], a[1:]])
    return (less(qL_x, topo.hsurf_x), less(qR_x, topo.hsurf_x), less(qL_y, topo.hsurf_y),
            less(qR_y, topo.hsurf_y))


def element_plan(s: int) -> dict:
    """The element kernel's indexing (csrc/sw_element.cuh), mirrored in
    numpy: which entries of the flat ``ops`` [EE | DD | CC] it reads as the
    1D factors, and which terms each sum of ``element_block`` takes, in its
    order. EE, DD and CC are Kronecker products with the identity, so
    each face point, derivative and correction has s, 2s and 4 terms.

    * ``factors`` (8s + 2s^2,): the ``ops`` position of each word of the
      kernel's factor buffer (``load_factors``): ext (4, s), dx (s, s),
      dy (s, s), corr (4, s).
    * ``face_nodes``, ``face_factor`` (4s, s): face point fi = f*s + k
      (faces W, E, S, N) sums node ``face_nodes[fi, m]`` times factor
      ``face_factor[fi, m]``, m ascending (``face_trace``).
    * ``div_terms``, ``div_factor`` (s^2, 2s): node j's divergence sums
      [fx | fy] entry ``div_terms[j, t]`` (fy at s^2 + node) times factor
      ``div_factor[j, t]``: its row's s x-terms, then its column's s
      y-terms.
    * ``corr_faces``, ``corr_factor`` (s^2, 4): node j's correction sums
      face flux ``corr_faces[j, t]`` times factor ``corr_factor[j, t]``,
      faces W, E, S, N."""
    s2, nf = s * s, 4 * s
    dd0, cc0 = s2 * nf, s2 * nf + 2 * s2 * s2
    f, m = np.divmod(np.arange(nf), s)
    ext = np.where(f < 2, m, m * s) * nf + f * s
    kx, m = np.divmod(np.arange(s2), s)
    dx = dd0 + m * s2 + kx
    ky, m = np.divmod(np.arange(s2), s)
    dy = dd0 + (s2 + m * s) * s2 + ky * s
    f, c = np.divmod(np.arange(nf), s)
    corr = cc0 + f * s * s2 + np.where(f < 2, c, c * s)
    factors = np.concatenate([ext, dx, dy, corr])

    fi = np.arange(nf)[:, None]
    f, k = np.divmod(fi, s)
    m = np.arange(s)[None, :]
    face_nodes = np.where(f < 2, k * s + m, m * s + k)
    face_factor = np.broadcast_to(f * s + m, (nf, s))

    ky, kx = np.divmod(np.arange(s2), s)
    ky, kx = ky[:, None], kx[:, None]
    div_terms = np.concatenate([ky * s + m, s2 + m * s + kx], axis=1)
    div_factor = np.concatenate([nf + kx * s + m, nf + s2 + ky * s + m], axis=1)
    corr_faces = np.concatenate([ky, s + ky, 2 * s + kx, 3 * s + kx], axis=1)
    corr_factor = nf + 2 * s2 + np.concatenate([kx, s + kx, 2 * s + ky, 3 * s + ky], axis=1)
    return {"factors": factors, "face_nodes": face_nodes, "face_factor": np.ascontiguousarray(face_factor),
            "div_terms": div_terms, "div_factor": div_factor, "corr_faces": corr_faces, "corr_factor": corr_factor}


def panel_edge_plan(nel: int, s: int, topology) -> dict:
    """The state mode's panel-edge indexing (csrc/sw_element.cuh:
    ``halo_source``, ``edge_trace``, ``rotate_halo``), mirrored in numpy: for
    the halo point (side, panel, along, k) of the halo layout (3, 4, 6, nel,
    s), sides (S, N, W, E), which neighbour face point the kernel
    extrapolates and where its rotation coefficients are. Arrays of shape
    (4, 6, nel, s):

    * ``elem``: the neighbour element, flat (panel*nel + ey)*nel + ex;
    * ``face``: its face (0 W, 1 E, 2 S, 3 N) and ``k`` the point on it, so
      its trace of variable v is ``face_trace`` of ``q[v, elem]`` (the
      nodes ``element_plan(s)["face_nodes"][face*s + k]`` times the 1D
      factors ``face_factor``);
    * ``conv``: the flat index row*npts + i of the point's 2x2 rotation in
      each of the four (24, npts) planes of ``HaloTables.conv``; the halo is
      (t0, c11 t1 + c12 t2, c21 t1 + c22 t2)."""
    npts = nel * s
    row = np.arange(24)[:, None]  # side*6 + panel
    i = np.arange(npts)[None, :]
    src = np.asarray(topology._edge_src, np.int64)[row]
    flip = np.asarray(topology._flip_mask, bool)[row]
    j = np.where(flip, npts - 1 - i, i)
    nside, npanel = np.divmod(src, 6)
    along, k = np.divmod(j, s)
    ey = np.choose(nside, [0, nel - 1, along, along])
    ex = np.choose(nside, [along, along, 0, nel - 1])
    face = np.broadcast_to(np.choose(nside, [2, 3, 0, 1]), j.shape)
    shape = (4, 6, nel, s)
    elem = (npanel * nel + ey) * nel + ex
    return {"elem": elem.reshape(shape), "face": face.reshape(shape), "k": k.reshape(shape),
            "conv": (row * npts + i).reshape(shape)}


@dataclass(frozen=True)
class HaloTables:
    """Device tables of the halo kernel (the counterpart of
    ``pallas_sw.HaloConstants``): for each (side, panel) row, the neighbour
    row that feeds it and whether that edge runs opposite, and the 2x2
    contravariant rotation at each edge point."""

    src: torch.Tensor  # (24,) int32, neighbour row side*6 + panel
    flip: torch.Tensor  # (24,) int32
    conv: torch.Tensor  # (4, 24, npts): c11, c12, c21, c22


def halo_tables(topology, device, dtype) -> HaloTables:
    """The halo kernel's tables on ``device`` (built once per device and
    dtype, kept on the topology)."""
    key = ("sw_halo", torch.device(device), dtype)
    if key not in topology._device_tables:
        conv = topology._conv_contra_all  # (4, 6, npts, 2, 2)
        npts = topology.num_points
        stacked = np.stack([conv[..., i, j] for i in (0, 1) for j in (0, 1)]).reshape(4, 24, npts)
        t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
        topology._device_tables[key] = HaloTables(
            src=t(topology._edge_src, torch.int32), flip=t(topology._flip_mask, torch.int32),
            conv=t(stacked, dtype),
        )
    return topology._device_tables[key]


@dataclass(frozen=True)
class SWPertBase:
    """The base state of the perturbation form and what every call around
    it reads: the 14 base planes of ``pallas_sw_gen.build_base_planes``
    (h0, hu10, hu20, u10, u20, the base face traces A0, the base halos E0,
    the float64 base RHS) in the model layout, computed in float64 once and
    cast to the working dtype."""

    q0: torch.Tensor  # (3, 6, nel, nel, s^2) base state
    u0: torch.Tensor  # (2, 6, nel, nel, s^2) hu0 / h0
    itf0: torch.Tensor  # (3, 6, nel, nel, 4s) its face traces [W | E | S | N]
    halo0: torch.Tensor  # (3, 4, 6, nel, s) its halo
    rhs0: torch.Tensor  # (3, 6, nel, nel, s^2) its float64 RHS
    # Built with bottom topography: itf0 and halo0 are the traces of h0 +
    # hsurf less each interface's hsurf, rhs0 the RHS with topography; every
    # call around it takes the same topography's planes.
    topography: bool = False

    @property
    def tensors(self):
        return {"q0": self.q0, "u0": self.u0, "itf0": self.itf0, "halo0": self.halo0, "rhs0": self.rhs0}


def build_base_planes(q0: torch.Tensor, con64: SWConstants, topology, dtype,
                      topo: Optional[SWTopography] = None) -> SWPertBase:
    """The perturbation base around ``q0`` from float64 constants on the
    device that will run the operator (the counterpart of
    ``pallas_sw_gen.build_base_planes``): traces and halos come from the
    runtime's own trace and halo functions, the base RHS from
    ``sw_operator`` (kernels on a GPU, plain versions on the CPU), all in
    float64; the results are cast to ``dtype``.

    With ``topo`` (float64 planes on the same device) the traces and halo
    are those of h0 + hsurf, each interface's hsurf then taken from both
    sides' h in float64, and the base RHS is the absolute operator's with
    topography (the JAX package's models/shallow_water.py:254-299)."""
    if con64.dtype != torch.float64:
        raise ValueError("the perturbation base is built from float64 constants")
    _check_topo(topo, con64, "build_base_planes")
    q0 = q0.to(device=con64.device, dtype=torch.float64).contiguous()
    hq0 = _with_hsurf(q0, topo)
    halo0 = sw_halo(sw_edges(hq0, con64), topology)
    itf0 = hq0 @ con64.ee
    if topo is None:
        rhs0 = sw_operator(q0, halo0, con64)
    else:
        rhs0 = sw_operator(q0, None, con64, topology=topology, topo=topo)
        itf0, halo0 = _less_interface_hsurf(itf0, halo0, topo)
    cast = lambda t: t.to(dtype).contiguous()
    return SWPertBase(q0=cast(q0), u0=cast(q0[1:3] / q0[0]), itf0=cast(itf0), halo0=cast(halo0),
                      rhs0=cast(rhs0), topography=topo is not None)


def _less_interface_hsurf(itf: torch.Tensor, halo: torch.Tensor, topo: SWTopography):
    """Face traces (3, 6, nel, nel, 4s) [W | E | S | N] and halo (3, 4, 6,
    nel, s) (S, N, W, E) with the hsurf of each face's interface taken from
    h: what ``_without_hsurf`` does to the interface states, on the planes
    the kernel reads."""
    hx, hy = topo.hsurf_x, topo.hsurf_y
    face_hs = torch.cat([hx[:, :, :-1], hx[:, :, 1:], hy[:, :-1], hy[:, 1:]], dim=-1)
    edge_hs = torch.stack([hy[:, 0], hy[:, -1], hx[:, :, 0], hx[:, :, -1]])
    itf, halo = itf.clone(), halo.clone()
    itf[0] -= face_hs
    halo[0] -= edge_hs
    return itf, halo


# ---------------------------------------------------------------------------
# Halo glue: plain versions and kernel wrappers


def edge_traces(q: torch.Tensor, con: SWConstants) -> torch.Tensor:
    """Panel-edge face traces of a state, (3, 4, 6, nel, s) in (S, N, W, E)
    order — only the edge elements are extrapolated (plain version of
    ``sw_edges``)."""
    global plain_calls
    plain_calls += 1
    return _edge_traces(q, con)


def _edge_traces(q: torch.Tensor, con: SWConstants) -> torch.Tensor:
    s, ee = con.s, con.ee
    south = q[:, :, 0, :, :] @ ee[:, 2 * s : 3 * s]
    north = q[:, :, -1, :, :] @ ee[:, 3 * s :]
    west = q[:, :, :, 0, :] @ ee[:, :s]
    east = q[:, :, :, -1, :] @ ee[:, s : 2 * s]
    return torch.stack([south, north, west, east], dim=1)


def halo_from_traces(traces: torch.Tensor, topology) -> torch.Tensor:
    """Outgoing traces -> halos (3, 4, 6, nel, s): for each (side, panel),
    the neighbour panel's facing trace in local edge ordering, momenta
    rotated into the local contravariant basis (the port of
    ``pallas_sw_gen.halo_from_slabs``; plain version of ``sw_halo``)."""
    global plain_calls
    plain_calls += 1
    return _halo_from_traces(traces, topology)


def _halo_from_traces(traces: torch.Tensor, topology) -> torch.Tensor:
    shape = traces.shape
    ex = topology.exchange_pool(traces.reshape(3, 4, 6, -1))
    b1, b2 = topology.rotate_vectors(ex[1], ex[2])
    return torch.stack([ex[0], b1, b2]).reshape(shape)


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(rc: int, lib, what: str, error_string: str = "sw_operator_error_string"):
    if rc != 0:
        name = getattr(lib, error_string)(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({name})")


def _cuda_or_raise(t: torch.Tensor, name: str):
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {t.device}")
    if t.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name} takes float32 or float64, not {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: input is not contiguous")


def sw_edges(q: torch.Tensor, con: SWConstants) -> torch.Tensor:
    """Panel-edge traces (3, 4, 6, nel, s) of ``q``: ``edge_traces`` for a
    CPU tensor; for a CUDA tensor one launch of the edge-trace kernel
    (csrc/sw_operator.cu, the port of ``pallas_sw.ke_edges``), or raises."""
    global edge_launches
    _check_npanel(con, 6, "sw_edges")
    state = (3, 6, con.nel, con.nel, con.s * con.s)
    if tuple(q.shape) != state or q.dtype != con.dtype or q.device != con.device:
        raise ValueError(f"q {tuple(q.shape)} {q.dtype} on {q.device}; expected {state} {con.dtype} on {con.device}")
    if q.device.type == "cpu":
        return edge_traces(q, con)
    _cuda_or_raise(q, "sw_edges")
    from ..kernels.build import load_library

    lib = load_library("sw_operator")
    traces = torch.empty((3, 4, 6, con.nel, con.s), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.sw_edges_launch(1 if q.dtype == torch.float64 else 0, con.s, con.nel, _ptr(q), _ptr(con.ops),
                                 _ptr(traces), _stream(q.device))
    _raise_on(rc, lib, "sw_edges")
    edge_launches += 1
    return traces


def sw_halo(traces: torch.Tensor, topology) -> torch.Tensor:
    """Halos (3, 4, 6, nel, s) from traces: ``halo_from_traces`` for a CPU
    tensor; for a CUDA tensor one launch of the halo kernel
    (csrc/sw_operator.cu, the port of ``pallas_sw.kh_exchange``), or raises.
    The halo is linear: absolute and delta traces take the same kernel."""
    global halo_launches
    npts = topology.num_points
    if tuple(traces.shape[:3]) != (3, 4, 6) or traces.shape[3] * traces.shape[4] != npts:
        raise ValueError(f"traces shape {tuple(traces.shape)} does not fit {npts} edge points")
    if traces.device.type == "cpu":
        return halo_from_traces(traces, topology)
    _cuda_or_raise(traces, "sw_halo")
    from ..kernels.build import load_library

    lib = load_library("sw_operator")
    tab = halo_tables(topology, traces.device, traces.dtype)
    halo = torch.empty_like(traces)
    with torch.cuda.device(traces.device):
        rc = lib.sw_halo_launch(1 if traces.dtype == torch.float64 else 0, npts, _ptr(traces), _ptr(tab.src),
                                _ptr(tab.flip), _ptr(tab.conv), _ptr(halo), _stream(traces.device))
    _raise_on(rc, lib, "sw_halo")
    halo_launches += 1
    return halo


# ---------------------------------------------------------------------------
# Plain torch version of the operator


def _ausm(qL, qR, msg, mhd, mho, is_x: bool):
    """AUSM Mach-splitting flux at a set of interfaces (reference
    rhs_sw.py:170-207), in the term order of ``pallas_sw._ausm_slots``.
    The divide guards ``where(tmp != 0, ...)`` are kept."""
    half_g = 0.5 * GRAVITY
    hL, hR = qL[0], qR[0]
    aL = torch.sqrt(GRAVITY * hL * mhd)
    aR = torch.sqrt(GRAVITY * hR * mhd)
    qnL = qL[1] if is_x else qL[2]
    qnR = qR[1] if is_x else qR[2]
    tmpL = hL * aL
    tmpR = hR * aR
    mL = torch.where(tmpL != 0.0, qnL / tmpL, 0.0)
    mR = torch.where(tmpR != 0.0, qnR / tmpR, 0.0)
    big_m = 0.25 * ((mL + 1.0) ** 2 - (mR - 1.0) ** 2)
    # max(0, M) and min(0, M) as 0.5 (M +- |M|): the same values bit for bit
    # (M + |M| is exactly 2M or 0), and the derivative jax.jvp gives
    # jnp.maximum/jnp.minimum at the tie M = 0 (half of dM; torch.clamp's
    # is all of it), which every interface of a state at rest sits on.
    adv_l = (0.5 * (big_m + big_m.abs())) * aL
    adv_r = (0.5 * (big_m - big_m.abs())) * aR
    f = [msg * (adv_l * qL[v] + adv_r * qR[v]) for v in range(3)]
    pres_l = (1.0 + mL) * (msg * half_g) * (hL * hL)
    pres_r = (1.0 - mR) * (msg * half_g) * (hR * hR)
    pres_diag = 0.5 * (mhd * pres_l + mhd * pres_r)
    pres_off = 0.5 * (mho * pres_l + mho * pres_r)
    if is_x:
        f[1], f[2] = f[1] + pres_diag, f[2] + pres_off
    else:
        f[1], f[2] = f[1] + pres_off, f[2] + pres_diag
    return torch.stack(f)


def _ausm_delta(L0, R0, dL, dR, msg, mhd, mho, is_x: bool):
    """Term-level delta of ``_ausm`` around the base interface states
    (L0, R0) for the perturbations (dL, dR), term for term as
    ``pallas_sw._ausm_delta_slots``: sound-speed delta g*mhd*dh/(a + a0),
    Mach-number deltas as differences of smooth state ratios, the split
    Mach terms as max(0, M) - max(0, M0) and min(0, M) - min(0, M0), the
    pressure term's exact expansion."""
    hL0, hR0 = L0[0], R0[0]
    dhL, dhR = dL[0], dR[0]
    hL, hR = hL0 + dhL, hR0 + dhR
    aL0 = torch.sqrt(GRAVITY * hL0 * mhd)
    aR0 = torch.sqrt(GRAVITY * hR0 * mhd)
    aL = torch.sqrt(GRAVITY * hL * mhd)
    aR = torch.sqrt(GRAVITY * hR * mhd)
    daL = torch.where(aL + aL0 > 0.0, GRAVITY * mhd * dhL / (aL + aL0), 0.0)
    daR = torch.where(aR + aR0 > 0.0, GRAVITY * mhd * dhR / (aR + aR0), 0.0)
    n = 1 if is_x else 2
    qn0L, qn0R, dqnL, dqnR = L0[n], R0[n], dL[n], dR[n]
    tmpL0, tmpL = hL0 * aL0, hL * aL
    tmpR0, tmpR = hR0 * aR0, hR * aR
    mL0 = torch.where(tmpL0 != 0.0, qn0L / tmpL0, 0.0)
    mR0 = torch.where(tmpR0 != 0.0, qn0R / tmpR0, 0.0)
    mL = torch.where(tmpL != 0.0, (qn0L + dqnL) / tmpL, 0.0)
    mR = torch.where(tmpR != 0.0, (qn0R + dqnR) / tmpR, 0.0)
    dmL, dmR = mL - mL0, mR - mR0
    M0 = 0.25 * ((mL0 + 1.0) ** 2 - (mR0 - 1.0) ** 2)
    dM = 0.25 * ((mL + mL0 + 2.0) * dmL - (mR + mR0 - 2.0) * dmR)
    M = M0 + dM
    P0 = torch.clamp(M0, min=0.0)
    dP = torch.clamp(M, min=0.0) - P0
    N0 = torch.clamp(M0, max=0.0)
    dN = torch.clamp(M, max=0.0) - N0
    f = []
    for v in range(3):
        l, r = L0[v] + dL[v], R0[v] + dR[v]
        f.append(msg * (dP * aL * l + P0 * (daL * l + aL0 * dL[v]) + dN * aR * r + N0 * (daR * r + aR0 * dR[v])))
    dterm = (dmL * hL * hL + (1.0 + mL0) * (hL + hL0) * dhL
             - dmR * hR * hR + (1.0 - mR0) * (hR + hR0) * dhR)
    dpres = (0.25 * GRAVITY) * msg * dterm
    diag, off = mhd * dpres, mho * dpres
    if is_x:
        f[1], f[2] = f[1] + diag, f[2] + off
    else:
        f[1], f[2] = f[1] + off, f[2] + diag
    return torch.stack(f)


def _interface_states(itf: torch.Tensor, halo: torch.Tensor, s: int):
    """(qL_x, qR_x, qL_y, qR_y): the left and right states at the nel+1
    interfaces of every element row (x) and column (y), from the element
    face traces ``itf`` (3, 6, nel, nel, 4s) and the halo."""
    west, east = itf[..., :s], itf[..., s : 2 * s]
    south, north = itf[..., 2 * s : 3 * s], itf[..., 3 * s :]
    hs, hn, hw, he = halo[:, 0], halo[:, 1], halo[:, 2], halo[:, 3]  # (3, 6, nel, s)
    return (torch.cat([hw.unsqueeze(3), east], dim=3), torch.cat([west, he.unsqueeze(3)], dim=3),
            torch.cat([hs.unsqueeze(2), north], dim=2), torch.cat([south, hn.unsqueeze(2)], dim=2))


def _correction(f_x: torch.Tensor, f_y: torch.Tensor, con: SWConstants) -> torch.Tensor:
    """Boundary correction CC applied to each element's four face fluxes."""
    faces = torch.cat(
        [f_x[..., :-1, :], f_x[..., 1:, :], f_y[..., :-1, :, :], f_y[..., 1:, :, :]], dim=-1
    )
    return faces @ con.cc


def _halo_of(q, halo, con: SWConstants, topology):
    """``halo``, or with ``halo=None`` the halo of ``q``'s own panel-edge
    traces (what the kernel's state mode computes at each panel-edge face)."""
    if halo is not None:
        return halo
    _check_topology(con, topology, "the operator's state mode (halo=None)")
    return _halo_from_traces(_edge_traces(q, con), topology)


def _finish(rhs, q, x, a: float, b: float, cdt: Optional[float], emit_traces: bool, con: SWConstants):
    if cdt is None:
        out = rhs
    else:
        out = b * q + cdt * rhs
        if a != 0.0:
            out = a * x + out
    if emit_traces:
        return out, edge_traces(out, con)
    return out


def sw_operator_plain(q, halo, con: SWConstants, x=None, a: float = 0.0, b: float = 1.0,
                      cdt: Optional[float] = None, emit_traces: bool = False,
                      base: Optional[SWPertBase] = None, topology=None, topo: Optional[SWTopography] = None):
    """Plain torch version of the operator; same arguments and results as
    ``sw_operator`` (written from models/shallow_water.py:130-252 and
    pallas_sw._element_stage / _ausm_slots of the JAX package; with
    ``base``, ``sw_operator_pert_plain``). ``halo=None``: the halo of q's
    own traces, ``halo_from_traces(edge_traces(q))``; with ``topo`` those
    of h + hsurf."""
    global plain_calls
    _check_topo_form(topo, halo, base, emit_traces, "sw_operator_plain")
    if base is not None:
        return sw_operator_pert_plain(q, halo, con, base, x=x, a=a, b=b, cdt=cdt, emit_traces=emit_traces,
                                      topology=topology, topo=topo)
    plain_calls += 1
    return _finish(_rhs_plain(q, halo, con, topology, topo), q, x, a, b, cdt, emit_traces, con)


def _check_topo_form(topo, halo, base, emit_traces: bool, name: str):
    """Topography runs with the halo from the state and no trace emission,
    and a perturbation base built with topography runs with its planes;
    raise for any other form rather than run without its source terms."""
    if base is not None and base.topography != (topo is not None):
        raise ValueError(f"{name}: a perturbation base built {'with' if base.topography else 'without'} "
                         f"topography takes {'its' if base.topography else 'no'} topography planes")
    if topo is None:
        return
    if halo is not None or emit_traces:
        raise ValueError(f"{name}: topography takes its halo from the state (halo=None) and emits no traces")


def _rhs_plain(q, halo, con: SWConstants, topology, topo: Optional[SWTopography] = None):
    """The absolute-form RHS of ``sw_operator_plain``, uncounted."""
    hq = _with_hsurf(q, topo)
    halo = _halo_of(hq, halo, con, topology)
    half_g = 0.5 * GRAVITY
    (sqrtg, h11, h12, h22, g101, g102, g201, g202,
     c111, c112, c212, c222, invsg) = con.fields
    h, hu1, hu2 = q[0], q[1], q[2]

    # Pointwise fluxes, interior divergence and forcing (_element_stage).
    u1 = hu1 / h
    u2 = hu2 / h
    hsq = h * h
    fx = torch.stack([sqrtg * hu1,
                      sqrtg * (hu1 * u1 + half_g * h11 * hsq),
                      sqrtg * (hu2 * u1 + half_g * h12 * hsq)])
    fy = torch.stack([sqrtg * hu2,
                      sqrtg * (hu1 * u2 + half_g * h12 * hsq),
                      sqrtg * (hu2 * u2 + half_g * h22 * hsq)])
    div = torch.cat([fx, fy], dim=-1) @ con.dd
    rot2 = 2.0 * con.gridrot
    forcing_1 = rot2 * (g101 * hu1 + g102 * hu2) + c111 * hu1 * u1 + 2.0 * c112 * hu1 * u2
    forcing_2 = rot2 * (g201 * hu1 + g202 * hu2) + 2.0 * c212 * hu1 * u2 + c222 * hu2 * u2
    if topo is not None:
        forcing_1 = forcing_1 + topo.force[0] * h
        forcing_2 = forcing_2 + topo.force[1] * h
    df = torch.stack([-invsg * div[0], -invsg * div[1] - forcing_1, -invsg * div[2] - forcing_2])

    # Interface fluxes at the nel+1 interfaces per element row / column.
    qL_x, qR_x, qL_y, qR_y = _without_hsurf(_interface_states(hq @ con.ee, halo, con.s), topo)
    f_x = _ausm(qL_x, qR_x, con.itf_x[0], con.itf_x[1], con.itf_x[2], is_x=True)
    f_y = _ausm(qL_y, qR_y, con.itf_y[0], con.itf_y[1], con.itf_y[2], is_x=False)
    return df - invsg * _correction(f_x, f_y, con)


def sw_operator_pert_plain(dq, halo, con: SWConstants, base: SWPertBase, x=None, a: float = 0.0,
                           b: float = 1.0, cdt: Optional[float] = None, emit_traces: bool = False, topology=None,
                           topo: Optional[SWTopography] = None):
    """Plain torch version of the perturbation form: ``dq`` is the
    perturbation around ``base.q0`` and ``halo`` the halo of its traces
    (``None``: computed here from dq's traces, the halo being linear);
    returns ``rhs0 + [RHS(q0 + dq) - RHS(q0)]`` with the bracket expanded
    term by term (``pallas_sw._element_stage_pert`` and
    ``_ausm_delta_slots``, the JAX package's ``rhs_delta_core``,
    models/shallow_water.py:346-421), or the stage combination of delta
    states (which is the absolute one whenever a + b = 1), and with
    ``emit_traces`` the output's delta traces. With ``topo`` (a base built
    with it) the forcing gains g dh (H^a1 dz1 + H^a2 dz2), the rest of the
    topography riding the base (models/shallow_water.py:355-421 there)."""
    global plain_calls
    _check_topo_form(topo, halo, base, emit_traces, "sw_operator_pert_plain")
    plain_calls += 1
    halo = _halo_of(dq, halo, con, topology)
    half_g = 0.5 * GRAVITY
    (sqrtg, h11, h12, h22, g101, g102, g201, g202,
     c111, c112, c212, c222, invsg) = con.fields
    h0, hu10, hu20 = base.q0[0], base.q0[1], base.q0[2]
    u10, u20 = base.u0[0], base.u0[1]
    dh, dhu1, dhu2 = dq[0], dq[1], dq[2]

    h = h0 + dh
    du1 = (dhu1 - u10 * dh) / h
    du2 = (dhu2 - u20 * dh) / h
    u1, u2 = u10 + du1, u20 + du2
    hph0 = h + h0
    d11 = dhu1 * u1 + hu10 * du1
    d12 = dhu1 * u2 + hu10 * du2
    d21 = dhu2 * u1 + hu20 * du1
    d22 = dhu2 * u2 + hu20 * du2
    fx = torch.stack([sqrtg * dhu1,
                      sqrtg * (d11 + half_g * h11 * hph0 * dh),
                      sqrtg * (d21 + half_g * h12 * hph0 * dh)])
    fy = torch.stack([sqrtg * dhu2,
                      sqrtg * (d12 + half_g * h12 * hph0 * dh),
                      sqrtg * (d22 + half_g * h22 * hph0 * dh)])
    div = torch.cat([fx, fy], dim=-1) @ con.dd
    rot2 = 2.0 * con.gridrot
    forcing_1 = rot2 * (g101 * dhu1 + g102 * dhu2) + c111 * d11 + 2.0 * c112 * d12
    forcing_2 = rot2 * (g201 * dhu1 + g202 * dhu2) + 2.0 * c212 * d12 + c222 * d22
    if topo is not None:
        forcing_1 = forcing_1 + topo.force[0] * dh
        forcing_2 = forcing_2 + topo.force[1] * dh
    df = torch.stack([-invsg * div[0], -invsg * div[1] - forcing_1, -invsg * div[2] - forcing_2])

    dL_x, dR_x, dL_y, dR_y = _interface_states(dq @ con.ee, halo, con.s)
    L0_x, R0_x, L0_y, R0_y = _interface_states(base.itf0, base.halo0, con.s)
    f_x = _ausm_delta(L0_x, R0_x, dL_x, dR_x, con.itf_x[0], con.itf_x[1], con.itf_x[2], is_x=True)
    f_y = _ausm_delta(L0_y, R0_y, dL_y, dR_y, con.itf_y[0], con.itf_y[1], con.itf_y[2], is_x=False)
    rhs = (df - invsg * _correction(f_x, f_y, con)) + base.rhs0
    return _finish(rhs, dq, x, a, b, cdt, emit_traces, con)


# ---------------------------------------------------------------------------
# Kernel wrapper of the operator


def _check(q, halo, con: SWConstants, x, a: float, base: Optional[SWPertBase]):
    """Shape, dtype, device and contiguity of the tensors the operator (or,
    without ``halo``, the whole-run kernel) reads."""
    nel, s, npanel = con.nel, con.s, con.npanel
    state = (3, npanel, nel, nel, s * s)
    halo_shape = (3, 4, npanel, nel, s)
    tensors = {"q": (q, state)}
    if halo is not None:
        tensors["halo"] = (halo, halo_shape)
    if a != 0.0:
        if x is None:
            raise ValueError("stage with a != 0 needs x")
        tensors["x"] = (x, state)
    if base is not None:
        shapes = {"q0": state, "u0": (2, npanel, nel, nel, s * s), "itf0": (3, npanel, nel, nel, 4 * s),
                  "halo0": halo_shape, "rhs0": state}
        tensors.update({name: (t, shapes[name]) for name, t in base.tensors.items()})
    for name, (t, shape) in tensors.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if t.dtype != con.dtype or t.device != con.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; constants are {con.dtype} on {con.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _check_kernel_shape(con: SWConstants, name: str, min_s: int = 2):
    """The kernels' instantiations: s from ``min_s`` (1 for the tangent
    pair, 2 for the operator) to 8, nel >= 2 on the whole sphere."""
    if con.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name} takes float32 or float64, not {con.dtype}")
    min_nel = 2 if con.npanel == 6 else 1
    if not (min_s <= con.s <= 8) or con.nel < min_nel:
        raise ValueError(f"{name} takes {min_s} <= s <= 8 and nel >= {min_nel}, not s={con.s}, nel={con.nel}")


def _check_topo(topo: Optional[SWTopography], con: SWConstants, name: str):
    """The topography planes' shapes, dtype and device against the
    whole-sphere constants."""
    if topo is None:
        return
    nel, s = con.nel, con.s
    shapes = {"hsurf": (6, nel, nel, s * s), "hsurf_x": (6, nel, nel + 1, s), "hsurf_y": (6, nel + 1, nel, s),
              "force": (2, 6, nel, nel, s * s)}
    for key, shape in shapes.items():
        t = getattr(topo, key)
        if tuple(t.shape) != shape or t.dtype != con.dtype or t.device != con.device or not t.is_contiguous():
            raise ValueError(f"{name}: topography {key} {tuple(t.shape)} {t.dtype} on {t.device}; expected "
                             f"{shape} {con.dtype} on {con.device}, contiguous")


def _check_topology(con: SWConstants, topology, name: str):
    """Raise unless ``topology`` is the whole sphere's at ``con``'s nel and
    s: the kernels index its halo tables (24 nel s edge points) from the
    constants' shape, so another grid's tables would be read out of bounds
    or give another grid's rotations."""
    if topology is None:
        raise ValueError(f"{name} takes its halo from the state only with the topology")
    if (getattr(topology, "nel_h", None), topology.num_points) != (con.nel, con.nel * con.s):
        raise ValueError(f"{name}: the topology has nel={getattr(topology, 'nel_h', None)} and "
                         f"{topology.num_points} edge points a panel side; the constants nel={con.nel}, s={con.s}")


def _check_npanel(con: SWConstants, npanel: int, name: str):
    if con.npanel != npanel:
        what = "whole-sphere" if npanel == 6 else "tile"
        raise ValueError(f"{name} takes {what} constants (npanel={npanel}), not npanel={con.npanel}")


def sw_operator(q, halo, con: SWConstants, x=None, a: float = 0.0, b: float = 1.0,
                cdt: Optional[float] = None, emit_traces: bool = False,
                base: Optional[SWPertBase] = None, topology=None, topo: Optional[SWTopography] = None):
    """The SW operator on ``q`` (3, 6, nel, nel, s^2) with neighbour halos
    ``halo`` (3, 4, 6, nel, s), or with ``halo=None`` (and the
    ``topology``) the halo of q's own panel-edge traces, taken from the
    neighbour panels' state inside the one launch (the state mode; in the
    perturbation form the delta halo, the base halo staying ``base.halo0``).

    RHS mode (``cdt is None``): returns RHS(q). Stage mode: returns
    ``a*x + b*q + cdt*RHS(q)`` (``x`` is read only when ``a != 0``). With
    ``emit_traces`` also returns the output's panel-edge traces
    (3, 4, 6, nel, s). With ``base`` (the perturbation form) ``q``, ``x``,
    ``halo``, the stage output and the traces are deltas around
    ``base.q0``, and the RHS is ``rhs0 + delta``.

    A CPU tensor runs ``sw_operator_plain``; a CUDA tensor launches the
    kernel (built from csrc/sw_operator.cu at first use) on the current
    stream, without synchronising, or raises: there is no fallback to the
    halo kernels when the state mode fails.

    ``topo`` (``SWTopography``): the bottom topography, in the state mode
    only (RHS and stages; one launch of the state mode's topography kernel,
    counted in ``topo_launches`` too; with ``base``, which must have been
    built with the same topography, of the perturbation kernel with
    topography, counted in ``pert_topo_launches``); any other form
    raises."""
    global launches, pert_launches, state_launches, topo_launches, pert_topo_launches
    _check_npanel(con, 6, "sw_operator")
    _check(q, halo, con, x, a, base)
    _check_topo_form(topo, halo, base, emit_traces, "sw_operator")
    _check_topo(topo, con, "sw_operator")
    if halo is None:
        _check_topology(con, topology, "sw_operator")
    if q.device.type == "cpu":
        return sw_operator_plain(q, halo, con, x=x, a=a, b=b, cdt=cdt, emit_traces=emit_traces, base=base,
                                 topology=topology, topo=topo)
    if topo is not None and base is not None:
        out = _launch_operator("sw_operator_state_pert_topo_launch", q, None, con, x, a, b, cdt, False, base,
                               halo_tables(topology, q.device, q.dtype), force=topo.force)
        state_launches += 1
        pert_topo_launches += 1
    elif topo is not None:
        out = _launch_operator_topo(q, con, x, a, b, cdt, halo_tables(topology, q.device, q.dtype), topo)
        state_launches += 1
        topo_launches += 1
    elif halo is None:
        out = _launch_operator("sw_operator_state_launch", q, None, con, x, a, b, cdt, emit_traces, base,
                               halo_tables(topology, q.device, q.dtype))
        state_launches += 1
    else:
        out = _launch_operator("sw_operator_launch", q, halo, con, x, a, b, cdt, emit_traces, base)
    if base is not None:
        pert_launches += 1
    else:
        launches += 1
    return out


def _launch_operator(entry: str, q, halo, con: SWConstants, x, a: float, b: float, cdt: Optional[float],
                     emit_traces: bool, base: Optional[SWPertBase], tables: Optional[HaloTables] = None,
                     force: Optional[torch.Tensor] = None):
    """One launch of the operator kernel through the C entry ``entry``
    (``sw_operator_launch`` or ``sw_tile_launch`` with a halo;
    ``sw_operator_state_launch`` with the halo tables instead;
    ``sw_operator_state_pert_topo_launch`` with them and the topography's
    forcing coefficients ``force``, and no traces) on the current stream."""
    if q.device.type != "cuda":
        raise ValueError(f"{entry} runs on cpu or cuda tensors, not {q.device}")
    _check_kernel_shape(con, entry)

    from ..kernels.build import load_library

    lib = load_library("sw_operator")
    use_x = cdt is not None and a != 0.0
    out = torch.empty_like(q)
    traces = (
        torch.empty((3, 4, con.npanel, con.nel, con.s), dtype=q.dtype, device=q.device)
        if emit_traces else None
    )
    pb = base.tensors if base is not None else {}
    halo_args = ((_ptr(halo),), ()) if tables is None else ((), (_ptr(tables.src), _ptr(tables.flip),
                                                                 _ptr(tables.conv)))
    tail = (_ptr(force), _ptr(out)) if force is not None else (_ptr(out), _ptr(traces))
    with torch.cuda.device(q.device):
        rc = getattr(lib, entry)(
            1 if q.dtype == torch.float64 else 0, con.s, con.nel,
            _ptr(q), *halo_args[0], _ptr(con.ops), _ptr(con.fields), _ptr(con.gridrot),
            _ptr(con.itf_x), _ptr(con.itf_y), _ptr(x if use_x else None),
            _ptr(pb.get("q0")), _ptr(pb.get("u0")), _ptr(pb.get("itf0")), _ptr(pb.get("halo0")),
            _ptr(pb.get("rhs0")), *halo_args[1], *tail,
            float(a), float(b), float(cdt if cdt is not None else 0.0),
            1 if cdt is not None else 0, _stream(q.device),
        )
    _raise_on(rc, lib, entry)
    return (out, traces) if emit_traces else out


def _launch_operator_topo(q, con: SWConstants, x, a: float, b: float, cdt: Optional[float], tables: HaloTables,
                          topo: Optional[SWTopography]):
    """One launch of the absolute state mode through the C entry
    ``sw_operator_state_topo_launch`` (``topo=None``: null planes, which
    launch the kernel without topography)."""
    if q.device.type != "cuda":
        raise ValueError(f"sw_operator_state_topo_launch runs on cuda tensors, not {q.device}")
    _check_kernel_shape(con, "sw_operator_state_topo_launch")
    from ..kernels.build import load_library

    lib = load_library("sw_operator")
    use_x = cdt is not None and a != 0.0
    out = torch.empty_like(q)
    planes = (topo.hsurf, topo.hsurf_x, topo.hsurf_y, topo.force) if topo is not None else (None,) * 4
    with torch.cuda.device(q.device):
        rc = lib.sw_operator_state_topo_launch(
            1 if q.dtype == torch.float64 else 0, con.s, con.nel,
            _ptr(q), _ptr(con.ops), _ptr(con.fields), _ptr(con.gridrot), _ptr(con.itf_x), _ptr(con.itf_y),
            _ptr(x if use_x else None), _ptr(tables.src), _ptr(tables.flip), _ptr(tables.conv),
            *[_ptr(t) for t in planes], _ptr(out),
            float(a), float(b), float(cdt if cdt is not None else 0.0), 1 if cdt is not None else 0,
            _stream(q.device),
        )
    _raise_on(rc, lib, "sw_operator_state_topo_launch")
    return out


# ---------------------------------------------------------------------------
# The Jacobian action J(q).v of the absolute operator


def sw_tangent_plain(q, v, con: SWConstants, topology, topo: Optional[SWTopography] = None):
    """Plain version of ``sw_tangent``: ``torch.func.jvp`` of the absolute
    operator with its halo taken from the state (``sw_operator_plain(q,
    None, ...)``; the halo is linear in the traces, so the tangent's halo is
    ``halo_from_traces(edge_traces(v))``), the counterpart of the JAX
    package's ``jax.jvp`` of its XLA RHS (models/shallow_water.py:166
    there). Counted in ``plain_tangent_calls``."""
    global plain_tangent_calls
    plain_tangent_calls += 1
    _check_topology(con, topology, "sw_tangent_plain")
    return torch.func.jvp(lambda y: _rhs_plain(y, None, con, topology, topo), (q,), (v,))[1]


# The split Jacobian action: a prep once per linearisation point q, an
# apply once per direction v. The prep writes every primal quantity of the
# linearisation that costs a square root, a division or a trace of q into
# one coefficient buffer; the apply is linear in v and uses none of them.
# Buffer layout (``sw_tangent_layout``; the kernels' own):
#
#   node   (3, 6, nel, nel, s^2)     rows SW_TANGENT_NODE_ROWS at each node
#   face_x (13, 6, nel, nel+1, s)    rows SW_TANGENT_FACE_ROWS at each x1
#   face_y (13, 6, nel+1, nel, s)    (x2) interface point of each panel, once
#                                    for both sides, in the interface
#                                    metric's order with a panel index
#
# An interface m = 0..nel of a panel's element row (column) has element
# m-1's east (north) face on its left and element m's west (south) face on
# its right; m = 0 takes its left values from the halo, m = nel its right.
# inv_ha = 1 / (h a), 0 where h a == 0 (the divide guard of the Mach
# numbers); M the split Mach number, whose sign gives the tie weight.
SW_TANGENT_NODE_ROWS = ("h", "u1", "u2")
SW_TANGENT_FACE_ROWS = ("h_L", "hu1_L", "hu2_L", "h_R", "hu1_R", "hu2_R", "a_L", "a_R", "inv_ha_L", "inv_ha_R",
                        "m_L", "m_R", "M")


def _tangent_size(con: SWConstants) -> int:
    """Elements of the coefficient buffer (``sw_tangent_layout``'s ``size``),
    without building the layout: the wrappers check it every call."""
    nel, s = con.nel, con.s
    return 6 * nel * (len(SW_TANGENT_NODE_ROWS) * nel * s * s + 2 * len(SW_TANGENT_FACE_ROWS) * (nel + 1) * s)


def sw_tangent_layout(con: SWConstants) -> dict:
    """Shapes and offsets (in elements) of the parts of the coefficient
    buffer, and its ``size``."""
    nel, s, kf = con.nel, con.s, len(SW_TANGENT_FACE_ROWS)
    shapes = {
        "node": (len(SW_TANGENT_NODE_ROWS), 6, nel, nel, s * s),
        "face_x": (kf, 6, nel, nel + 1, s),
        "face_y": (kf, 6, nel + 1, nel, s),
    }
    layout, offset = {}, 0
    for name, shape in shapes.items():
        layout[name] = (offset, shape)
        offset += int(np.prod(shape))
    layout["size"] = offset
    return layout


def sw_tangent_face_index(nel: int, s: int, side: int, panel: int, ey: int, ex: int, k: int):
    """Where the apply kernel reads the coefficients of point ``k`` of face
    ``side`` (0 W, 1 E, 2 S, 3 N) of element (panel, ey, ex), mirrored in
    numpy: (family "face_x" or "face_y", flat index within one row of it)."""
    if side < 2:
        return "face_x", ((panel * nel + ey) * (nel + 1) + ex + (side == 1)) * s + k
    return "face_y", ((panel * (nel + 1) + ey + (side == 3)) * nel + ex) * s + k


def _tangent_parts(coef: torch.Tensor, con: SWConstants):
    """(node, face_x, face_y) views of a coefficient buffer."""
    layout = sw_tangent_layout(con)
    view = lambda name: coef.narrow(0, layout[name][0], int(np.prod(layout[name][1]))).view(layout[name][1])
    return view("node"), view("face_x"), view("face_y")


def _ausm_tangent_coefficients(qL, qR, mhd, is_x: bool):
    """The rows SW_TANGENT_FACE_ROWS at a set of interfaces: the primal
    values of ``_ausm`` that its tangent needs (the kernel's
    ``swk::ausm_tangent_coefficients``)."""
    hL, hR = qL[0], qR[0]
    aL = torch.sqrt(GRAVITY * hL * mhd)
    aR = torch.sqrt(GRAVITY * hR * mhd)
    n = 1 if is_x else 2
    tmpL, tmpR = hL * aL, hR * aR
    mL = torch.where(tmpL != 0.0, qL[n] / tmpL, 0.0)
    mR = torch.where(tmpR != 0.0, qR[n] / tmpR, 0.0)
    big_m = 0.25 * ((mL + 1.0) * (mL + 1.0) - (mR - 1.0) * (mR - 1.0))
    return torch.stack([qL[0], qL[1], qL[2], qR[0], qR[1], qR[2], aL, aR,
                        torch.where(tmpL != 0.0, 1.0 / tmpL, 0.0), torch.where(tmpR != 0.0, 1.0 / tmpR, 0.0),
                        mL, mR, big_m])


def _ausm_tangent_apply(c, dL, dR, msg, mhd, mho, is_x: bool):
    """The AUSM flux's tangent from its coefficients ``c`` (rows
    SW_TANGENT_FACE_ROWS) in the direction (dL, dR), linear in it (the
    kernel's ``swk::ausm_tangent_apply``): jax.jvp's rules, half of dM to
    each split term at the tie M = 0."""
    half_g = 0.5 * GRAVITY
    hL, hR, aL, aR, ihaL, ihaR, mL, mR, big_m = c[0], c[3], c[6], c[7], c[8], c[9], c[10], c[11], c[12]
    dhL, dhR = dL[0], dR[0]
    daL = (GRAVITY * dhL * mhd) * (0.5 * (hL * ihaL))
    daR = (GRAVITY * dhR * mhd) * (0.5 * (hR * ihaR))
    n = 1 if is_x else 2
    dmL = (dL[n] - mL * (dhL * aL + hL * daL)) * ihaL
    dmR = (dR[n] - mR * (dhR * aR + hR * daR)) * ihaR
    dM = 0.5 * ((mL + 1.0) * dmL - (mR - 1.0) * dmR)
    zero = torch.zeros_like(dM)
    P, N = torch.clamp(big_m, min=0.0), torch.clamp(big_m, max=0.0)
    dP = torch.where(big_m > 0.0, dM, torch.where(big_m == 0.0, 0.5 * dM, zero))
    dN = torch.where(big_m < 0.0, dM, torch.where(big_m == 0.0, 0.5 * dM, zero))
    adv_l, adv_r = P * aL, N * aR
    dadv_l = dP * aL + P * daL
    dadv_r = dN * aR + N * daR
    f = [msg * ((dadv_l * c[v] + adv_l * dL[v]) + (dadv_r * c[3 + v] + adv_r * dR[v])) for v in range(3)]
    k = msg * half_g
    dpres_l = k * (dmL * (hL * hL) + (1.0 + mL) * (2.0 * hL * dhL))
    dpres_r = k * ((1.0 - mR) * (2.0 * hR * dhR) - dmR * (hR * hR))
    diag = 0.5 * (mhd * dpres_l + mhd * dpres_r)
    off = 0.5 * (mho * dpres_l + mho * dpres_r)
    if is_x:
        f[1], f[2] = f[1] + diag, f[2] + off
    else:
        f[1], f[2] = f[1] + off, f[2] + diag
    return torch.stack(f)


def sw_tangent_prep_plain(q, con: SWConstants, topology, topo: Optional[SWTopography] = None) -> torch.Tensor:
    """Plain torch version of the prep kernel: the coefficient buffer
    (``sw_tangent_layout``) of the linearisation at q, its panel-edge values
    the halo of q's own traces (with ``topo``: the traces of h + hsurf, each
    interface's hsurf then taken from both sides). Counted in
    ``plain_calls``."""
    global plain_calls
    plain_calls += 1
    _check_topology(con, topology, "sw_tangent_prep_plain")
    node = torch.stack([q[0], q[1] / q[0], q[2] / q[0]])
    hq = _with_hsurf(q, topo)
    qL_x, qR_x, qL_y, qR_y = _without_hsurf(
        _interface_states(hq @ con.ee, _halo_of(hq, None, con, topology), con.s), topo)
    face_x = _ausm_tangent_coefficients(qL_x, qR_x, con.itf_x[1], is_x=True)
    face_y = _ausm_tangent_coefficients(qL_y, qR_y, con.itf_y[1], is_x=False)
    return torch.cat([node.reshape(-1), face_x.reshape(-1), face_y.reshape(-1)])


def sw_tangent_apply_plain(coef, v, con: SWConstants, topology, topo: Optional[SWTopography] = None):
    """Plain torch version of the apply kernel: J.v from the coefficient
    buffer ``coef`` and the direction ``v`` (its halo that of its own
    traces), with linear arithmetic only: the pointwise fluxes' and
    forcing's tangents by the product rule with h du = dhu - u dh, the AUSM
    flux's tangent from the interface coefficients; with ``topo`` the
    forcing rows' force * dh (hsurf does not enter dh). Counted in
    ``plain_tangent_calls``."""
    global plain_tangent_calls
    plain_tangent_calls += 1
    _check_topology(con, topology, "sw_tangent_apply_plain")
    half_g = 0.5 * GRAVITY
    (sqrtg, h11, h12, h22, g101, g102, g201, g202,
     c111, c112, c212, c222, invsg) = con.fields
    node, face_x, face_y = _tangent_parts(coef, con)
    h, u1, u2 = node
    dh, dhu1, dhu2 = v[0], v[1], v[2]
    w1, w2 = dhu1 - u1 * dh, dhu2 - u2 * dh  # h du1, h du2
    dhsq = 2.0 * h * dh
    d11 = dhu1 * u1 + u1 * w1
    d12 = dhu1 * u2 + u1 * w2
    d21 = dhu2 * u1 + u2 * w1
    d22 = dhu2 * u2 + u2 * w2
    fx = torch.stack([sqrtg * dhu1,
                      sqrtg * (d11 + half_g * h11 * dhsq),
                      sqrtg * (d21 + half_g * h12 * dhsq)])
    fy = torch.stack([sqrtg * dhu2,
                      sqrtg * (d12 + half_g * h12 * dhsq),
                      sqrtg * (d22 + half_g * h22 * dhsq)])
    div = torch.cat([fx, fy], dim=-1) @ con.dd
    rot2 = 2.0 * con.gridrot
    dforce_1 = rot2 * (g101 * dhu1 + g102 * dhu2) + c111 * d11 + 2.0 * c112 * d12
    dforce_2 = rot2 * (g201 * dhu1 + g202 * dhu2) + 2.0 * c212 * d12 + c222 * d22
    if topo is not None:
        dforce_1 = dforce_1 + topo.force[0] * dh
        dforce_2 = dforce_2 + topo.force[1] * dh
    df = torch.stack([-invsg * div[0], -invsg * div[1] - dforce_1, -invsg * div[2] - dforce_2])
    dL_x, dR_x, dL_y, dR_y = _interface_states(v @ con.ee, _halo_of(v, None, con, topology), con.s)
    f_x = _ausm_tangent_apply(face_x, dL_x, dR_x, con.itf_x[0], con.itf_x[1], con.itf_x[2], is_x=True)
    f_y = _ausm_tangent_apply(face_y, dL_y, dR_y, con.itf_y[0], con.itf_y[1], con.itf_y[2], is_x=False)
    return df - invsg * _correction(f_x, f_y, con)


def _check_tangent(con: SWConstants, topology, name: str, **tensors):
    """The whole-sphere constants and topology, and the state-shaped
    tensors (or the coefficient buffer, ``coef``) of a tangent call."""
    _check_npanel(con, 6, name)
    _check_topology(con, topology, name)
    state = (3, 6, con.nel, con.nel, con.s * con.s)
    for key, t in tensors.items():
        shape = (_tangent_size(con),) if key == "coef" else state
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} shape {tuple(t.shape)} != {shape}")
        if t.dtype != con.dtype or t.device != con.device:
            raise ValueError(f"{name}: {key} is {t.dtype} on {t.device}; constants are {con.dtype} on {con.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")


def _launch_tangent(entry: str, con: SWConstants, topology, *tensors, topo_planes=()):
    """One launch of a tangent kernel through the C entry ``entry``: the
    leading (is_f64, s, nel), ``tensors`` as pointers, the halo tables, the
    topography planes (``topo_planes``, for a ``*_topo_launch`` entry) and
    the stream appended where the entry takes them; raises on a refused
    launch."""
    _check_kernel_shape(con, entry, min_s=1)
    from ..kernels.build import load_library

    lib = load_library("sw_operator")
    tab = halo_tables(topology, con.device, con.dtype)
    *args, out = tensors
    with torch.cuda.device(con.device):
        rc = getattr(lib, entry)(1 if con.dtype == torch.float64 else 0, con.s, con.nel, *[_ptr(a) for a in args],
                                 _ptr(tab.src), _ptr(tab.flip), _ptr(tab.conv), *[_ptr(t) for t in topo_planes],
                                 _ptr(out), _stream(con.device))
    _raise_on(rc, lib, entry)


def sw_tangent_prep(q, con: SWConstants, topology, topo: Optional[SWTopography] = None) -> torch.Tensor:
    """The linearisation of the absolute operator at ``q`` (3, 6, nel, nel,
    s^2), once per linearisation point: the coefficient buffer
    (``sw_tangent_layout``) the apply reads. A CPU tensor runs
    ``sw_tangent_prep_plain``; a CUDA tensor makes one launch of the prep
    kernel (csrc/sw_operator.cu, ``sw_tangent_prep_launch``) on the current
    stream, counted in ``tangent_prep_launches``, or raises. With ``topo``
    the prep kernel with topography (``sw_tangent_prep_topo_launch``, also
    counted in ``topo_tangent_prep_launches``); at s = 1 also counted in
    ``s1_tangent_prep_launches``."""
    global tangent_prep_launches, topo_tangent_prep_launches, s1_tangent_prep_launches
    _check_tangent(con, topology, "sw_tangent_prep", q=q)
    _check_topo(topo, con, "sw_tangent_prep")
    if q.device.type == "cpu":
        return sw_tangent_prep_plain(q, con, topology, topo)
    _cuda_or_raise(q, "sw_tangent_prep")
    coef = torch.empty(_tangent_size(con), dtype=q.dtype, device=q.device)
    if topo is None:
        _launch_tangent("sw_tangent_prep_launch", con, topology, q, con.ops, con.itf_x, con.itf_y, coef)
    else:
        _launch_tangent("sw_tangent_prep_topo_launch", con, topology, q, con.ops, con.itf_x, con.itf_y, coef,
                        topo_planes=(topo.hsurf, topo.hsurf_x, topo.hsurf_y))
        topo_tangent_prep_launches += 1
    tangent_prep_launches += 1
    s1_tangent_prep_launches += con.s == 1
    return coef


def sw_tangent_apply(coef, v, con: SWConstants, topology, topo: Optional[SWTopography] = None) -> torch.Tensor:
    """J(q).v from the linearisation ``coef`` (``sw_tangent_prep(q)``) in
    the direction ``v``, once per Jacobian action. A CPU tensor runs
    ``sw_tangent_apply_plain``; a CUDA tensor makes one launch of the apply
    kernel (csrc/sw_operator.cu, ``sw_tangent_apply_launch``) on the
    current stream, counted in ``tangent_apply_launches``, or raises. With
    ``topo`` the apply kernel with topography
    (``sw_tangent_apply_topo_launch``, also counted in
    ``topo_tangent_apply_launches``); at s = 1 also counted in
    ``s1_tangent_apply_launches``."""
    global tangent_apply_launches, topo_tangent_apply_launches, s1_tangent_apply_launches
    _check_tangent(con, topology, "sw_tangent_apply", coef=coef, v=v)
    _check_topo(topo, con, "sw_tangent_apply")
    if v.device.type == "cpu":
        return sw_tangent_apply_plain(coef, v, con, topology, topo)
    _cuda_or_raise(v, "sw_tangent_apply")
    out = torch.empty_like(v)
    args = (v, coef, con.ops, con.fields, con.gridrot, con.itf_x, con.itf_y, out)
    if topo is None:
        _launch_tangent("sw_tangent_apply_launch", con, topology, *args)
    else:
        _launch_tangent("sw_tangent_apply_topo_launch", con, topology, *args, topo_planes=(topo.force,))
        topo_tangent_apply_launches += 1
    tangent_apply_launches += 1
    s1_tangent_apply_launches += con.s == 1
    return out


def sw_tangent(q, v, con: SWConstants, topology, topo: Optional[SWTopography] = None):
    """J(q).v of the absolute SW operator at the state ``q`` in the direction
    ``v`` (both (3, 6, nel, nel, s^2), the constants' dtype and device), the
    halos of both taken from the state. A CPU tensor runs
    ``sw_tangent_plain``; a CUDA tensor launches the prep kernel, then the
    apply kernel (``sw_tangent_prep``, ``sw_tangent_apply``), or raises: no
    fallback to the plain version. ``topo``: with bottom topography."""
    _check_tangent(con, topology, "sw_tangent", q=q, v=v)
    _check_topo(topo, con, "sw_tangent")
    if q.device.type == "cpu":
        return sw_tangent_plain(q, v, con, topology, topo)
    return sw_tangent_apply(sw_tangent_prep(q, con, topology, topo), v, con, topology, topo)


# ---------------------------------------------------------------------------
# One tile of the cubed sphere (the port of pallas_sw_gen.km_tile)


def tile_constants(con: SWConstants, ey0: int, ex0: int, nt: int, panel: int) -> SWConstants:
    """The constants of the nt x nt tile at element (ey0, ex0) of ``panel``
    from the whole-sphere constants ``con`` (the port's ``_TileMetricView``,
    parallel/shard_map_sw_fused.py:42-68 of the JAX package): the one-panel
    metric holds on every panel, so its tile slice serves every panel's tile;
    gridrot is the tile's slice of its own panel; the interface metric keeps
    the tile's nt+1 interfaces each way."""
    _check_npanel(con, 6, "tile_constants")
    ys, xs = slice(ey0, ey0 + nt), slice(ex0, ex0 + nt)
    c = lambda t: t.contiguous()
    return SWConstants(
        nel=nt, s=con.s, ops=con.ops, fields=c(con.fields[:, ys, xs]),
        gridrot=c(con.gridrot[panel : panel + 1, ys, xs]),
        itf_x=c(con.itf_x[:, ys, ex0 : ex0 + nt + 1]), itf_y=c(con.itf_y[:, ey0 : ey0 + nt + 1, xs]),
        npanel=1,
    )


def build_tile_constants(ops, metric, ey0: int, ex0: int, nt: int, panel: int, dtype=torch.float64,
                         device="cpu") -> SWConstants:
    """``tile_constants`` from the DFR operators and the 2D metric."""
    nel = np.asarray(metric.sqrtG).shape[-2]
    return tile_constants(build_constants(ops, metric, nel, dtype=dtype, device=device), ey0, ex0, nt, panel)


def tile_base(base64: SWPertBase, ey0: int, ex0: int, nt: int, panel: int, dtype) -> SWPertBase:
    """The perturbation base of one tile from the whole-sphere float64 base
    (the JAX package's per-tile base planes, shard_map_sw_fused.py:205-260):
    the tile's slices of q0, u0, its face traces and its RHS, and a base halo
    whose interior tile edges read the neighbour element's float64 base trace
    and whose panel edges read the exchanged and rotated float64 base halo;
    all cast to ``dtype``."""
    if base64.q0.dtype != torch.float64:
        raise ValueError("tile bases are sliced from a float64 base")
    nel, s = base64.q0.shape[2], base64.itf0.shape[-1] // 4
    ys, xs = slice(ey0, ey0 + nt), slice(ex0, ex0 + nt)
    node = lambda t: t[:, panel : panel + 1, ys, xs]
    face = lambda ey, ex, f: base64.itf0[:, panel, ey, ex, f * s : (f + 1) * s]  # faces W, E, S, N
    halo0 = torch.stack([
        base64.halo0[:, 0, panel, xs] if ey0 == 0 else face(ey0 - 1, xs, 3),
        base64.halo0[:, 1, panel, xs] if ey0 + nt == nel else face(ey0 + nt, xs, 2),
        base64.halo0[:, 2, panel, ys] if ex0 == 0 else face(ys, ex0 - 1, 1),
        base64.halo0[:, 3, panel, ys] if ex0 + nt == nel else face(ys, ex0 + nt, 0),
    ], dim=1).unsqueeze(2)  # (3, 4, 1, nt, s)
    cast = lambda t: t.to(dtype).contiguous()
    return SWPertBase(q0=cast(node(base64.q0)), u0=cast(node(base64.u0)), itf0=cast(node(base64.itf0)),
                      halo0=cast(halo0), rhs0=cast(node(base64.rhs0)))


def tile_edge_traces(q: torch.Tensor, con: SWConstants) -> torch.Tensor:
    """The tile-edge traces (3, 4, 1, nt, s) of a tile state (a delta's for a
    delta), the tile chain's bootstrap: the edge elements extrapolated with
    EE, as ``edge_traces`` does (not counted as a plain call: it is glue)."""
    return _edge_traces(q, con)


def sw_tile_operator_plain(q, halo, con: SWConstants, x=None, a: float = 0.0, b: float = 1.0,
                           cdt: Optional[float] = None, emit_traces: bool = False,
                           base: Optional[SWPertBase] = None):
    """Plain torch version of the tile kernel: the plain operator
    (``sw_operator_plain``) on tile constants (``tile_constants``), a tile
    state (3, 1, nt, nt, s^2) and its halo (3, 4, 1, nt, s) on all four
    sides; with ``base`` a tile base (``tile_base``)."""
    _check_npanel(con, 1, "sw_tile_operator_plain")
    return sw_operator_plain(q, halo, con, x=x, a=a, b=b, cdt=cdt, emit_traces=emit_traces, base=base)


def sw_tile_operator(q, halo, con: SWConstants, x=None, a: float = 0.0, b: float = 1.0,
                     cdt: Optional[float] = None, emit_traces: bool = False,
                     base: Optional[SWPertBase] = None):
    """The operator over one tile: ``sw_operator`` with tile constants, a
    tile state (3, 1, nt, nt, s^2), its halo (3, 4, 1, nt, s) and, with
    ``emit_traces``, the output's tile-edge traces (3, 4, 1, nt, s). A CPU
    tensor runs ``sw_tile_operator_plain``; a CUDA tensor makes one launch of
    the tile kernel (csrc/sw_operator.cu, ``sw_tile_launch``, the port of
    ``pallas_sw_gen.km_tile``), counted in ``tile_launches`` (absolute) or
    ``pert_tile_launches`` (perturbation form), or raises."""
    global tile_launches, pert_tile_launches
    _check_npanel(con, 1, "sw_tile_operator")
    if halo is None:
        raise ValueError("sw_tile_operator takes a halo: a tile's neighbours are not in its state")
    _check(q, halo, con, x, a, base)
    if q.device.type == "cpu":
        return sw_tile_operator_plain(q, halo, con, x=x, a=a, b=b, cdt=cdt, emit_traces=emit_traces, base=base)
    out = _launch_operator("sw_tile_launch", q, halo, con, x, a, b, cdt, emit_traces, base)
    if base is not None:
        pert_tile_launches += 1
    else:
        tile_launches += 1
    return out


# ---------------------------------------------------------------------------
# Whole TVD-RK3 runs (the port of pallas_sw.kr_run)


def tvdrk3_abc(dt: float):
    """Per-stage rows ((a_k), (b_k), (c_k*dt)) of TVD-RK3 in two-register
    SSP form, ``y_out = a*x + b*y + c*dt*RHS(y)`` (``pallas_sw.tvdrk3_abc``),
    as host numbers; c*dt is formed as the explicit integrators form it."""
    a = (0.0, 0.75, 1.0 / 3.0)
    b = (1.0, 0.25, 2.0 / 3.0)
    return a, b, tuple(c * dt for c in (1.0, 0.25, 2.0 / 3.0))


def run_supported(s: int, nel: int) -> bool:
    """The gate of ``pallas_sw.run_supported``: the whole-run path exists
    at s=4 with nel a multiple of 32 (float32 and float64 on the card)."""
    return s == 4 and nel % 32 == 0


def sw_chain(q, nsteps: int, abc, con: SWConstants, topology, base: Optional[SWPertBase] = None,
             plain: bool = False):
    """``nsteps`` TVD-RK3 steps of ``q`` as the explicit integrators chain
    them: one operator stage a stage, its halo taken from its input state
    (``halo=None``). ``plain``: the plain operator; otherwise the wrapper
    (one kernel launch a stage on a GPU)."""
    operator = sw_operator_plain if plain else sw_operator
    a, b, cdt = abc
    x = q
    for _ in range(nsteps):
        y = x
        for k in range(3):
            y = operator(y, None, con, x=x, a=a[k], b=b[k], cdt=cdt[k], base=base, topology=topology)
        x = y
    return x


def sw_run_plain(q, nsteps: int, abc, con: SWConstants, topology, base: Optional[SWPertBase] = None):
    """Plain version of ``sw_run``: ``nsteps`` x 3 iterations of the plain
    stage (``sw_chain`` of the plain functions)."""
    return sw_chain(q, nsteps, abc, con, topology, base, plain=True)


def sw_run(q, nsteps: int, abc, con: SWConstants, topology, base: Optional[SWPertBase] = None):
    """``nsteps`` TVD-RK3 steps of ``q`` at s=4 with the per-stage
    coefficients ``abc`` (``tvdrk3_abc``; host numbers, so nothing waits for
    the card). With ``base`` the state is the perturbation around
    ``base.q0``. A CPU tensor runs ``sw_run_plain``; a CUDA tensor makes one
    cooperative launch of the whole-run kernel (csrc/sw_run.cu) on the
    current stream, or raises (a grid the card cannot hold at once is an
    error, not a reason to launch stage by stage)."""
    global run_launches
    _check_npanel(con, 6, "sw_run")
    _check(q, None, con, None, 0.0, base)
    if con.s != 4:
        raise ValueError(f"sw_run takes s = 4, not s = {con.s}")
    if nsteps < 1:
        raise ValueError(f"sw_run takes nsteps >= 1, not {nsteps}")
    _check_topology(con, topology, "sw_run")
    if q.device.type == "cpu":
        return sw_run_plain(q, nsteps, abc, con, topology, base)
    _check_kernel_shape(con, "sw_run")
    from ..kernels.build import load_library

    lib = load_library("sw_run")
    tab = halo_tables(topology, q.device, q.dtype)
    out, buf1, buf2 = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    tshape = (3, 4, 6, con.nel, con.s)
    tr0 = torch.empty(tshape, dtype=q.dtype, device=q.device)
    tr1 = torch.empty(tshape, dtype=q.dtype, device=q.device)
    coeffs = (ctypes.c_double * 9)(*[float(c) for row in abc for c in row])
    pb = base.tensors if base is not None else {}
    with torch.cuda.device(q.device):
        rc = lib.sw_run_launch(
            1 if q.dtype == torch.float64 else 0, con.s, con.nel,
            _ptr(q), _ptr(con.ops), _ptr(con.fields), _ptr(con.gridrot), _ptr(con.itf_x), _ptr(con.itf_y),
            _ptr(pb.get("q0")), _ptr(pb.get("u0")), _ptr(pb.get("itf0")), _ptr(pb.get("halo0")),
            _ptr(pb.get("rhs0")), _ptr(tab.src), _ptr(tab.flip), _ptr(tab.conv),
            _ptr(out), _ptr(buf1), _ptr(buf2), _ptr(tr0), _ptr(tr1),
            ctypes.cast(coeffs, ctypes.c_void_p), int(nsteps), _stream(q.device),
        )
    _raise_on(rc, lib, "sw_run", "sw_run_error_string")
    run_launches += 1
    return out
