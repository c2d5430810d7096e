"""The whole 3D Euler DFR spatial operator: CUDA kernel, its wrapper, its
plain torch version, its constants and the halo glue.

Counterpart of ``wxfactory_tpu/ops/pallas_euler3d.py`` (``km3_fused`` in its
absolute form, with the glue ``edge_halo`` / ``halo_from_slabs``) without
the TPU layout machinery: the state stays in the model layout
``Q[5, 6, nk, ny, nx, s^3]`` (rho, rho*u1, rho*u2, rho*w, rho*theta),
element ``(panel, ez, ey, ex)``, node ``(kz*s + ky)*s + kx``.

One operator call computes, for every element, the log-space extrapolation
of rho and rho*theta (linear for the momenta) to the six faces, the
sqrt(g)-weighted pointwise fluxes, the interior divergence, the Rusanov
interface fluxes with the rho*w advection/pressure split (the w pressure
gradient in the p * d(log p) form), the rigid-lid/ground mirror, the
boundary corrections, the Christoffel/Coriolis forcing and the
high-mode-filtered gravity term (``models/euler_cubesphere.py:90-291`` of
the JAX package), optionally with the well-balanced offset ``bal`` added to
the RHS, fused with an RK stage combination ``a*x + b*q + cdt*(RHS(q) +
bal)`` and the output state's panel-edge traces for the next stage's halo.

Panel-edge data travel as TRACES ``(5, 4, 6, nk, nh, s^2)``: variable, side
(S, N, W, E), panel, vertical element, element along the edge, face point
(``kz*s + k_along``). ``edge_traces`` extracts them from a state, the kernel
emits them from its output, and ``halo_from_traces`` turns them into the
neighbour halos (same layout; edge flips + 2x2 contravariant rotation of
rho*u1, rho*u2). West/south interfaces at a panel edge take qL from the
halo, east/north take qR from it; the ground and the lid mirror the state
with w odd.

``euler3d_operator`` runs the CUDA kernel for a CUDA tensor and
``euler3d_operator_plain`` for a CPU tensor; there is no fallback between
them.

One tile of the sphere (the port of ``pallas_euler3d.km3_tile``, the
per-rank kernel of the tile-parallel step): ``tile_constants`` slices the
constants to an nt x nt tile of columns of one panel (state ``(5, 1, nk, nt,
nt, s^3)``, halos and traces ``(5, 4, 1, nk, nt, s^2)``), ``tile_pert_base``
the float64 perturbation base, and ``euler3d_tile_operator`` launches the
same kernel with one panel whose four horizontal edges all take the halo
(``euler3d_tile_operator_plain`` on the CPU).

The operator's Jacobian action J(q).v (``km3_fused``'s tangent mode, the
matvec of the exponential integrators' Krylov loop) comes in two kernels:
``euler3d_tangent_prep`` once per linearisation point writes every primal
quantity the action needs into a coefficient buffer (``tangent_layout``),
and ``euler3d_tangent_apply`` once per direction reads it and is linear in
the direction; ``euler3d_tangent`` is the two in one call. CPU tensors run
their plain versions (``euler3d_tangent_prep_plain``,
``euler3d_tangent_apply_plain``); ``euler3d_tangent_plain``
(``torch.func.jvp`` of the plain operator) is the independent yardstick
of both. Its halo glue is the primal glue's derivative:
``edge_traces_tangent`` gives the direction's panel-edge traces (linear
extrapolation of the momenta, ``tr_q * (E.(v/q))`` for the log-space rows)
and ``halo_from_traces``, which is linear, exchanges them.

Terrain (DCMIP 20, 21, 22): with bottom topography the metric differs from
panel to panel, so the constants keep all six panels' interior and
interface metric (``E3Constants.panel_metric``; ``build_constants(...,
panel_metric=True)``, chosen from the geometry's ``zbot``:
``has_topography``), and DCMIP 21/22 add the Rayleigh sponge as four planes
on the constants (``sponge``: the mask and mask * u_ref of each
contravariant wind; the momentum forcing ``mask q[1+i] - q[0] (mask
u_ref_i)``, the JAX package's ``rho mask (u_i - u_ref_i)``,
testcases/dcmip.py:321-324 there, linear in q). Such constants launch the
kernels' terrain instantiations (C entries ``*_terrain_launch``, counted in
``terrain_launches``, ``terrain_pert_launches``,
``terrain_tangent_prep_launches`` and ``terrain_tangent_apply_launches``);
the plain versions take both through broadcasting and the forcing rows.
The perturbation form refuses a sponge, as the JAX one refuses
``extra_forcing`` (models/euler_cubesphere.py:679 there). A tile of the
sphere reads one panel, so ``tile_constants`` hands it its own panel's
slice in the one-panel layout, and the tile launch needs no terrain code.

The perturbation (base-state-split) form, ``km3_fused``'s ``pert=`` mode
(``_km3_body`` with ``base=``, the JAX package's ``_euler3d_rhs_core_pert``):
the state is carried as ``dq = q - q0`` around a balanced base state ``q0``
(``E3PertBase``, built once in float64 on the state's device and cast), and
every nonlinear site is expanded exactly around it (``expm1``/``log1p`` of
the log-space rows and the pressure, product rules elsewhere), so the
hydrostatic cancellation never has to survive float32 rounding.
``euler3d_operator(dq, halo_dq, con, pert=base)`` returns ``rhs0 + delta``
(in stage mode the stage combination of perturbations, with the output's
delta traces when asked: ``km3_fused(pert=, x=, cdt=, stage_a=, stage_b=,
emit_slabs=True)``, the TVD-RK3 chain of the float32 perturbation form)
and ``euler3d_tangent(dq, v, halo_dq, halo_v, con, pert=base)`` returns
J(q0 + dq).v; the halo glue is ``edge_traces_delta`` (the delta traces,
``t0 * expm1(E.log1p(dq/q0))`` for the log-space rows) and, for the
direction, ``edge_traces_tangent`` at the absolute state with the absolute
traces ``t0 + dt``. The plain versions are ``euler3d_operator_pert_plain``
and ``euler3d_tangent_pert_plain``; the prep takes ``pert=base`` and the
apply is the same for both forms.
"""

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..common.constants import GRAVITY, HEAT_CAPACITY_RATIO, P0, RD

# Kernel launches made by ``euler3d_operator`` and ``euler3d_tangent_apply``
# in absolute and perturbation form (the perturbation form's RHS-mode and
# stage-mode launches apart), by ``euler3d_tangent_prep`` (both forms), by
# ``euler3d_tile_operator`` in absolute and perturbation form, and calls of
# the plain operators (the prep's among them) and of the plain tangents and
# applies (a run on the card must make none). Constants with a per-panel
# metric (terrain) launch the terrain instantiations instead, counted
# apart: the operator in absolute form (RHS and stage) and in perturbation
# form, the prep (both forms) and the apply (both forms).
launches = 0
tangent_launches = 0
tangent_prep_launches = 0
pert_launches = 0
pert_stage_launches = 0
tile_launches = 0
pert_tile_launches = 0
pert_tangent_launches = 0
plain_calls = 0
plain_tangent_calls = 0
terrain_launches = 0
terrain_pert_launches = 0
terrain_tangent_prep_launches = 0
terrain_tangent_apply_launches = 0
# Launches of the tracer-advection kernel (``euler3d_advection``; its plain
# version counts in ``plain_calls``) and of its Jacobian action's prep and
# apply kernels (their plain versions count in ``plain_calls`` and
# ``plain_tangent_calls``).
advection_launches = 0
advection_tangent_prep_launches = 0
advection_tangent_apply_launches = 0

# Names of the single-panel interior fields, in the order of ``fields``
# (the kernel relies on it): sqrt(g), 1/sqrt(g), 1/(dz/deta), the six
# h^{ab} (a <= b), the 18 spatial Christoffels Gamma^a_{bc} (rows 3..8 of
# metric.christoffel for a = 0, 1, 2) and the interior w-pressure term.
H_PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
N_FIELDS = 3 + len(H_PAIRS) + 18 + 1


@dataclass(frozen=True)
class E3Constants:
    """Device constants of the operator at one (nel_h, nel_v, s, dtype, device).

    The metric at solution points and interfaces is the same on all six
    panels of the equiangular cubed sphere without topography (to the
    rounding of the numerical metric build), so one panel's copy is kept.
    With topography it differs from panel to panel and all six are kept
    (``panel_metric``: ``fields`` (N_FIELDS, 6, nk, ny, nx, s^3) and each
    interface family with a panel axis after its row axis). The time
    Christoffels of a rotating planet depend on the panel and are kept
    whole (``tch``); on a non-rotating planet they vanish (None). The
    Rayleigh sponge of DCMIP 21/22 (``sponge``, per-panel metric only)
    is (4, 6, nk, ny, nx, s^3): the mask and mask * u_ref of u1, u2, u3."""

    nel_h: int
    nel_v: int
    s: int
    # 1D operators for the kernel: [extrap_neg (s) | extrap_pos (s) |
    # corr_neg (s) | corr_pos (s) | diff_solpt (s, s) | highfilter (s, s)]
    ops1d: torch.Tensor
    # Dense 3D operators for the plain version (trailing axis s^3):
    ee: torch.Tensor  # (s^3, 6s^2) -> faces [W | E | S | N | D | U]
    dd: torch.Tensor  # (3s^3, s^3) [fx | fy | fz] -> divergence sum
    dd3: torch.Tensor  # (s^3, 3s^3) -> [d/dx | d/dy | d/dz]
    cc: torch.Tensor  # (6s^2, s^3) faces -> correction sum
    ccb: torch.Tensor  # (6s^2, 3s^3) faces -> per-direction correction
    hfk: torch.Tensor  # (s^3, s^3) kill the highest vertical mode
    fields: torch.Tensor  # (N_FIELDS, nk, ny, nx, s^3) single panel; (N_FIELDS, 6, ...) per panel
    tch: Optional[torch.Tensor]  # (9, 6, nk, ny, nx, s^3) Gamma^a_{0b}, or None
    # Interface metric [sqrt(g), h^{d0}, h^{d1}, h^{d2}] of direction d
    # (per panel: (4, 6, ...)):
    itf_x: torch.Tensor  # (4, nk, ny, nx+1, s^2)
    itf_y: torch.Tensor  # (4, nk, ny+1, nx, s^2)
    itf_z: torch.Tensor  # (4, nk+1, ny, nx, s^2)
    # 6: the whole cubed sphere; 1: one tile of nel_h x nel_h columns
    # (``tile_constants``: the metric's tile slices, tch (9, 1, ...) of the
    # tile's own panel)
    npanel: int = 6
    panel_metric: bool = False
    sponge: Optional[torch.Tensor] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.fields.dtype

    @property
    def device(self) -> torch.device:
        return self.fields.device

    @property
    def state_shape(self):
        return (5, self.npanel, self.nel_v, self.nel_h, self.nel_h, self.s**3)

    @property
    def traces_shape(self):
        return (5, 4, self.npanel, self.nel_v, self.nel_h, self.s**2)


def _one_panel(a, scale=None) -> np.ndarray:
    """Panel 0 of a field that must be the same on all six panels, to 1e-10
    of its scale (the rounding of the metric build is ~5e-13)."""
    a = np.asarray(a, np.float64)
    tol = 1e-10 * max(np.abs(a).max() if scale is None else scale, 1e-300)
    if np.abs(a - a[:1]).max() > tol:
        raise ValueError("metric field differs across panels: a geometry with topography takes panel_metric=True")
    return a[0]


def has_topography(geom) -> bool:
    """Whether a 3D geometry has bottom topography (any non-zero ``zbot``):
    its operator then needs every panel's metric (``panel_metric``)."""
    return bool(np.any(np.asarray(geom.zbot) != 0.0))


def build_constants(ops, metric, nel_h: int, nel_v: int, dtype=torch.float64, device="cpu",
                    panel_metric: bool = False, damping=None) -> E3Constants:
    """Operator constants from the 3D DFR operators (``three_d=True``) and
    the 3D metric (host float64 numpy, cast once to ``dtype`` on ``device``).
    ``panel_metric`` keeps all six panels' metric (a geometry with
    topography, ``has_topography``); else the six must agree and one is
    kept. ``damping`` (DCMIP 21/22, with ``panel_metric``): the Rayleigh
    sponge's host planes ``mask``, ``u1ref``, ``u2ref``, ``u3ref``
    (``models.euler_cubesphere.RayleighDamping``)."""
    s = ops.num_solpts
    f64 = lambda a: np.asarray(a, np.float64)
    ops1d = np.concatenate([
        f64(ops.extrap_neg), f64(ops.extrap_pos), f64(ops.diff_ext[1:-1, 0]), f64(ops.diff_ext[1:-1, -1]),
        f64(ops.diff_solpt).reshape(-1), f64(ops.highfilter).reshape(-1),
    ])
    dx, dy, dz = f64(ops.derivative_x3), f64(ops.derivative_y3), f64(ops.derivative_z3)
    cx, cy, cz = f64(ops.correction_WE3), f64(ops.correction_SN3), f64(ops.correction_DU3)
    ss, s3 = s * s, s**3
    ccb = np.zeros((6 * ss, 3 * s3))
    for k, cm in enumerate((cx, cy, cz)):
        ccb[2 * ss * k : 2 * ss * (k + 1), s3 * k : s3 * (k + 1)] = cm

    sg, hc, ch = f64(metric.sqrtG), f64(metric.h_contra), f64(metric.christoffel)
    wpres = sum((sg * hc[d, 2]) @ m for d, m in enumerate((dx, dy, dz)))
    ch_scale = np.abs(ch[:, 3:]).max()
    panel = (lambda a, scale=None: f64(a)) if panel_metric else _one_panel
    fields = np.stack(
        [panel(metric.sqrtG), panel(metric.inv_sqrtG), panel(metric.inv_dzdeta)]
        + [panel(hc[a, b]) for a, b in H_PAIRS]
        + [panel(ch[a, 3 + j], scale=ch_scale) for a in range(3) for j in range(6)]
        + [panel(wpres)]
    )
    tch = ch[:, :3].reshape((9,) + sg.shape)
    tch = None if not np.any(tch) else tch

    def itf(sqrt_g, h_row):
        scale = np.abs(f64(h_row)).max()
        return np.stack([panel(sqrt_g)] + [panel(h_row[k], scale=scale) for k in range(3)])

    itf_x = itf(metric.sqrtG_itf_i, f64(metric.h_contra_itf_i)[0])
    itf_y = itf(metric.sqrtG_itf_j, f64(metric.h_contra_itf_j)[1])
    itf_z = itf(metric.sqrtG_itf_k, f64(metric.h_contra_itf_k)[2])

    sponge = None
    if damping is not None:
        if not panel_metric:
            raise ValueError("the Rayleigh sponge runs in the terrain kernels: build it with panel_metric=True")
        mask = f64(damping.mask)
        sponge = np.stack([mask] + [mask * f64(u) for u in (damping.u1ref, damping.u2ref, damping.u3ref)])

    t = lambda a: torch.as_tensor(np.array(a, dtype=np.float64, order="C"), dtype=dtype, device=device)
    return E3Constants(
        nel_h=nel_h, nel_v=nel_v, s=s, ops1d=t(ops1d),
        ee=t(np.concatenate([ops.extrap_x3, ops.extrap_y3, ops.extrap_z3], axis=1)),
        dd=t(np.concatenate([dx, dy, dz], axis=0)), dd3=t(np.concatenate([dx, dy, dz], axis=1)),
        cc=t(np.concatenate([cx, cy, cz], axis=0)), ccb=t(ccb), hfk=t(ops.highfilter_k),
        fields=t(fields), tch=None if tch is None else t(tch),
        itf_x=t(itf_x), itf_y=t(itf_y), itf_z=t(itf_z), panel_metric=panel_metric,
        sponge=None if sponge is None else t(sponge),
    )


def expand_panels(con: E3Constants) -> E3Constants:
    """One-panel constants in the per-panel layout, every panel a copy of
    the one: the terrain kernels on them compute what the kernels without
    terrain compute on ``con`` (checked bit for bit)."""
    if con.panel_metric or con.npanel != 6:
        raise ValueError("expand_panels takes whole-sphere constants with one panel's metric")
    rep = lambda t, axis: torch.stack([t] * 6, dim=axis).contiguous()
    return dataclasses.replace(con, fields=rep(con.fields, 1), itf_x=rep(con.itf_x, 1), itf_y=rep(con.itf_y, 1),
                               itf_z=rep(con.itf_z, 1), panel_metric=True)


# ---------------------------------------------------------------------------
# Halo glue (plain torch on either device; edge-sized work only)


def _log_rows(q: torch.Tensor) -> torch.Tensor:
    """rho and rho*theta (rows 0 and 4) in log space, the momenta and any
    tracer rows (5 and on) as they are."""
    return torch.cat([torch.log(q[0:1]), q[1:4], torch.log(q[4:5]), q[5:]])


def _exp_rows(t: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.exp(t[0:1]), t[1:4], torch.exp(t[4:5]), t[5:]])


def edge_traces(q: torch.Tensor, con: E3Constants) -> torch.Tensor:
    """Panel-edge face traces of a state of nv rows (5, or 5 plus the
    tracers of DCMIP 11/12), (nv, 4, 6, nk, nh, s^2) in (S, N, W, E) order —
    only the edge elements are extrapolated, rho and rho*theta in log
    space, every other row linearly."""
    ss, ee = con.s**2, con.ee
    south = _exp_rows(_log_rows(q[:, :, :, 0]) @ ee[:, 2 * ss : 3 * ss])
    north = _exp_rows(_log_rows(q[:, :, :, -1]) @ ee[:, 3 * ss : 4 * ss])
    west = _exp_rows(_log_rows(q[:, :, :, :, 0]) @ ee[:, :ss])
    east = _exp_rows(_log_rows(q[:, :, :, :, -1]) @ ee[:, ss : 2 * ss])
    return torch.stack([south, north, west, east], dim=1)


def edge_traces_tangent(q: torch.Tensor, v: torch.Tensor, con: E3Constants,
                        traces: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Panel-edge traces of the direction ``v`` at the state ``q`` (5 rows,
    or 5 plus the tracers of DCMIP 11/12): the derivative of
    ``edge_traces`` (the momenta and the tracers extrapolated linearly, rho
    and rho*theta as ``tr_q * (E.(v/q))``; ``traces``: q's own edge traces,
    computed when None). The counterpart of ``_tangent_pools``
    (pallas_euler3d.py:1950-1970)."""
    if traces is None:
        traces = edge_traces(q, con)
    ss, ee = con.s**2, con.ee
    lt = lambda sl: torch.cat([v[0:1][sl] / q[0:1][sl], v[1:4][sl], v[4:5][sl] / q[4:5][sl], v[5:][sl]])
    south = lt(np.s_[:, :, :, 0]) @ ee[:, 2 * ss : 3 * ss]
    north = lt(np.s_[:, :, :, -1]) @ ee[:, 3 * ss : 4 * ss]
    west = lt(np.s_[:, :, :, :, 0]) @ ee[:, :ss]
    east = lt(np.s_[:, :, :, :, -1]) @ ee[:, ss : 2 * ss]
    raw = torch.stack([south, north, west, east], dim=1)
    return torch.cat([traces[0:1] * raw[0:1], raw[1:4], traces[4:5] * raw[4:5], raw[5:]])


def halo_from_traces(traces: torch.Tensor, topology) -> torch.Tensor:
    """Outgoing traces -> halos (nv, 4, 6, nk, nh, s^2): for each (side,
    panel), the neighbour panel's facing trace in local edge ordering,
    rho*u1 and rho*u2 rotated into the local contravariant basis (the port
    of ``pallas_euler3d.halo_from_slabs``)."""
    return topology.halo_from_pool_3d(traces, (1, 2))


# ---------------------------------------------------------------------------
# Plain torch version


def pressure(rho_theta: torch.Tensor) -> torch.Tensor:
    return P0 * torch.exp(HEAT_CAPACITY_RATIO * torch.log((RD / P0) * rho_theta))


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with the forward-mode derivative +dx at x = 0 (and -0): the
    convention of ``jax.jvp`` (torch's ``abs`` has 0 there), so the Jacobian
    action agrees with the JAX package's wherever a normal speed is exactly
    zero, as w is at every z face of a state at rest. The value is x.abs()'s
    up to the sign of a zero, which is added to a positive sound speed."""
    return torch.where(x >= 0, x, -x)


def _rusanov(qL, qR, vL, vR, itf, d: int):
    """Rusanov flux at one family of interfaces (normal direction d) with
    the rho*w advection/pressure split (reference pde/fluxes.py
    rusanov_3d_*_new; the JAX package's _euler3d_rhs_core step 5). Returns
    (flux (5, ...), w advection flux, w pressure flux, pL, pR)."""
    sg, h0, h1, h2 = itf
    hd = itf[1 + d]
    pL, pR = pressure(qL[4]), pressure(qR[4])
    eig = torch.maximum(
        _abs(vL) + torch.sqrt(hd * HEAT_CAPACITY_RATIO * pL / qL[0]),
        _abs(vR) + torch.sqrt(hd * HEAT_CAPACITY_RATIO * pR / qR[0]),
    )
    flux_l = sg * vL * qL
    flux_r = sg * vR * qR
    wadv = 0.5 * (flux_l[3] + flux_r[3] - eig * sg * (qR[3] - qL[3]))
    press = lambda p: torch.stack([torch.zeros_like(p), sg * h0 * p, sg * h1 * p, sg * h2 * p, torch.zeros_like(p)])
    f = 0.5 * ((flux_l + press(pL)) + (flux_r + press(pR)) - eig * sg * (qR - qL))
    wpres = 0.5 * (sg * h2 * pL + sg * h2 * pR)
    return f, wadv, wpres, pL, pR


def _faces(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Per-interface (..., n+1 along dim, ..., s^2) -> each element's
    [negative face | positive face] (..., n, ..., 2s^2)."""
    n = a.shape[dim] - 1
    return torch.cat([a.narrow(dim, 0, n), a.narrow(dim, 1, n)], dim=-1)


# The interface families: (normal direction, interface axis of a (5, ...) state-shaped array).
_FAMILIES = ((0, -2), (1, -3), (2, -4))


def _lr_states(itf: torch.Tensor, halo: torch.Tensor):
    """Per-family (qL, qR) interface states from every element's face traces
    ``itf`` (..., 6 s^2: W E S N D U) and the halos; the ground and the lid
    mirror the element's own trace (west/south/down side left)."""
    ss = itf.shape[-1] // 6
    west, east = itf[..., :ss], itf[..., ss : 2 * ss]
    south, north = itf[..., 2 * ss : 3 * ss], itf[..., 3 * ss : 4 * ss]
    bot, top = itf[..., 4 * ss : 5 * ss], itf[..., 5 * ss :]
    hs, hn, hw, he = halo[:, 0], halo[:, 1], halo[:, 2], halo[:, 3]
    return (
        (torch.cat([hw.unsqueeze(-2), east], dim=-2), torch.cat([west, he.unsqueeze(-2)], dim=-2)),
        (torch.cat([hs.unsqueeze(-3), north], dim=-3), torch.cat([south, hn.unsqueeze(-3)], dim=-3)),
        (torch.cat([bot[:, :, 0:1], top], dim=2), torch.cat([bot, top[:, :, -1:]], dim=2)),
    )


def _normal_speeds(qL: torch.Tensor, qR: torch.Tensor, d: int):
    """(vL, vR) normal speeds of family d; w is odd across the ground (the
    first z interface's left side) and the lid (the last one's right side)."""
    vL, vR = qL[1 + d] / qL[0], qR[1 + d] / qR[0]
    if d == 2:
        vL = torch.cat([-vL[:, 0:1], vL[:, 1:]], dim=1)
        vR = torch.cat([vR[:, :-1], -vR[:, -1:]], dim=1)
    return vL, vR


def _itf_metric(con: "E3Constants", d: int):
    return (con.itf_x, con.itf_y, con.itf_z)[d]


def _own_faces(pL: torch.Tensor, pR: torch.Tensor, dim: int):
    """(negative-face, positive-face) values of the element's own side:
    the right state of its negative interface, the left of its positive."""
    n = pL.shape[dim] - 1
    return pR.narrow(dim, 0, n), pL.narrow(dim, 1, n)


def euler3d_operator_plain(q, halo, con: E3Constants, x=None, a: float = 0.0, b: float = 1.0,
                           cdt: Optional[float] = None, bal=None, emit_traces: bool = False):
    """Plain torch version of the operator; same arguments and results as
    ``euler3d_operator`` (written from the JAX package's
    models/euler_cubesphere.py:90-291, dense 3D operators). Counted in
    ``plain_calls``."""
    global plain_calls
    plain_calls += 1
    s3 = con.s**3
    fld = con.fields
    sqrtg, invsg, invdz = fld[0], fld[1], fld[2]
    h = {}
    for i, (r, c) in enumerate(H_PAIRS):
        h[(r, c)] = h[(c, r)] = fld[3 + i]
    chs = fld[3 + len(H_PAIRS) : 3 + len(H_PAIRS) + 18]
    wpres_int = fld[-1]

    rho = q[0]
    u = (q[1] / rho, q[2] / rho, q[3] / rho)

    # 1. Log-space extrapolation to the six faces of every element.
    itf = _exp_rows(_log_rows(q) @ con.ee)

    # 2. Pointwise fluxes and interior derivatives.
    p = pressure(q[4])
    logp = torch.log(p)
    sgp = sqrtg * p
    bundles = []
    for d in range(3):
        flux = sqrtg * u[d] * q
        wadv = flux[3]
        press = torch.stack([torch.zeros_like(sgp)] + [sgp * h[(d, k)] for k in range(3)] + [torch.zeros_like(sgp)])
        bundles.append(torch.cat([flux + press, wadv[None]]))
    interior = torch.cat(bundles, dim=-1) @ con.dd
    dlogp = logp @ con.dd3

    # 3. Interface left/right states; ground and lid mirror the state, w odd.
    lr = _lr_states(itf, halo)
    fam = {d: _rusanov(*lr[d], *_normal_speeds(*lr[d], d), _itf_metric(con, d), d) for d, _ in _FAMILIES}

    # 4. Boundary corrections: the element's own-side face pressures divide
    # the w-pressure flux and give the face log p.
    bund, lpf = [], []
    for d, dim in _FAMILIES:
        f, wadv, wpres, pL, pR = fam[d]
        n = pL.shape[dim] - 1
        p_neg, p_pos = _own_faces(pL, pR, dim)
        wp = torch.cat([wpres.narrow(dim, 0, n) / p_neg, wpres.narrow(dim, 1, n) / p_pos], dim=-1)
        bund.append(torch.cat([_faces(f, dim), _faces(wadv, dim)[None], wp[None]]))
        lpf.append(torch.cat([torch.log(p_neg), torch.log(p_pos)], dim=-1))
    corr = torch.cat(bund, dim=-1) @ con.cc
    dlp = dlogp + torch.cat(lpf, dim=-1) @ con.ccb

    df = interior[:5] + corr[:5]
    w_df = (
        interior[5] + corr[5] + (wpres_int + corr[6]) * p
        + p * (sqrtg * h[(0, 2)] * dlp[..., :s3] + sqrtg * h[(1, 2)] * dlp[..., s3 : 2 * s3]
               + sqrtg * h[(2, 2)] * dlp[..., 2 * s3 :])
    )
    out = -invsg * df
    out[3] = -invsg * w_df

    # 5. Christoffel/Coriolis forcing and filtered gravity.
    def forcing_row(a_):
        ch = chs[6 * a_ : 6 * a_ + 6]
        f = ch[0] * (rho * u[0] * u[0] + h[(0, 0)] * p)
        if con.tch is not None:  # time Christoffels (Coriolis) of a rotating planet
            t = con.tch[3 * a_ : 3 * a_ + 3]
            f = 2.0 * rho * (t[0] * u[0] + t[1] * u[1] + t[2] * u[2]) + f
        return (f
                + 2.0 * ch[1] * (rho * u[0] * u[1] + h[(0, 1)] * p)
                + 2.0 * ch[2] * (rho * u[0] * u[2] + h[(0, 2)] * p)
                + ch[3] * (rho * u[1] * u[1] + h[(1, 1)] * p)
                + 2.0 * ch[4] * (rho * u[1] * u[2] + h[(1, 2)] * p)
                + ch[5] * (rho * u[2] * u[2] + h[(2, 2)] * p))

    gravity = invdz * GRAVITY * invsg * ((sqrtg * rho) @ con.hfk)
    out[1:4] -= _with_sponge([forcing_row(0), forcing_row(1), forcing_row(2) + gravity], q, con)

    if bal is not None:
        out = out + bal
    out = _stage(out, q, x, a, b, cdt)
    if emit_traces:
        return out, edge_traces(out, con)
    return out


def _with_sponge(rows, q, con: E3Constants) -> torch.Tensor:
    """The momentum forcing rows (rho*u1, rho*u2, rho*w) plus the Rayleigh
    sponge ``mask q[1+i] - q[0] (mask u_ref_i)`` where the constants have
    one (linear in q, so the tangent's is the same in the direction)."""
    if con.sponge is not None:
        sp = con.sponge
        rows = [r + (sp[0] * q[1 + i] - q[0] * sp[1 + i]) for i, r in enumerate(rows)]
    return torch.stack(rows)


def _stage(out, q, x, a: float, b: float, cdt: Optional[float]):
    """The RK stage combination ``a*x + b*q + cdt*out`` of the plain
    versions (``x`` read only when ``a != 0``); ``out`` itself in RHS mode
    (``cdt is None``)."""
    if cdt is None:
        return out
    out = b * q + cdt * out
    return a * x + out if a != 0.0 else out


# ---------------------------------------------------------------------------
# Perturbation form: base state, delta glue, plain version


@dataclass(frozen=True)
class E3PertBase:
    """The base state of the perturbation form and what every call around
    it shares (the counterpart of ``E3PertBase``/``build_pert_base``,
    pallas_euler3d.py:1847-1896, and of ``_euler3d_base_intermediates``,
    models/euler_cubesphere.py:294-354, in the model layout), computed in
    float64 once and cast to the working dtype. The kernel reads ``q0``,
    ``rhs0``, ``halo0`` and (for the delta traces it emits) ``traces0``;
    the glue ``traces0``; the plain version the rest."""

    q0: torch.Tensor  # (5, 6, nk, ny, nx, s^3) base state
    rhs0: torch.Tensor  # its float64 RHS
    traces0: torch.Tensor  # (5, 4, 6, nk, nh, s^2) its outward panel-edge traces
    halo0: torch.Tensor  # its halo
    itf0: torch.Tensor  # (5, 6, nk, ny, nx, 6 s^2) its face traces
    u0: torch.Tensor  # (3, ...) its velocities
    p0: torch.Tensor  # its pressure
    dlp0: torch.Tensor  # (..., 3 s^3) its log-pressure gradient with the face corrections
    wcorr0: torch.Tensor  # (..., s^3) the boundary correction of its w-pressure flux / p

    @property
    def tensors(self):
        return {"q0": self.q0, "rhs0": self.rhs0, "halo0": self.halo0, "traces0": self.traces0}


def build_pert_base(q0: torch.Tensor, con64: E3Constants, topology, dtype) -> E3PertBase:
    """The perturbation base around ``q0`` from float64 constants on the
    device that will run the operator; the base RHS comes from
    ``euler3d_operator`` (the kernel on a GPU, the plain version on the
    CPU). All results are cast to ``dtype``."""
    if con64.dtype != torch.float64:
        raise ValueError("the perturbation base is built from float64 constants")
    q0 = q0.to(device=con64.device, dtype=torch.float64).contiguous()
    traces0 = edge_traces(q0, con64)
    halo0 = halo_from_traces(traces0, topology)
    rhs0 = euler3d_operator(q0, halo0, con64)
    itf0 = _exp_rows(_log_rows(q0) @ con64.ee)
    p0 = pressure(q0[4])
    lr = _lr_states(itf0, halo0)
    lpf, wpf = [], []
    for d, dim in _FAMILIES:
        qL, qR = lr[d]
        sg, _, _, h2 = _itf_metric(con64, d)
        pL, pR = pressure(qL[4]), pressure(qR[4])
        wp = 0.5 * sg * h2 * (pL + pR)
        p_neg, p_pos = _own_faces(pL, pR, dim)
        w_neg, w_pos = _own_faces(wp, wp, dim)
        lpf.append(torch.cat([torch.log(p_neg), torch.log(p_pos)], dim=-1))
        wpf.append(torch.cat([w_neg / p_neg, w_pos / p_pos], dim=-1))
    dlp0 = torch.log(p0) @ con64.dd3 + torch.cat(lpf, dim=-1) @ con64.ccb
    wcorr0 = torch.cat(wpf, dim=-1) @ con64.cc
    cast = lambda t: t.to(dtype).contiguous()
    return E3PertBase(q0=cast(q0), rhs0=cast(rhs0), traces0=cast(traces0), halo0=cast(halo0), itf0=cast(itf0),
                      u0=cast(q0[1:4] / q0[0]), p0=cast(p0), dlp0=cast(dlp0), wcorr0=cast(wcorr0))


def _refuse_pert_sponge(con: E3Constants):
    if con.sponge is not None:
        raise ValueError("the perturbation form takes no Rayleigh sponge (the JAX package's refuses extra_forcing, "
                         "models/euler_cubesphere.py:679 there)")


def edge_traces_delta(dq: torch.Tensor, pert: E3PertBase, con: E3Constants) -> torch.Tensor:
    """Panel-edge traces of the perturbation ``dq`` (5, 4, 6, nk, nh, s^2):
    the momenta extrapolated linearly, rho and rho*theta as
    ``t0 * expm1(E.log1p(dq/q0))`` around the base traces ``t0`` (the
    counterpart of ``_delta_pools``, pallas_euler3d.py:1898-1917)."""
    ss, ee, q0 = con.s**2, con.ee, pert.q0
    ld = lambda sl: torch.cat([torch.log1p(dq[0:1][sl] / q0[0:1][sl]), dq[1:4][sl],
                               torch.log1p(dq[4:5][sl] / q0[4:5][sl])])
    raw = torch.stack([
        ld(np.s_[:, :, :, 0]) @ ee[:, 2 * ss : 3 * ss],
        ld(np.s_[:, :, :, -1]) @ ee[:, 3 * ss : 4 * ss],
        ld(np.s_[:, :, :, :, 0]) @ ee[:, :ss],
        ld(np.s_[:, :, :, :, -1]) @ ee[:, ss : 2 * ss],
    ], dim=1)
    t0 = pert.traces0
    return torch.cat([t0[0:1] * torch.expm1(raw[0:1]), raw[1:4], t0[4:5] * torch.expm1(raw[4:5])])


def euler3d_operator_pert_plain(dq, halo, con: E3Constants, pert: E3PertBase, x=None, a: float = 0.0,
                                b: float = 1.0, cdt: Optional[float] = None, emit_traces: bool = False):
    """Plain torch version of the perturbation mode: ``rhs0 + [RHS(q0 +
    dq) - RHS(q0)]`` with the bracket expanded term by term around the base
    (the JAX package's ``_euler3d_rhs_core_pert`` with ``delta_input``,
    models/euler_cubesphere.py:357-623). ``halo`` is the halo of
    ``edge_traces_delta(dq)``. Stage mode (``cdt``) returns ``a*x + b*dq +
    cdt*(rhs0 + delta)`` on perturbations (``_km3_body``'s epilogue,
    pallas_euler3d.py:1568-1578); ``emit_traces`` adds the output's delta
    traces ``edge_traces_delta(out)``. The JAX package writes
    ``log1p``/``expm1`` as compensated formulas (pallas_euler3d.py:726-736,
    Mosaic lacks them); torch has them, which moves results by ~1 ulp of
    the small arguments, far below every tolerance the tests state.
    Counted in ``plain_calls``."""
    global plain_calls
    _refuse_pert_sponge(con)
    plain_calls += 1
    s3 = con.s**3
    fld = con.fields
    sqrtg, invsg, invdz = fld[0], fld[1], fld[2]
    h = {}
    for i, (r, c) in enumerate(H_PAIRS):
        h[(r, c)] = h[(c, r)] = fld[3 + i]
    chs = fld[3 + len(H_PAIRS) : 3 + len(H_PAIRS) + 18]
    wpres_int = fld[-1]
    gam = HEAT_CAPACITY_RATIO

    q0, u0, p0 = pert.q0, pert.u0, pert.p0
    q = q0 + dq
    rho, rho0 = q[0], q0[0]
    du = (dq[1:4] - u0 * dq[0]) / rho

    # 1. Delta face traces: linear for the momenta, t0 * expm1(E.log1p(d/q0)) for the log rows.
    dlog_rho, dlog_rt = torch.log1p(dq[0] / rho0), torch.log1p(dq[4] / q0[4])
    raw = torch.cat([dlog_rho[None], dq[1:4], dlog_rt[None]]) @ con.ee
    itf0 = pert.itf0
    ditf = torch.cat([itf0[0:1] * torch.expm1(raw[0:1]), raw[1:4], itf0[4:5] * torch.expm1(raw[4:5])])

    # 2. Pointwise flux differences and interior derivatives of the deltas.
    dp = p0 * torch.expm1(gam * dlog_rt)
    p = p0 + dp
    dlogp = torch.log1p(dp / p0)
    bundles = []
    for d in range(3):
        dflux = sqrtg * (u0[d] * dq + du[d] * q)
        dwadv = dflux[3]
        press = torch.stack([torch.zeros_like(dp)] + [sqrtg * dp * h[(d, k)] for k in range(3)]
                            + [torch.zeros_like(dp)])
        bundles.append(torch.cat([dflux + press, dwadv[None]]))
    interior = torch.cat(bundles, dim=-1) @ con.dd
    ddlogp = dlogp @ con.dd3

    # 3. Interface states: base and delta; delta Rusanov fluxes.
    lr0, lrd = _lr_states(itf0, pert.halo0), _lr_states(ditf, halo)
    bund, dlpf = [], []
    for d, dim in _FAMILIES:
        (L0, R0), (dL, dR) = lr0[d], lrd[d]
        qL, qR = L0 + dL, R0 + dR
        sg, h0, h1, h2 = _itf_metric(con, d)
        hd = (h0, h1, h2)[d]
        vL0, vR0 = _normal_speeds(L0, R0, d)
        vL, vR = _normal_speeds(qL, qR, d)
        dvL, dvR = vL - vL0, vR - vR0
        pL0, pR0 = pressure(L0[4]), pressure(R0[4])
        dpL = pL0 * torch.expm1(gam * torch.log1p(dL[4] / L0[4]))
        dpR = pR0 * torch.expm1(gam * torch.log1p(dR[4] / R0[4]))
        eig = torch.maximum(_abs(vL) + torch.sqrt(hd * gam * (pL0 + dpL) / qL[0]),
                            _abs(vR) + torch.sqrt(hd * gam * (pR0 + dpR) / qR[0]))
        eig0 = torch.maximum(_abs(vL0) + torch.sqrt(hd * gam * pL0 / L0[0]),
                             _abs(vR0) + torch.sqrt(hd * gam * pR0 / R0[0]))
        deig = eig - eig0
        dfl = sg * (vL0 * dL + dvL * qL)
        dfr = sg * (vR0 * dR + dvR * qR)
        diss = sg * (eig * (dR - dL) + deig * (R0 - L0))
        dwadv = 0.5 * (dfl[3] + dfr[3] - diss[3])
        press = lambda x: torch.stack([torch.zeros_like(x), sg * h0 * x, sg * h1 * x, sg * h2 * x,
                                       torch.zeros_like(x)])
        df = 0.5 * ((dfl + press(dpL)) + (dfr + press(dpR)) - diss)
        wpres0 = 0.5 * sg * h2 * (pL0 + pR0)
        dwpres = 0.5 * sg * h2 * (dpL + dpR)

        # 4. Corrections on deltas; d[wpres/p] = dwpres/p - (wpres0/p0)(dp/p).
        p0n, p0p = _own_faces(pL0, pR0, dim)
        dpn, dpp = _own_faces(dpL, dpR, dim)
        w0n, w0p = _own_faces(wpres0, wpres0, dim)
        dwn, dwp_ = _own_faces(dwpres, dwpres, dim)
        pn, pp = p0n + dpn, p0p + dpp
        dwp = torch.cat([dwn / pn - (w0n / p0n) * (dpn / pn), dwp_ / pp - (w0p / p0p) * (dpp / pp)], dim=-1)
        bund.append(torch.cat([_faces(df, dim), _faces(dwadv, dim)[None], dwp[None]]))
        dlpf.append(torch.cat([torch.log1p(dpn / p0n), torch.log1p(dpp / p0p)], dim=-1))
    corr = torch.cat(bund, dim=-1) @ con.cc
    ddlp = ddlogp + torch.cat(dlpf, dim=-1) @ con.ccb
    dlp = pert.dlp0 + ddlp

    # 5. The w pressure split: d[(W + c) p] = (W + c0) dp + dc p, d[p dlp] = p0 ddlp + dp dlp.
    dw_df = interior[5] + corr[5] + (wpres_int + pert.wcorr0) * dp + corr[6] * p
    for k in range(3):
        sl = slice(k * s3, (k + 1) * s3)
        dw_df = dw_df + sqrtg * h[(k, 2)] * (p0 * ddlp[..., sl] + dp * dlp[..., sl])
    out = -invsg * (interior[:5] + corr[:5])
    out[3] = -invsg * dw_df

    # 6. Forcing deltas: the quadratic terms by the product rule with
    # absolute second factors, the Coriolis term and gravity are linear.
    def dprod(i, j):
        return (dq[i] * q0[j] + q[i] * dq[j]) / rho - (q0[i] * q0[j] / rho0) * (dq[0] / rho)

    def dforcing_row(a_):
        ch = chs[6 * a_ : 6 * a_ + 6]
        f = (ch[0] * (dprod(1, 1) + h[(0, 0)] * dp)
             + 2.0 * ch[1] * (dprod(1, 2) + h[(0, 1)] * dp)
             + 2.0 * ch[2] * (dprod(1, 3) + h[(0, 2)] * dp)
             + ch[3] * (dprod(2, 2) + h[(1, 1)] * dp)
             + 2.0 * ch[4] * (dprod(2, 3) + h[(1, 2)] * dp)
             + ch[5] * (dprod(3, 3) + h[(2, 2)] * dp))
        if con.tch is not None:
            t = con.tch[3 * a_ : 3 * a_ + 3]
            f = 2.0 * (t[0] * dq[1] + t[1] * dq[2] + t[2] * dq[3]) + f
        return f

    dgrav = invdz * GRAVITY * invsg * ((sqrtg * dq[0]) @ con.hfk)
    out[1] -= dforcing_row(0)
    out[2] -= dforcing_row(1)
    out[3] -= dforcing_row(2) + dgrav
    out = _stage(pert.rhs0 + out, dq, x, a, b, cdt)
    if emit_traces:
        return out, edge_traces_delta(out, pert, con)
    return out


def euler3d_tangent_pert_plain(dq, v, halo_dq, halo_v, con: E3Constants, pert: E3PertBase):
    """Plain torch version of the perturbation tangent mode: J(q0 + dq).v as
    ``torch.func.jvp`` of ``euler3d_operator_pert_plain`` at (dq, halo_dq)
    in the direction (v, halo_v) (``halo_v`` from ``edge_traces_tangent``
    at the absolute state and traces). Counted in ``plain_tangent_calls``."""
    global plain_tangent_calls
    plain_tangent_calls += 1
    _, out = torch.func.jvp(lambda d_, h_: euler3d_operator_pert_plain(d_, h_, con, pert), (dq, halo_dq),
                            (v, halo_v))
    return out


# ---------------------------------------------------------------------------
# Kernel wrapper


def _check_tensors(con: E3Constants, tensors: dict):
    """Shape, dtype, device and contiguity of {name: (tensor, shape)}."""
    for name, (t, shape) in tensors.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if t.dtype != con.dtype or t.device != con.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; constants are {con.dtype} on {con.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _check(q, halo, con: E3Constants, x, a: float, bal, cdt, emit_traces: bool, pert):
    """Shape, dtype, device and contiguity of the tensors the operator reads."""
    tensors = {"q": (q, con.state_shape), "halo": (halo, con.traces_shape)}
    if a != 0.0:
        if x is None:
            raise ValueError("stage with a != 0 needs x")
        tensors["x"] = (x, con.state_shape)
    if bal is not None:
        tensors["bal"] = (bal, con.state_shape)
    if pert is not None:
        if bal is not None:
            raise ValueError("the perturbation form takes no well-balanced offset bal (its base RHS is rhs0)")
        _refuse_pert_sponge(con)
        tensors.update(_pert_tensors(con, pert))
    _check_tensors(con, tensors)


def _pert_tensors(con: E3Constants, pert: E3PertBase) -> dict:
    shapes = {"q0": con.state_shape, "rhs0": con.state_shape, "halo0": con.traces_shape,
              "traces0": con.traces_shape}
    return {name: (t, shapes[name]) for name, t in pert.tensors.items()}


def _check_kernel_shape(con: E3Constants, name: str):
    if con.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name} takes float32 or float64, not {con.dtype}")
    min_nel = 2 if con.npanel == 6 else 1
    if not (2 <= con.s <= 6) or con.nel_h < min_nel:
        raise ValueError(f"{name} takes 2 <= s <= 6 and nel_h >= {min_nel}, not s={con.s}, nel_h={con.nel_h}")


def _check_npanel(con: E3Constants, npanel: int, name: str):
    if con.npanel != npanel:
        what = "whole-sphere" if npanel == 6 else "tile"
        raise ValueError(f"{name} takes {what} constants (npanel={npanel}), not npanel={con.npanel}")


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def euler3d_operator(q, halo, con: E3Constants, x=None, a: float = 0.0, b: float = 1.0,
                     cdt: Optional[float] = None, bal=None, emit_traces: bool = False,
                     pert: Optional[E3PertBase] = None):
    """The 3D Euler operator on ``q`` (5, 6, nk, ny, nx, s^3) with neighbour
    halos ``halo`` (5, 4, 6, nk, nh, s^2).

    RHS mode (``cdt is None``): returns RHS(q) (+ ``bal`` when given).
    Stage mode: returns ``a*x + b*q + cdt*(RHS(q) + bal)`` (``x`` is read
    only when ``a != 0``). With ``emit_traces`` also returns the output's
    panel-edge traces (5, 4, 6, nk, nh, s^2). With ``pert`` (no ``bal``)
    ``q`` is the perturbation dq around ``pert.q0`` and ``halo`` the halo of
    its delta traces (``edge_traces_delta``): returns RHS(q0 + dq) as
    ``rhs0 + delta``; in stage mode ``x`` and the output are perturbations
    too, and the traces the output's delta traces. Perturbation launches
    count in ``pert_stage_launches`` in stage mode, else in
    ``pert_launches``.

    A CPU tensor runs ``euler3d_operator_plain`` (``euler3d_operator_pert_plain``);
    a CUDA tensor makes one launch of the operator, its interface pass and
    volume pass (csrc/euler3d_operator.cu, built at first use), on the
    current stream, without synchronising, or raises. Constants with a
    per-panel metric launch the terrain instantiation (with the sponge
    when they have one), counted in ``terrain_launches`` or, in
    perturbation form, ``terrain_pert_launches``."""
    global launches, pert_launches, pert_stage_launches, terrain_launches, terrain_pert_launches
    _check_npanel(con, 6, "euler3d_operator")
    _check(q, halo, con, x, a, bal, cdt, emit_traces, pert)
    if q.device.type == "cpu":
        if pert is not None:
            return euler3d_operator_pert_plain(q, halo, con, pert, x=x, a=a, b=b, cdt=cdt, emit_traces=emit_traces)
        return euler3d_operator_plain(q, halo, con, x=x, a=a, b=b, cdt=cdt, bal=bal, emit_traces=emit_traces)
    if con.panel_metric:
        out = _launch_operator("euler3d_operator_terrain_launch", q, halo, con, x, a, b, cdt, bal, emit_traces, pert,
                               terrain=True)
        if pert is None:
            terrain_launches += 1
        else:
            terrain_pert_launches += 1
        return out
    out = _launch_operator("euler3d_operator_launch", q, halo, con, x, a, b, cdt, bal, emit_traces, pert)
    if pert is None:
        launches += 1
    elif cdt is not None:
        pert_stage_launches += 1
    else:
        pert_launches += 1
    return out


def _launch_operator(entry: str, q, halo, con: E3Constants, x, a: float, b: float, cdt: Optional[float], bal,
                     emit_traces: bool, pert: Optional[E3PertBase], terrain: bool = False):
    """One launch of the operator kernel through the C entry ``entry``
    (``euler3d_operator_launch`` or ``euler3d_tile_launch``; with
    ``terrain``, ``euler3d_operator_terrain_launch``, which also takes the
    sponge) on the current stream."""
    if q.device.type != "cuda":
        raise ValueError(f"{entry} runs on cpu or cuda tensors, not {q.device}")
    _check_kernel_shape(con, entry)

    from ..kernels.build import load_library

    lib = load_library("euler3d_terrain" if terrain else "euler3d_operator")
    use_x = cdt is not None and a != 0.0
    out = torch.empty_like(q)
    traces = torch.empty(con.traces_shape, dtype=q.dtype, device=q.device) if emit_traces else None
    base = pert.tensors if pert is not None else {}
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, entry)(
            1 if q.dtype == torch.float64 else 0, con.s, con.nel_h, con.nel_v,
            _ptr(q), _ptr(halo), _ptr(con.ops1d), _ptr(con.fields), _ptr(con.tch),
            _ptr(con.itf_x), _ptr(con.itf_y), _ptr(con.itf_z), _ptr(x if use_x else None), _ptr(bal),
            _ptr(base.get("q0")), _ptr(base.get("halo0")), _ptr(base.get("rhs0")), _ptr(base.get("traces0")),
            _ptr(out), _ptr(traces), float(a), float(b), float(cdt if cdt is not None else 0.0),
            1 if cdt is not None else 0, *((_ptr(con.sponge),) if terrain else ()), ctypes.c_void_p(stream),
        )
    if rc != 0:
        name = lib.euler3d_operator_error_string(rc).decode()
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc} ({name})")
    return (out, traces) if emit_traces else out


# ---------------------------------------------------------------------------
# The operator's plan: csrc/euler3d_operator.cu's interface pass (one thread
# an interface point) and the interface rows the volume pass reads
# (ItfLayout), mirrored for the CPU test of the plan and for reports.

# Threads a block of the interface pass (kItfThreads).
OPERATOR_INTERFACE_THREADS = 128


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def operator_plan(nel_h: int, nel_v: int, s: int, npanel: int = 6) -> dict:
    """The launch geometry of the operator's two kernels: the blocks of the
    interface pass (one thread an interface point) and of the volume pass
    (EB = 256 / s^3 elements a block), the interface points, and the words
    of interface rows a call keeps between them (absolute form: 9 a point;
    perturbation form: 13)."""
    eb = max(256 // s**3, 1)
    points = npanel * (2 * nel_v * nel_h * (nel_h + 1) + (nel_v + 1) * nel_h * nel_h) * s * s
    return {"interface_blocks": _ceil_div(points, OPERATOR_INTERFACE_THREADS),
            "volume_blocks": npanel * _ceil_div(nel_v * nel_h * nel_h, eb), "points": points,
            "rows_words": 9 * points, "rows_words_pert": 13 * points}


def interface_point(itf, nel_h: int, nel_v: int, s: int, npanel: int = 6) -> int:
    """The index, among every interface point's rows, of face point 0 of the
    interface ``itf`` = (d, panel, k, ey, ex) (the interface between
    elements ex-1 and ex for d = 0, ey-1 and ey for d = 1, levels k-1 and k
    for d = 2): its family's offset (x, y, z) plus its place in the family,
    as the kernels' ItfLayout has it; the volume pass reads an element's
    faces there."""
    d, p, k, y, x = itf
    s2, nh, nk = s * s, nel_h, nel_v
    nx = npanel * nk * nh * (nh + 1) * s2
    if d == 0:
        return (((p * nk + k) * nh + y) * (nh + 1) + x) * s2
    if d == 1:
        return nx + (((p * nk + k) * (nh + 1) + y) * nh + x) * s2
    return 2 * nx + (((p * (nk + 1) + k) * nh + y) * nh + x) * s2


def interface_of_thread(i: int, nel_h: int, nel_v: int, s: int, npanel: int = 6):
    """(interface, face point, sides) that thread ``i`` of the interface
    pass computes, as the kernel decodes it: ``sides`` the source of the L
    and R traces ("device": the element's state in device memory, "halo",
    "mirror")."""
    s2, nh, nk = s * s, nel_h, nel_v
    nx = npanel * nk * nh * (nh + 1) * s2
    d = 0
    if i >= nx:
        i, d = i - nx, 1
        if i >= nx:
            i, d = i - nx, 2
    k, t = i % s2, i // s2
    if d == 0:
        x, t = t % (nh + 1), t // (nh + 1)
        y, t = t % nh, t // nh
        kz, p = t % nk, t // nk
        sides = ("halo" if x == 0 else "device", "halo" if x == nh else "device")
    elif d == 1:
        x, t = t % nh, t // nh
        y, t = t % (nh + 1), t // (nh + 1)
        kz, p = t % nk, t // nk
        sides = ("halo" if y == 0 else "device", "halo" if y == nh else "device")
    else:
        x, t = t % nh, t // nh
        y, t = t % nh, t // nh
        kz, p = t % (nk + 1), t // (nk + 1)
        sides = ("mirror" if kz == 0 else "device", "mirror" if kz == nk else "device")
    return (d, p, kz, y, x), k, sides


# ---------------------------------------------------------------------------
# One tile of the cubed sphere (the port of pallas_euler3d.km3_tile)


def tile_constants(con: E3Constants, ey0: int, ex0: int, nt: int, panel: int) -> E3Constants:
    """The constants of the nt x nt tile of columns at element (ey0, ex0) of
    ``panel`` from the whole-sphere constants ``con`` (the JAX package's
    ``_TileMetric3DView``, parallel/shard_map_euler3d_fused.py:39-63, and
    the tile's ``tch`` block): the one-panel metric holds on every panel, so
    its tile slice serves every panel's tile; a per-panel metric (terrain)
    gives each tile its own panel's slice, in the one-panel layout (so the
    tile launch reads it as it reads a one-panel metric); the time
    Christoffels of a rotating planet depend on the panel and are sliced
    from the tile's own panel; the interface metric keeps the tile's nt+1
    interfaces each way. The sponge has no tile step (ROADMAP queue 1,
    item 14)."""
    _check_npanel(con, 6, "tile_constants")
    if con.sponge is not None:
        raise NotImplementedError("the tile step with the Rayleigh sponge (DCMIP 21/22) is not ported "
                                  "(ROADMAP queue 1, item 14)")
    ys, xs = slice(ey0, ey0 + nt), slice(ex0, ex0 + nt)
    c = lambda t: t.contiguous()
    own = (lambda t: t[:, panel]) if con.panel_metric else (lambda t: t)
    return E3Constants(
        nel_h=nt, nel_v=con.nel_v, s=con.s, ops1d=con.ops1d, ee=con.ee, dd=con.dd, dd3=con.dd3, cc=con.cc,
        ccb=con.ccb, hfk=con.hfk, fields=c(own(con.fields)[:, :, ys, xs]),
        tch=None if con.tch is None else c(con.tch[:, panel : panel + 1, :, ys, xs]),
        itf_x=c(own(con.itf_x)[:, :, ys, ex0 : ex0 + nt + 1]), itf_y=c(own(con.itf_y)[:, :, ey0 : ey0 + nt + 1, xs]),
        itf_z=c(own(con.itf_z)[:, :, ys, xs]), npanel=1,
    )


def build_tile_constants(ops, metric, ey0: int, ex0: int, nt: int, panel: int, dtype=torch.float64,
                         device="cpu") -> E3Constants:
    """``tile_constants`` from the 3D DFR operators and the 3D metric."""
    shape = np.asarray(metric.sqrtG).shape
    con = build_constants(ops, metric, shape[-2], shape[-4], dtype=dtype, device=device)
    return tile_constants(con, ey0, ex0, nt, panel)


def tile_pert_base(base64: E3PertBase, ey0: int, ex0: int, nt: int, panel: int, dtype) -> E3PertBase:
    """The perturbation base of one tile from the whole-sphere float64 base
    (the JAX package's per-tile base, shard_map_euler3d_fused.py:260-306):
    the tile's slices of every node and face field, its own outward float64
    base traces on its four edges (around which it emits its delta traces),
    and a base halo whose interior tile edges read the neighbour element's
    float64 base trace and whose panel edges read the exchanged and rotated
    float64 base halo; all cast to ``dtype``."""
    if base64.q0.dtype != torch.float64:
        raise ValueError("tile bases are sliced from a float64 base")
    nel, ss = base64.q0.shape[3], base64.halo0.shape[-1]
    ys, xs = slice(ey0, ey0 + nt), slice(ex0, ex0 + nt)
    node = lambda t: t[:, panel : panel + 1, :, ys, xs]
    face = lambda ey, ex, f: base64.itf0[:, panel, :, ey, ex, f * ss : (f + 1) * ss]
    # The tile's own outward traces (S, N, W, E): its edge elements' faces.
    own = [face(ey0, xs, 2), face(ey0 + nt - 1, xs, 3), face(ys, ex0, 0), face(ys, ex0 + nt - 1, 1)]
    halo = [
        base64.halo0[:, 0, panel, :, xs] if ey0 == 0 else face(ey0 - 1, xs, 3),
        base64.halo0[:, 1, panel, :, xs] if ey0 + nt == nel else face(ey0 + nt, xs, 2),
        base64.halo0[:, 2, panel, :, ys] if ex0 == 0 else face(ys, ex0 - 1, 1),
        base64.halo0[:, 3, panel, :, ys] if ex0 + nt == nel else face(ys, ex0 + nt, 0),
    ]
    cast = lambda t: t.to(dtype).contiguous()
    sides = lambda parts: cast(torch.stack(parts, dim=1).unsqueeze(2))  # (5, 4, 1, nk, nt, s^2)
    return E3PertBase(
        q0=cast(node(base64.q0)), rhs0=cast(node(base64.rhs0)), traces0=sides(own), halo0=sides(halo),
        itf0=cast(node(base64.itf0)), u0=cast(node(base64.u0)), p0=cast(base64.p0[panel : panel + 1, :, ys, xs]),
        dlp0=cast(base64.dlp0[panel : panel + 1, :, ys, xs]),
        wcorr0=cast(base64.wcorr0[panel : panel + 1, :, ys, xs]),
    )


def tile_edge_traces(q: torch.Tensor, con: E3Constants, pert: Optional[E3PertBase] = None) -> torch.Tensor:
    """The tile-edge traces (5, 4, 1, nk, nt, s^2) of a tile state, the tile
    chain's bootstrap: ``edge_traces`` (absolute) or ``edge_traces_delta``
    around the tile base."""
    return edge_traces(q, con) if pert is None else edge_traces_delta(q, pert, con)


def euler3d_tile_operator_plain(q, halo, con: E3Constants, x=None, a: float = 0.0, b: float = 1.0,
                                cdt: Optional[float] = None, emit_traces: bool = False,
                                pert: Optional[E3PertBase] = None):
    """Plain torch version of the tile kernel: the plain operator
    (``euler3d_operator_plain``, or ``euler3d_operator_pert_plain`` with a
    tile base from ``tile_pert_base``) on tile constants, a tile state
    (5, 1, nk, nt, nt, s^3) and its halo (5, 4, 1, nk, nt, s^2) on all four
    sides."""
    _check_npanel(con, 1, "euler3d_tile_operator_plain")
    if pert is not None:
        return euler3d_operator_pert_plain(q, halo, con, pert, x=x, a=a, b=b, cdt=cdt, emit_traces=emit_traces)
    return euler3d_operator_plain(q, halo, con, x=x, a=a, b=b, cdt=cdt, emit_traces=emit_traces)


def euler3d_tile_operator(q, halo, con: E3Constants, x=None, a: float = 0.0, b: float = 1.0,
                          cdt: Optional[float] = None, emit_traces: bool = False,
                          pert: Optional[E3PertBase] = None):
    """The operator over one tile: ``euler3d_operator`` (no ``bal``) with
    tile constants, a tile state (5, 1, nk, nt, nt, s^3), its halo (5, 4, 1,
    nk, nt, s^2) and, with ``emit_traces``, the output's tile-edge traces on
    all four sides. A CPU tensor runs ``euler3d_tile_operator_plain``; a CUDA
    tensor makes one launch of the operator over the tile (its interface
    and volume passes; csrc/euler3d_operator.cu, ``euler3d_tile_launch``,
    the port of ``pallas_euler3d.km3_tile``),
    counted in ``tile_launches`` (absolute) or ``pert_tile_launches``
    (perturbation form), or raises."""
    global tile_launches, pert_tile_launches
    _check_npanel(con, 1, "euler3d_tile_operator")
    _check(q, halo, con, x, a, None, cdt, emit_traces, pert)
    if q.device.type == "cpu":
        return euler3d_tile_operator_plain(q, halo, con, x=x, a=a, b=b, cdt=cdt, emit_traces=emit_traces, pert=pert)
    out = _launch_operator("euler3d_tile_launch", q, halo, con, x, a, b, cdt, None, emit_traces, pert)
    if pert is None:
        tile_launches += 1
    else:
        pert_tile_launches += 1
    return out


# ---------------------------------------------------------------------------
# Tracer advection under prescribed winds (DCMIP 11 and 12)

# The tracer counts the kernel is instantiated for: DCMIP 12 (1) and 11 (4).
ADVECTION_TRACERS = (1, 4)


def _check_advection_kernel(con: E3Constants, nt: int, name: str):
    """What the advection kernels take: 1 or 4 tracers, the flat metric."""
    _check_npanel(con, 6, name)
    if con.panel_metric:
        raise ValueError(f"{name} takes one panel's metric (DCMIP 11 and 12 have no topography)")
    if nt not in ADVECTION_TRACERS:
        raise ValueError(f"the advection kernels take {' or '.join(map(str, ADVECTION_TRACERS))} tracers "
                         f"(DCMIP 12, 11), not {nt}")


def _advection_shapes(q, con: E3Constants):
    """(state shape, traces shape) of a state of q's row count."""
    nv = q.shape[0]
    return (nv,) + con.state_shape[1:], (nv,) + con.traces_shape[1:]


def euler3d_advection_plain(q, halo, con: E3Constants, x=None, a: float = 0.0, b: float = 1.0,
                            cdt: Optional[float] = None, emit_traces: bool = False):
    """Plain torch version of the tracer-advection operator; same arguments
    and results as ``euler3d_advection``, for any number of tracer rows
    (written from the JAX package's ``_euler3d_rhs_core(...,
    advection_only=True)``, models/euler_cubesphere.py:90-291, term for
    term: the tracers' sqrt(g)-weighted fluxes and their divergence, the
    Rusanov flux with the eigenvalue max(|vL|, |vR|) at each interface, the
    boundary corrections; rows 0-4 of the RHS exactly 0). Counted in
    ``plain_calls``."""
    global plain_calls
    plain_calls += 1
    sqrtg, invsg = con.fields[0], con.fields[1]
    rho = q[0]
    tracers = q[5:]

    # 1. Log-space extrapolation of rho (and rho*theta) to the six faces.
    itf = _exp_rows(_log_rows(q) @ con.ee)

    # 2. Pointwise fluxes sqrt(g) u_d q_k and their divergence.
    bundles = [sqrtg * (q[1 + d] / rho) * tracers for d in range(3)]
    interior = torch.cat(bundles, dim=-1) @ con.dd

    # 3. Interface fluxes; the ground and the lid mirror the state, w odd.
    lr = _lr_states(itf, halo)
    bund = []
    for d, dim in _FAMILIES:
        qL, qR = lr[d]
        vL, vR = _normal_speeds(qL, qR, d)
        sg = _itf_metric(con, d)[0]
        eig = torch.maximum(vL.abs(), vR.abs())
        f = 0.5 * (sg * vL * qL[5:] + sg * vR * qR[5:] - eig * sg * (qR[5:] - qL[5:]))
        bund.append(_faces(f, dim))

    # 4. Boundary corrections.
    out = torch.zeros_like(q)
    out[5:] = -invsg * (interior + torch.cat(bund, dim=-1) @ con.cc)
    out = _stage(out, q, x, a, b, cdt)
    if emit_traces:
        return out, edge_traces(out, con)
    return out


def euler3d_advection(q, halo, con: E3Constants, x=None, a: float = 0.0, b: float = 1.0,
                      cdt: Optional[float] = None, emit_traces: bool = False):
    """The tracer-advection operator of DCMIP 11/12 on ``q`` (5 + nt rows:
    rho, the momenta of the prescribed winds, rho*theta and the tracers
    rho*q_k; (5 + nt, 6, nk, ny, nx, s^3)) with neighbour halos ``halo``
    (5 + nt, 4, 6, nk, nh, s^2).

    RHS mode (``cdt is None``): returns RHS(q), rows 0-4 exactly 0. Stage
    mode: returns ``a*x + b*q + cdt*RHS(q)`` over every row (``x`` is read
    only when ``a != 0``); with ``emit_traces`` (stage mode only) also the
    output's panel-edge traces of every row.

    A CPU tensor runs ``euler3d_advection_plain`` (any number of tracers);
    a CUDA tensor makes one launch of the advection kernel, its interface
    pass and volume pass (csrc/euler3d_advection.cu, built at first use),
    on the current stream, without synchronising, counted in
    ``advection_launches``, or raises. The kernel takes 1 or 4 tracers
    (DCMIP 12, 11) and the flat metric (one panel's)."""
    global advection_launches
    if q.shape[0] < 6:
        raise ValueError(f"euler3d_advection needs at least one tracer row, not {q.shape[0]} rows")
    if emit_traces and cdt is None:
        raise ValueError("euler3d_advection emits traces in stage mode only")
    state, traces = _advection_shapes(q, con)
    tensors = {"q": (q, state), "halo": (halo, traces)}
    if cdt is not None and a != 0.0:
        if x is None:
            raise ValueError("stage with a != 0 needs x")
        tensors["x"] = (x, state)
    _check_tensors(con, tensors)
    if q.device.type == "cpu":
        return euler3d_advection_plain(q, halo, con, x=x, a=a, b=b, cdt=cdt, emit_traces=emit_traces)
    out = _launch_advection(q, halo, con, x, a, b, cdt, emit_traces)
    advection_launches += 1
    return out


def _launch_advection(q, halo, con: E3Constants, x, a: float, b: float, cdt: Optional[float], emit_traces: bool):
    """One launch of the advection kernel (C entry ``euler3d_advection_launch``)
    on the current stream."""
    nt = q.shape[0] - 5
    _check_advection_kernel(con, nt, "euler3d_advection")
    if q.device.type != "cuda":
        raise ValueError(f"euler3d_advection runs on cpu or cuda tensors, not {q.device}")
    _check_kernel_shape(con, "euler3d_advection")

    from ..kernels.build import load_library

    lib = load_library("euler3d_advection")
    use_x = cdt is not None and a != 0.0
    out = torch.empty_like(q)
    traces = torch.empty(_advection_shapes(q, con)[1], dtype=q.dtype, device=q.device) if emit_traces else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.euler3d_advection_launch(
            1 if q.dtype == torch.float64 else 0, con.s, nt, con.nel_h, con.nel_v,
            _ptr(q), _ptr(halo), _ptr(con.ops1d), _ptr(con.fields), _ptr(con.itf_x), _ptr(con.itf_y),
            _ptr(con.itf_z), _ptr(x if use_x else None), _ptr(out), _ptr(traces), float(a), float(b),
            float(cdt if cdt is not None else 0.0), 1 if cdt is not None else 0, ctypes.c_void_p(stream),
        )
    if rc != 0:
        name = lib.euler3d_advection_error_string(rc).decode()
        raise RuntimeError(f"euler3d_advection_launch kernel launch failed: CUDA error {rc} ({name})")
    return (out, traces) if emit_traces else out


# The Jacobian action of the advection operator, J(q).v for v = (d rho, d m,
# d rho*theta, d T): rows 0-4 exactly 0, d rho*theta enters nothing, and each
# tracer row is -(1/sqrt(g)) (sum_d D_d(d F_d) + the boundary corrections of
# the flux derivative), with at the nodes d(sqrt(g) u_d T_k) = sqrt(g) (u_d
# dT_k + (T_k / rho) (dm_d - u_d d rho)), at each interface the derivative of
# the Rusanov flux from the direction's traces (d rho_L = rho_L E.(d rho /
# rho), dm_L = E.dm, dT_L = E.dT, dv_L = (dm_L - v_L d rho_L) / rho_L) and
# d max(|vL|, |vR|) by jax.jvp's rules (d|x| = +dx at x = 0 and -0, the mean
# of the two sides' derivatives at a tie), and exactly 0 at the ground and
# the lid. A prep once per linearisation point q writes what the apply
# needs into one buffer (``advection_tangent_layout``):
#
#   node    (4 + nt, 6, nk, nh, nh, s^3)   rows ADVECTION_TANGENT_NODE_ROWS:
#           1/rho, u_1, u_2, u_3 and T_k / rho, in the state's layout
#   face_x  (7 + 2 nt, 6, nk, nh, nh+1, s^2)  one entry per interface point,
#   face_y  (7 + 2 nt, 6, nk, nh+1, nh, s^2)  rows ADVECTION_TANGENT_FACE_ROWS
#   face_z  (7 + 2 nt, 6, nk-1, nh, nh, s^2)  and the tracers' traces T_L, T_R
#
# c_L and c_R are d max(|vL|, |vR|) / d v_L and / d v_R (the tie weight times
# the sign). face_z holds the levels between elements only: the ground's and
# the lid's flux derivative is 0 whatever v is. The apply is linear in v.
ADVECTION_TANGENT_NODE_ROWS = ("inv_rho", "u1", "u2", "u3")
ADVECTION_TANGENT_FACE_ROWS = ("rho_L", "rho_R", "v_L", "v_R", "eig", "c_L", "c_R")


@dataclass(frozen=True)
class AdvectionTangentCoefficients:
    """The linearisation of the advection operator at one state
    (``euler3d_advection_tangent_prep``): the flat buffer in the layout of
    ``advection_tangent_layout`` for ``ntracer`` tracers."""

    values: torch.Tensor
    ntracer: int


def advection_tangent_layout(con: E3Constants, ntracer: int) -> dict:
    """Shapes and offsets (in elements) of the parts of the advection
    tangent's coefficient buffer, and its ``size``."""
    nh, nk, s = con.nel_h, con.nel_v, con.s
    kn, kf = len(ADVECTION_TANGENT_NODE_ROWS) + ntracer, len(ADVECTION_TANGENT_FACE_ROWS) + 2 * ntracer
    shapes = {
        "node": (kn, 6, nk, nh, nh, s**3),
        "face_x": (kf, 6, nk, nh, nh + 1, s * s),
        "face_y": (kf, 6, nk, nh + 1, nh, s * s),
        "face_z": (kf, 6, nk - 1, nh, nh, s * s),
    }
    layout, offset = {}, 0
    for name, shape in shapes.items():
        layout[name] = (offset, shape)
        offset += int(np.prod(shape))
    layout["size"] = offset
    return layout


def advection_interface_points(con: E3Constants) -> int:
    """The interface points of the sphere, the ground and the lid included:
    the x, y and z families of the advection kernels' flux rows."""
    nh, nk = con.nel_h, con.nel_v
    return 6 * (2 * nk * nh * (nh + 1) + (nk + 1) * nh * nh) * con.s**2


def advection_tangent_parts(coef: AdvectionTangentCoefficients, con: E3Constants):
    """(node, [face_x, face_y, face_z]) views of a coefficient buffer."""
    layout = advection_tangent_layout(con, coef.ntracer)
    view = lambda name: coef.values.narrow(0, layout[name][0], int(np.prod(layout[name][1]))).view(layout[name][1])
    return view("node"), [view("face_x"), view("face_y"), view("face_z")]


def euler3d_advection_tangent_prep_plain(q, halo_q, con: E3Constants) -> AdvectionTangentCoefficients:
    """Plain torch version of the advection tangent's prep kernel: the
    coefficient buffer of the linearisation at q (``halo_q`` q's halo), on
    the halo glue of the RHS (q's traces extrapolated as
    ``euler3d_advection_plain`` extrapolates them). Counted in
    ``plain_calls``."""
    global plain_calls
    plain_calls += 1
    rho = q[0]
    node = torch.stack([1.0 / rho, q[1] / rho, q[2] / rho, q[3] / rho] + [t / rho for t in q[5:]])
    lr = _lr_states(_exp_rows(_log_rows(q) @ con.ee), halo_q)
    faces = []
    for d, _ in _FAMILIES:
        qL, qR = lr[d]
        vL, vR = _normal_speeds(qL, qR, d)
        aL, aR = vL.abs(), vR.abs()
        weight_l = torch.where(aL > aR, 1.0, torch.where(aL < aR, 0.0, 0.5)).to(aL.dtype)
        sign = lambda x: torch.where(x >= 0, 1.0, -1.0).to(x.dtype)
        face = torch.cat([torch.stack([qL[0], qR[0], vL, vR, torch.maximum(aL, aR), weight_l * sign(vL),
                                       (1.0 - weight_l) * sign(vR)]), qL[5:], qR[5:]])
        faces.append(face[:, :, 1:-1] if d == 2 else face)  # no z entry at the ground and the lid
    values = torch.cat([node.reshape(-1)] + [f.reshape(-1) for f in faces])
    return AdvectionTangentCoefficients(values, q.shape[0] - 5)


def euler3d_advection_tangent_apply_plain(v, halo_v, coef: AdvectionTangentCoefficients, con: E3Constants):
    """Plain torch version of the advection tangent's apply kernel: J.v from
    the coefficient buffer ``coef``, the direction ``v`` (5 + nt rows) and
    its halo ``halo_v`` (``edge_traces_tangent`` and ``halo_from_traces``),
    linear in v; rows 0-4 exactly 0, the ground's and the lid's flux
    derivative exactly 0. Counted in ``plain_tangent_calls``."""
    global plain_tangent_calls
    plain_tangent_calls += 1
    nt = coef.ntracer
    sqrtg, invsg = con.fields[0], con.fields[1]
    node, faces = advection_tangent_parts(coef, con)
    irho, u = node[0], node[1:4]
    phi = node[4:]
    # The ground's and the lid's z entries, whose flux derivative is zeroed
    # below, as ones.
    lid = faces[2].shape[:2] + (1,) + faces[2].shape[3:]
    ones = torch.ones(lid, dtype=faces[2].dtype, device=faces[2].device)
    faces[2] = torch.cat([ones, faces[2], ones], dim=2)

    # Direction traces (rows d rho, dm_1..3, dT_k): the own side's from the
    # nodes (rho through its primal own-face trace times E.(d rho / rho)),
    # the far side's from the halo; the ground and the lid are zeroed below.
    raw = torch.cat([(v[0] * irho)[None], v[1:4], v[5:]]) @ con.ee
    own_rho = torch.cat([torch.cat(_own_faces(f[0], f[1], dim), dim=-1) for f, (_, dim) in zip(faces, _FAMILIES)],
                        dim=-1)
    tlr = _lr_states(torch.cat([own_rho[None] * raw[0:1], raw[1:]]), torch.cat([halo_v[0:4], halo_v[5:]]))

    bund = []
    for (d, dim), f in zip(_FAMILIES, faces):
        tL, tR = tlr[d]
        rL, rR, vL, vR, eig, cL, cR = f[:7]
        TL, TR = f[7 : 7 + nt], f[7 + nt :]
        sg = _itf_metric(con, d)[0]
        dvL, dvR = (tL[1 + d] - vL * tL[0]) / rL, (tR[1 + d] - vR * tR[0]) / rR
        deig = cL * dvL + cR * dvR
        sl, sr, es, sdl, sdr, sde = sg * vL, sg * vR, sg * eig, sg * dvL, sg * dvR, sg * deig
        flux = 0.5 * ((sdl * TL + sl * tL[4:]) + (sdr * TR + sr * tR[4:]) - (sde * (TR - TL) + es * (tR[4:] - tL[4:])))
        if d == 2:  # the ground and the lid: the mirror's flux is exactly 0
            flux[:, :, 0] = 0.0
            flux[:, :, -1] = 0.0
        bund.append(_faces(flux, dim))

    w = [v[1 + d] - u[d] * v[0] for d in range(3)]
    interior = torch.cat([sqrtg * (u[d] * v[5:] + phi * w[d]) for d in range(3)], dim=-1) @ con.dd
    out = torch.zeros_like(v)
    out[5:] = -invsg * (interior + torch.cat(bund, dim=-1) @ con.cc)
    return out


def euler3d_advection_tangent_plain(q, v, halo_q, halo_v, con: E3Constants):
    """J(q).v of the advection operator in one call: the plain prep at q,
    then the plain apply in the direction v (``halo_q`` and ``halo_v`` their
    neighbour halos)."""
    return euler3d_advection_tangent_apply_plain(v, halo_v, euler3d_advection_tangent_prep_plain(q, halo_q, con), con)


def _launch_advection_tangent(entry: str, con: E3Constants, nt: int, *args):
    """One launch of an advection tangent kernel through the C entry
    ``entry`` with the leading (is_f64, s, nt, nel_h, nel_v) and the stream
    added; raises on a refused launch."""
    _check_kernel_shape(con, entry)

    from ..kernels.build import load_library

    lib = load_library("euler3d_advection_tangent")
    with torch.cuda.device(con.device):
        stream = torch.cuda.current_stream(con.device).cuda_stream
        rc = getattr(lib, entry)(1 if con.dtype == torch.float64 else 0, con.s, nt, con.nel_h, con.nel_v,
                                 *[_ptr(a) for a in args], ctypes.c_void_p(stream))
    if rc != 0:
        name = lib.euler3d_advection_tangent_error_string(rc).decode()
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc} ({name})")


def euler3d_advection_tangent_prep(q, halo_q, con: E3Constants) -> AdvectionTangentCoefficients:
    """The linearisation of the advection operator at ``q`` (5 + nt rows;
    ``halo_q`` its neighbour halos), once per linearisation point: the
    coefficient buffer the apply reads.

    A CPU tensor runs ``euler3d_advection_tangent_prep_plain`` (any number of
    tracers); a CUDA tensor makes one launch of the prep kernel, its node
    and interface passes (csrc/euler3d_advection_tangent.cu, built at first
    use), on the current stream, without synchronising, counted in
    ``advection_tangent_prep_launches``, or raises. The kernel takes 1 or 4
    tracers and the flat metric."""
    global advection_tangent_prep_launches
    nt = q.shape[0] - 5
    if nt < 1:
        raise ValueError(f"the advection tangent needs at least one tracer row, not {q.shape[0]} rows")
    state, traces = _advection_shapes(q, con)
    _check_tensors(con, {"q": (q, state), "halo_q": (halo_q, traces)})
    _check_device(q, "euler3d_advection_tangent_prep")
    if q.device.type == "cpu":
        return euler3d_advection_tangent_prep_plain(q, halo_q, con)
    _check_advection_kernel(con, nt, "euler3d_advection_tangent_prep")
    values = torch.empty(advection_tangent_layout(con, nt)["size"], dtype=q.dtype, device=q.device)
    _launch_advection_tangent("euler3d_advection_tangent_prep_launch", con, nt, q, halo_q, con.ops1d, values)
    advection_tangent_prep_launches += 1
    return AdvectionTangentCoefficients(values, nt)


def euler3d_advection_tangent_apply(v, halo_v, coef: AdvectionTangentCoefficients, con: E3Constants):
    """J.v of the advection operator from the linearisation ``coef``
    (``euler3d_advection_tangent_prep``) in the direction ``v`` (5 + nt
    rows) with its neighbour halos ``halo_v``, once per Jacobian action;
    rows 0-4 exactly 0.

    A CPU tensor runs ``euler3d_advection_tangent_apply_plain``; a CUDA
    tensor makes one launch of the apply kernel, its interface and volume
    passes (csrc/euler3d_advection_tangent.cu), on the current stream,
    without synchronising, counted in ``advection_tangent_apply_launches``,
    or raises."""
    global advection_tangent_apply_launches
    nt = coef.ntracer
    if v.shape[0] != 5 + nt:
        raise ValueError(f"the direction has {v.shape[0]} rows; the linearisation holds {5 + nt}")
    state, traces = _advection_shapes(v, con)
    _check_tensors(con, {"v": (v, state), "halo_v": (halo_v, traces),
                         "coefficients": (coef.values, (advection_tangent_layout(con, nt)["size"],))})
    _check_device(v, "euler3d_advection_tangent_apply")
    if v.device.type == "cpu":
        return euler3d_advection_tangent_apply_plain(v, halo_v, coef, con)
    _check_advection_kernel(con, nt, "euler3d_advection_tangent_apply")
    rows = torch.empty(nt * advection_interface_points(con), dtype=v.dtype, device=v.device)  # between the passes
    out = torch.empty_like(v)
    _launch_advection_tangent("euler3d_advection_tangent_apply_launch", con, nt, v, halo_v, con.ops1d, con.fields,
                              con.itf_x, con.itf_y, con.itf_z, coef.values, rows, out)
    advection_tangent_apply_launches += 1
    return out


# ---------------------------------------------------------------------------
# Jacobian action (tangent mode)


def euler3d_tangent_plain(q, v, halo_q, halo_v, con: E3Constants):
    """Plain torch version of the tangent mode: ``torch.func.jvp`` of
    ``euler3d_operator_plain`` at (q, halo_q) in the direction (v, halo_v),
    the chain rule through the halo glue (``halo_v`` from
    ``edge_traces_tangent`` and ``halo_from_traces``). Counted in
    ``plain_tangent_calls``."""
    global plain_tangent_calls
    plain_tangent_calls += 1
    _, out = torch.func.jvp(lambda q_, h_: euler3d_operator_plain(q_, h_, con), (q, halo_q), (v, halo_v))
    return out


# The split Jacobian action: a prep once per linearisation point q, an
# apply once per direction v. The prep writes every primal quantity of the
# linearisation that costs a transcendental, a square root, a division or a
# neighbour read into one coefficient buffer; the apply is linear in v and
# uses none of them. Buffer layout (``tangent_layout``; the kernels' own):
#
#   node   (6, nk, nh, nh, 8, s^3)  element-major: each element's run is the
#          8 rows TANGENT_NODE_ROWS of s^3 nodes
#   face_x (22, 6, nk, nh, nh+1, s^2)  one entry per interface point, both
#   face_y (22, 6, nk, nh+1, nh, s^2)  sides: rows TANGENT_FACE_ROWS; face
#   face_z (22, 6, nk+1, nh, nh, s^2)  points ordered as the interface metric
#
# w_pres is the primal factor of the direction's pressure in the w equation:
# wpres_int + the boundary correction of the face w pressure / p + sqrt(g)
# (h^{02} d_x + h^{12} d_y + h^{22} d_z) log p (with its face corrections).
# At the ground and the lid both sides hold the element's own trace and the
# apply makes w odd. gp = gamma p / (rho*theta); p_ratio_L = p_R / p_L.
TANGENT_NODE_ROWS = ("inv_rho", "inv_rho_theta", "u1", "u2", "u3", "theta", "p", "w_pres")
TANGENT_FACE_ROWS = tuple(f"{v}_{side}" for side in "LR" for v in ("rho", "rho_u1", "rho_u2", "rho_w", "rho_theta")) + (
    "inv_rho_L", "inv_rho_R", "inv_rho_theta_L", "inv_rho_theta_R", "c_L", "c_R", "gp_L", "gp_R",
    "p_ratio_L", "p_ratio_R", "eig", "weight_L")


@dataclass(frozen=True)
class TangentCoefficients:
    """The linearisation at one state (``euler3d_tangent_prep``): the flat
    buffer in the layout of ``tangent_layout`` and whether the
    perturbation form built it (its applies count in
    ``pert_tangent_launches``)."""

    values: torch.Tensor
    pert: bool


def tangent_layout(con: E3Constants) -> dict:
    """Shapes and offsets (in elements) of the parts of the coefficient
    buffer, and its ``size``."""
    nh, nk, s, kf = con.nel_h, con.nel_v, con.s, len(TANGENT_FACE_ROWS)
    shapes = {
        "node": (6, nk, nh, nh, len(TANGENT_NODE_ROWS), s**3),
        "face_x": (kf, 6, nk, nh, nh + 1, s * s),
        "face_y": (kf, 6, nk, nh + 1, nh, s * s),
        "face_z": (kf, 6, nk + 1, nh, nh, s * s),
    }
    layout, offset = {}, 0
    for name, shape in shapes.items():
        layout[name] = (offset, shape)
        offset += int(np.prod(shape))
    layout["size"] = offset
    return layout


def _tangent_parts(values: torch.Tensor, con: E3Constants):
    """(node (6, nk, nh, nh, 8, s^3), [face_x, face_y, face_z]) views of a
    coefficient buffer."""
    layout = tangent_layout(con)
    view = lambda name: values.narrow(0, layout[name][0], int(np.prod(layout[name][1]))).view(layout[name][1])
    return view("node"), [view("face_x"), view("face_y"), view("face_z")]


def euler3d_tangent_prep_plain(q, halo_q, con: E3Constants, pert: Optional[E3PertBase] = None) -> TangentCoefficients:
    """Plain torch version of the prep kernel: the coefficient buffer of
    the linearisation at q (``halo_q`` q's halo), or with ``pert`` at q0 +
    dq (``q`` the perturbation dq, ``halo_q`` its delta halo), where every
    primal quantity is formed as the perturbation form forms it (traces t0
    + dt, pressures p0 + p0 expm1(gamma log1p(d/rt0)), the log-pressure
    gradient dlp0 + ddlp). Counted in ``plain_calls``."""
    global plain_calls
    plain_calls += 1
    gam = HEAT_CAPACITY_RATIO
    fld = con.fields
    sqrtg = fld[0]
    h = {}
    for i, (r, c) in enumerate(H_PAIRS):
        h[(r, c)] = h[(c, r)] = fld[3 + i]
    wpres_int = fld[-1]

    # Node values, the interface states (qL, qR) with their face pressures,
    # the own side's face w pressure / p and the log-pressure gradient.
    fam, wpf = {}, []
    if pert is None:
        qa, rho = q, q[0]
        u = q[1:4] / rho
        p = pressure(q[4])
        lr = _lr_states(_exp_rows(_log_rows(q) @ con.ee), halo_q)
        lpf = []
        for d, dim in _FAMILIES:
            qL, qR = lr[d]
            sg, _, _, h2 = _itf_metric(con, d)
            pL, pR = pressure(qL[4]), pressure(qR[4])
            p_neg, p_pos = _own_faces(pL, pR, dim)
            wp = 0.5 * (sg * h2 * pL + sg * h2 * pR)
            w_neg, w_pos = _own_faces(wp, wp, dim)
            wpf.append(torch.cat([w_neg / p_neg, w_pos / p_pos], dim=-1))
            lpf.append(torch.cat([torch.log(p_neg), torch.log(p_pos)], dim=-1))
            fam[d] = (qL, qR, pL, pR)
        dlp = torch.log(p) @ con.dd3 + torch.cat(lpf, dim=-1) @ con.ccb
    else:
        q0, dq = pert.q0, q
        qa = q0 + dq
        rho, rho0 = qa[0], q0[0]
        u0 = q0[1:4] / rho0
        u = u0 + (dq[1:4] - u0 * dq[0]) / rho
        p0 = pressure(q0[4])
        dlog_rt = torch.log1p(dq[4] / q0[4])
        dp = p0 * torch.expm1(gam * dlog_rt)
        p = p0 + dp
        raw = torch.cat([torch.log1p(dq[0:1] / rho0), dq[1:4], dlog_rt[None]]) @ con.ee
        itf0 = pert.itf0
        ditf = torch.cat([itf0[0:1] * torch.expm1(raw[0:1]), raw[1:4], itf0[4:5] * torch.expm1(raw[4:5])])
        lr0, lrd = _lr_states(itf0, pert.halo0), _lr_states(ditf, halo_q)
        dlpf = []
        for d, dim in _FAMILIES:
            (L0, R0), (dL, dR) = lr0[d], lrd[d]
            sg, _, _, h2 = _itf_metric(con, d)
            pL0, pR0 = pressure(L0[4]), pressure(R0[4])
            dpL = pL0 * torch.expm1(gam * torch.log1p(dL[4] / L0[4]))
            dpR = pR0 * torch.expm1(gam * torch.log1p(dR[4] / R0[4]))
            p0n, p0p = _own_faces(pL0, pR0, dim)
            dpn, dpp = _own_faces(dpL, dpR, dim)
            w0 = 0.5 * sg * h2 * (pL0 + pR0)
            dw = 0.5 * sg * h2 * (dpL + dpR)
            w0n, w0p = _own_faces(w0, w0, dim)
            dwn, dwp = _own_faces(dw, dw, dim)
            pn, pp = p0n + dpn, p0p + dpp
            wpf.append(torch.cat([w0n / p0n + (dwn / pn - (w0n / p0n) * (dpn / pn)),
                                  w0p / p0p + (dwp / pp - (w0p / p0p) * (dpp / pp))], dim=-1))
            dlpf.append(torch.cat([torch.log1p(dpn / p0n), torch.log1p(dpp / p0p)], dim=-1))
            fam[d] = (L0 + dL, R0 + dR, pL0 + dpL, pR0 + dpR)
        dlp = pert.dlp0 + (torch.log1p(dp / p0) @ con.dd3 + torch.cat(dlpf, dim=-1) @ con.ccb)

    s3 = con.s**3
    w_pres = wpres_int + torch.cat(wpf, dim=-1) @ con.cc + sqrtg * (
        h[(0, 2)] * dlp[..., :s3] + h[(1, 2)] * dlp[..., s3 : 2 * s3] + h[(2, 2)] * dlp[..., 2 * s3 :])
    node = torch.stack([1.0 / rho, 1.0 / qa[4], u[0], u[1], u[2], qa[4] / rho, p, w_pres], dim=-2)

    faces = []
    for d, _ in _FAMILIES:
        qL, qR, pL, pR = fam[d]
        hd = _itf_metric(con, d)[1 + d]
        vL, vR = _normal_speeds(qL, qR, d)
        cL = torch.sqrt(hd * gam * pL / qL[0])
        cR = torch.sqrt(hd * gam * pR / qR[0])
        aL, aR = _abs(vL) + cL, _abs(vR) + cR
        weight_l = torch.where(aL > aR, 1.0, torch.where(aL < aR, 0.0, 0.5)).to(aL.dtype)
        faces.append(torch.cat([qL, qR, torch.stack([
            1.0 / qL[0], 1.0 / qR[0], 1.0 / qL[4], 1.0 / qR[4], cL, cR, gam * pL / qL[4], gam * pR / qR[4],
            pR / pL, pL / pR, torch.maximum(aL, aR), weight_l])]))
    return TangentCoefficients(torch.cat([node.reshape(-1)] + [f.reshape(-1) for f in faces]), pert is not None)


def euler3d_tangent_apply_plain(v, halo_v, coef: TangentCoefficients, con: E3Constants):
    """Plain torch version of the apply kernel: J.v from the coefficient
    buffer ``coef``, the direction ``v`` and its halo ``halo_v``, with
    linear arithmetic only (the direction's log-space traces as the primal
    trace times E.(v/q), the Rusanov flux derivative with the selector
    weights and d|vn| = +dvn at vn >= 0, the quadratic forcing by the
    product rule). Counted in ``plain_tangent_calls``."""
    global plain_tangent_calls
    plain_tangent_calls += 1
    gam = HEAT_CAPACITY_RATIO
    fld = con.fields
    sqrtg, invsg, invdz = fld[0], fld[1], fld[2]
    h = {}
    for i, (r, c) in enumerate(H_PAIRS):
        h[(r, c)] = h[(c, r)] = fld[3 + i]
    chs = fld[3 + len(H_PAIRS) : 3 + len(H_PAIRS) + 18]
    s3 = con.s**3
    node, faces = _tangent_parts(coef.values, con)
    irho, irt, u1, u2, u3, theta, p, w_pres = node.movedim(-2, 0)
    u = (u1, u2, u3)
    phi = (torch.ones_like(theta), u1, u2, u3, theta)  # q_c / rho

    # Direction traces: the own side's from the log-tangent nodes and the
    # primal own-face traces, the far side's from the halo or the mirror.
    lt = torch.stack([v[0] * irho, v[1], v[2], v[3], v[4] * irt])
    raw = lt @ con.ee
    own = torch.cat([torch.cat(_own_faces(f[0:5], f[5:10], dim), dim=-1) for f, (_, dim) in zip(faces, _FAMILIES)],
                    dim=-1)
    tlr = _lr_states(torch.cat([own[0:1] * raw[0:1], raw[1:4], own[4:5] * raw[4:5]]), halo_v)

    tpres = gam * p * irt * v[4]
    bund, lpf = [], []
    for (d, dim), f in zip(_FAMILIES, faces):
        tL, tR = tlr[d]
        qL, qR = f[0:5], f[5:10]
        iL0, iR0, iL4, iR4, cL, cR, gpL, gpR, rL, rR, eig, wL = f[10:]
        sg, h0, h1, h2 = _itf_metric(con, d)
        vL, vR = qL[1 + d] * iL0, qR[1 + d] * iR0
        tvL, tvR = (tL[1 + d] - vL * tL[0]) * iL0, (tR[1 + d] - vR * tR[0]) * iR0
        if d == 2:  # w is odd across the ground and the lid
            flip_l = lambda a: torch.cat([-a[:, 0:1], a[:, 1:]], dim=1)
            flip_r = lambda a: torch.cat([a[:, :-1], -a[:, -1:]], dim=1)
            vL, tvL, vR, tvR = flip_l(vL), flip_l(tvL), flip_r(vR), flip_r(tvR)
        taL = torch.where(vL >= 0, tvL, -tvL) + 0.5 * cL * (gam * iL4 * tL[4] - iL0 * tL[0])
        taR = torch.where(vR >= 0, tvR, -tvR) + 0.5 * cR * (gam * iR4 * tR[4] - iR0 * tR[0])
        teig = wL * taL + (1.0 - wL) * taR
        sl, sr, es = sg * vL, sg * vR, eig * sg
        tsl, tsr, tes = sg * tvL, sg * tvR, teig * sg
        adv = 0.5 * ((tsl * qL + sl * tL) + (tsr * qR + sr * tR) - (tes * (qR - qL) + es * (tR - tL)))
        tps = 0.5 * (gpL * tL[4] + gpR * tR[4])
        tf = torch.stack([adv[0], adv[1] + sg * h0 * tps, adv[2] + sg * h1 * tps, adv[4], adv[3]])
        # The own side's d[w pressure / p] and d log p (negative faces: the
        # right side of their interface; positive: the left).
        lL, lR = gam * iL4 * tL[4], gam * iR4 * tR[4]
        wp_neg, wp_pos = _own_faces(0.5 * sg * h2 * rL * (lR - lL), 0.5 * sg * h2 * rR * (lL - lR), dim)
        bund.append(torch.cat([_faces(tf, dim), torch.cat([wp_neg, wp_pos], dim=-1)[None]]))
        lpf.append(torch.cat(_own_faces(lL, lR, dim), dim=-1))
    corr = torch.cat(bund, dim=-1) @ con.cc
    tdlp = gam * (lt[4] @ con.dd3) + torch.cat(lpf, dim=-1) @ con.ccb

    # Pointwise flux derivatives sqrt(g) (w_d q_c / rho + u_d v_c), w_d =
    # v_{1+d} - u_d v_rho, and the pressure's.
    w = [v[1 + d] - u[d] * v[0] for d in range(3)]
    bundles = []
    for d in range(3):
        fl = [sqrtg * (w[d] * phi[c] + u[d] * v[c]) for c in range(5)]
        sgp = sqrtg * tpres
        bundles.append(torch.stack([fl[0], fl[1] + sgp * h[(d, 0)], fl[2] + sgp * h[(d, 1)], fl[4], fl[3]]))
    interior = torch.cat(bundles, dim=-1) @ con.dd

    tw_df = (interior[4] + corr[4] + corr[5] * p + w_pres * tpres
             + p * (sqrtg * h[(0, 2)] * tdlp[..., :s3] + sqrtg * h[(1, 2)] * tdlp[..., s3 : 2 * s3]
                    + sqrtg * h[(2, 2)] * tdlp[..., 2 * s3 :]))

    # Christoffel/Coriolis forcing: d(rho u_b u_c) = v_rho u_b u_c + w_b u_c
    # + u_b w_c; the Coriolis term 2 rho Gamma^a_{0b} u^b is linear in the momenta.
    def forcing_row(a_):
        ch = chs[6 * a_ : 6 * a_ + 6]
        pair = [v[0] * u[b] * u[c] + w[b] * u[c] + u[b] * w[c] + h[(b, c)] * tpres for b, c in H_PAIRS]
        f = ch[0] * pair[0]
        if con.tch is not None:
            t = con.tch[3 * a_ : 3 * a_ + 3]
            f = 2.0 * (t[0] * v[1] + t[1] * v[2] + t[2] * v[3]) + f
        return f + 2.0 * ch[1] * pair[1] + 2.0 * ch[2] * pair[2] + ch[3] * pair[3] + 2.0 * ch[4] * pair[4] + ch[5] * pair[5]

    gravity = invdz * GRAVITY * invsg * ((sqrtg * v[0]) @ con.hfk)
    force = _with_sponge([forcing_row(0), forcing_row(1), forcing_row(2) + gravity], v, con)
    return torch.stack([
        -invsg * (interior[0] + corr[0]),
        -invsg * (interior[1] + corr[1]) - force[0],
        -invsg * (interior[2] + corr[2]) - force[1],
        -invsg * tw_df - force[2],
        -invsg * (interior[3] + corr[3]),
    ])


def _launch_tangent(entry: str, con: E3Constants, *args):
    """One launch of a tangent kernel through the C entry ``entry`` with the
    leading (is_f64, s, nel_h, nel_v) and the stream added; raises on a
    refused launch."""
    _check_kernel_shape(con, entry)

    from ..kernels.build import load_library

    lib = load_library("euler3d_terrain" if "terrain" in entry else "euler3d_operator")
    with torch.cuda.device(con.device):
        stream = torch.cuda.current_stream(con.device).cuda_stream
        rc = getattr(lib, entry)(1 if con.dtype == torch.float64 else 0, con.s, con.nel_h, con.nel_v,
                                 *[_ptr(a) for a in args], ctypes.c_void_p(stream))
    if rc != 0:
        name = lib.euler3d_operator_error_string(rc).decode()
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc} ({name})")


def _check_device(t, name: str):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {t.device}")


def euler3d_tangent_prep(q, halo_q, con: E3Constants, pert: Optional[E3PertBase] = None) -> TangentCoefficients:
    """The linearisation of the operator at ``q`` (``halo_q`` its
    neighbour halos), once per linearisation point: the coefficient buffer
    the apply reads. With ``pert``, ``q`` is the perturbation dq around
    ``pert.q0`` and ``halo_q`` its delta halo: the linearisation at q0 + dq.

    A CPU tensor runs ``euler3d_tangent_prep_plain``; a CUDA tensor launches
    the prep kernel (csrc/euler3d_operator.cu) on the current stream,
    without synchronising, counted in ``tangent_prep_launches`` (its
    terrain instantiation, on a per-panel metric, in
    ``terrain_tangent_prep_launches``), or raises."""
    global tangent_prep_launches, terrain_tangent_prep_launches
    _check_npanel(con, 6, "euler3d_tangent_prep")
    tensors = {"q": (q, con.state_shape), "halo_q": (halo_q, con.traces_shape)}
    if pert is not None:
        tensors.update(_pert_tensors(con, pert))
    _check_tensors(con, tensors)
    _check_device(q, "euler3d_tangent_prep")
    if q.device.type == "cpu":
        return euler3d_tangent_prep_plain(q, halo_q, con, pert)
    values = torch.empty(tangent_layout(con)["size"], dtype=q.dtype, device=q.device)
    base = pert.tensors if pert is not None else {}
    entry = "euler3d_tangent_prep_terrain_launch" if con.panel_metric else "euler3d_tangent_prep_launch"
    _launch_tangent(entry, con, q, halo_q, con.ops1d, con.fields, con.itf_x, con.itf_y, con.itf_z, base.get("q0"),
                    base.get("halo0"), values)
    if con.panel_metric:
        terrain_tangent_prep_launches += 1
    else:
        tangent_prep_launches += 1
    return TangentCoefficients(values, pert is not None)


def euler3d_tangent_apply(v, halo_v, coef: TangentCoefficients, con: E3Constants):
    """J.v from the linearisation ``coef`` (``euler3d_tangent_prep``) in the
    direction ``v`` with its neighbour halos ``halo_v``, once per Jacobian
    action.

    A CPU tensor runs ``euler3d_tangent_apply_plain``; a CUDA tensor launches
    the apply kernel (csrc/euler3d_operator.cu) on the current stream,
    without synchronising, counted in ``tangent_launches`` (or
    ``pert_tangent_launches`` for a perturbation-form linearisation; on a
    per-panel metric its terrain instantiation, with the sponge's tangent
    where the constants have one, in ``terrain_tangent_apply_launches``),
    or raises."""
    global tangent_launches, pert_tangent_launches, terrain_tangent_apply_launches
    _check_npanel(con, 6, "euler3d_tangent_apply")
    _check_tensors(con, {"v": (v, con.state_shape), "halo_v": (halo_v, con.traces_shape),
                         "coefficients": (coef.values, (tangent_layout(con)["size"],))})
    _check_device(v, "euler3d_tangent_apply")
    if v.device.type == "cpu":
        return euler3d_tangent_apply_plain(v, halo_v, coef, con)
    out = torch.empty_like(v)
    if con.panel_metric:
        _launch_tangent("euler3d_tangent_apply_terrain_launch", con, v, halo_v, con.ops1d, con.fields, con.tch,
                        con.itf_x, con.itf_y, con.itf_z, coef.values, out, con.sponge)
        terrain_tangent_apply_launches += 1
        return out
    _launch_tangent("euler3d_tangent_apply_launch", con, v, halo_v, con.ops1d, con.fields, con.tch, con.itf_x,
                    con.itf_y, con.itf_z, coef.values, out)
    if coef.pert:
        pert_tangent_launches += 1
    else:
        tangent_launches += 1
    return out


def euler3d_tangent(q, v, halo_q, halo_v, con: E3Constants, pert: Optional[E3PertBase] = None):
    """The Jacobian action J(q).v of the operator in RHS mode (no stage,
    ``bal`` or traces) in one call: ``euler3d_tangent_prep`` at q, then
    ``euler3d_tangent_apply`` in the direction v, with ``halo_q`` q's
    neighbour halos and ``halo_v`` the direction's (both (5, 4, 6, nk, nh,
    s^2)). With ``pert``, ``q`` is the perturbation dq around ``pert.q0``
    and ``halo_q`` its delta halo: returns J(q0 + dq).v. Callers that apply
    one linearisation to many directions call the two halves themselves
    (``Euler3DRHS.jtv_prep``/``jtv_apply``)."""
    _check_tensors(con, {"v": (v, con.state_shape), "halo_v": (halo_v, con.traces_shape)})
    return euler3d_tangent_apply(v, halo_v, euler3d_tangent_prep(q, halo_q, con, pert), con)
