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

The operator's Jacobian action J(q).v (``km3_fused``'s tangent mode, the
matvec of the exponential integrators' Krylov loop) has the same split:
``euler3d_tangent`` launches the kernel's tangent mode for CUDA tensors and
runs ``euler3d_tangent_plain`` (``torch.func.jvp`` of the plain operator)
for CPU tensors. Its halo glue is the primal glue's derivative:
``edge_traces_tangent`` gives the direction's panel-edge traces (linear
extrapolation of the momenta, ``tr_q * (E.(v/q))`` for the log-space rows)
and ``halo_from_traces``, which is linear, exchanges them.

The perturbation (base-state-split) form, ``km3_fused``'s ``pert=`` mode
(``_km3_body`` with ``base=``, the JAX package's ``_euler3d_rhs_core_pert``):
the state is carried as ``dq = q - q0`` around a balanced base state ``q0``
(``E3PertBase``, built once in float64 on the state's device and cast), and
every nonlinear site is expanded exactly around it (``expm1``/``log1p`` of
the log-space rows and the pressure, product rules elsewhere), so the
hydrostatic cancellation never has to survive float32 rounding.
``euler3d_operator(dq, halo_dq, con, pert=base)`` returns ``rhs0 + delta``
and ``euler3d_tangent(dq, v, halo_dq, halo_v, con, pert=base)`` returns
J(q0 + dq).v; the halo glue is ``edge_traces_delta`` (the delta traces,
``t0 * expm1(E.log1p(dq/q0))`` for the log-space rows) and, for the
direction, ``edge_traces_tangent`` at the absolute state with the absolute
traces ``t0 + dt``. The plain versions are ``euler3d_operator_pert_plain``
and ``euler3d_tangent_pert_plain``.
"""

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..common.constants import GRAVITY, HEAT_CAPACITY_RATIO, P0, RD

# Kernel launches made by ``euler3d_operator`` and ``euler3d_tangent`` in
# absolute and perturbation form, and calls of the plain tangents (a run on
# the card must make none).
launches = 0
tangent_launches = 0
pert_launches = 0
pert_tangent_launches = 0
plain_tangent_calls = 0

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
    The time Christoffels of a rotating planet depend on the panel and are
    kept whole (``tch``); on a non-rotating planet they vanish (None)."""

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
    fields: torch.Tensor  # (N_FIELDS, nk, ny, nx, s^3) single panel
    tch: Optional[torch.Tensor]  # (9, 6, nk, ny, nx, s^3) Gamma^a_{0b}, or None
    # Interface metric [sqrt(g), h^{d0}, h^{d1}, h^{d2}] of direction d:
    itf_x: torch.Tensor  # (4, nk, ny, nx+1, s^2)
    itf_y: torch.Tensor  # (4, nk, ny+1, nx, s^2)
    itf_z: torch.Tensor  # (4, nk+1, ny, nx, s^2)

    @property
    def dtype(self) -> torch.dtype:
        return self.fields.dtype

    @property
    def device(self) -> torch.device:
        return self.fields.device

    @property
    def state_shape(self):
        return (5, 6, self.nel_v, self.nel_h, self.nel_h, self.s**3)

    @property
    def traces_shape(self):
        return (5, 4, 6, self.nel_v, self.nel_h, self.s**2)


def _one_panel(a, scale=None) -> np.ndarray:
    """Panel 0 of a field that must be the same on all six panels, to 1e-10
    of its scale (the rounding of the metric build is ~5e-13)."""
    a = np.asarray(a, np.float64)
    tol = 1e-10 * max(np.abs(a).max() if scale is None else scale, 1e-300)
    if np.abs(a - a[:1]).max() > tol:
        raise ValueError("metric field differs across panels (topography is not supported by the operator)")
    return a[0]


def build_constants(ops, metric, nel_h: int, nel_v: int, dtype=torch.float64, device="cpu") -> E3Constants:
    """Operator constants from the 3D DFR operators (``three_d=True``) and
    the 3D metric (host float64 numpy, cast once to ``dtype`` on ``device``)."""
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
    fields = np.stack(
        [_one_panel(metric.sqrtG), _one_panel(metric.inv_sqrtG), _one_panel(metric.inv_dzdeta)]
        + [_one_panel(hc[a, b]) for a, b in H_PAIRS]
        + [_one_panel(ch[a, 3 + j], scale=ch_scale) for a in range(3) for j in range(6)]
        + [_one_panel(wpres)]
    )
    tch = ch[:, :3].reshape((9,) + sg.shape)
    tch = None if not np.any(tch) else tch

    def itf(sqrt_g, h_row):
        scale = np.abs(f64(h_row)).max()
        return np.stack([_one_panel(sqrt_g)] + [_one_panel(h_row[k], scale=scale) for k in range(3)])

    itf_x = itf(metric.sqrtG_itf_i, f64(metric.h_contra_itf_i)[0])
    itf_y = itf(metric.sqrtG_itf_j, f64(metric.h_contra_itf_j)[1])
    itf_z = itf(metric.sqrtG_itf_k, f64(metric.h_contra_itf_k)[2])

    t = lambda a: torch.as_tensor(np.array(a, dtype=np.float64, order="C"), dtype=dtype, device=device)
    return E3Constants(
        nel_h=nel_h, nel_v=nel_v, s=s, ops1d=t(ops1d),
        ee=t(np.concatenate([ops.extrap_x3, ops.extrap_y3, ops.extrap_z3], axis=1)),
        dd=t(np.concatenate([dx, dy, dz], axis=0)), dd3=t(np.concatenate([dx, dy, dz], axis=1)),
        cc=t(np.concatenate([cx, cy, cz], axis=0)), ccb=t(ccb), hfk=t(ops.highfilter_k),
        fields=t(fields), tch=None if tch is None else t(tch),
        itf_x=t(itf_x), itf_y=t(itf_y), itf_z=t(itf_z),
    )


# ---------------------------------------------------------------------------
# Halo glue (plain torch on either device; edge-sized work only)


def _log_rows(q: torch.Tensor) -> torch.Tensor:
    """rho and rho*theta (rows 0 and 4) in log space, the momenta as they are."""
    return torch.cat([torch.log(q[0:1]), q[1:4], torch.log(q[4:5])])


def _exp_rows(t: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.exp(t[0:1]), t[1:4], torch.exp(t[4:5])])


def edge_traces(q: torch.Tensor, con: E3Constants) -> torch.Tensor:
    """Panel-edge face traces of a state, (5, 4, 6, nk, nh, s^2) in
    (S, N, W, E) order — only the edge elements are extrapolated, rho and
    rho*theta in log space."""
    ss, ee = con.s**2, con.ee
    south = _exp_rows(_log_rows(q[:, :, :, 0]) @ ee[:, 2 * ss : 3 * ss])
    north = _exp_rows(_log_rows(q[:, :, :, -1]) @ ee[:, 3 * ss : 4 * ss])
    west = _exp_rows(_log_rows(q[:, :, :, :, 0]) @ ee[:, :ss])
    east = _exp_rows(_log_rows(q[:, :, :, :, -1]) @ ee[:, ss : 2 * ss])
    return torch.stack([south, north, west, east], dim=1)


def edge_traces_tangent(q: torch.Tensor, v: torch.Tensor, con: E3Constants,
                        traces: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Panel-edge traces of the direction ``v`` at the state ``q``: the
    derivative of ``edge_traces`` (the momenta extrapolated linearly, rho
    and rho*theta as ``tr_q * (E.(v/q))``; ``traces``: q's own edge traces,
    computed when None). The counterpart of ``_tangent_pools``
    (pallas_euler3d.py:1950-1970)."""
    if traces is None:
        traces = edge_traces(q, con)
    ss, ee = con.s**2, con.ee
    lt = lambda sl: torch.cat([v[0:1][sl] / q[0:1][sl], v[1:4][sl], v[4:5][sl] / q[4:5][sl]])
    south = lt(np.s_[:, :, :, 0]) @ ee[:, 2 * ss : 3 * ss]
    north = lt(np.s_[:, :, :, -1]) @ ee[:, 3 * ss : 4 * ss]
    west = lt(np.s_[:, :, :, :, 0]) @ ee[:, :ss]
    east = lt(np.s_[:, :, :, :, -1]) @ ee[:, ss : 2 * ss]
    raw = torch.stack([south, north, west, east], dim=1)
    return torch.cat([traces[0:1] * raw[0:1], raw[1:4], traces[4:5] * raw[4:5]])


def halo_from_traces(traces: torch.Tensor, topology) -> torch.Tensor:
    """Outgoing traces -> halos (5, 4, 6, nk, nh, s^2): for each (side,
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
    models/euler_cubesphere.py:90-291, dense 3D operators)."""
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
    out[1] -= forcing_row(0)
    out[2] -= forcing_row(1)
    out[3] -= forcing_row(2) + gravity

    if bal is not None:
        out = out + bal
    if cdt is not None:
        out = b * q + cdt * out
        if a != 0.0:
            out = a * x + out
    if emit_traces:
        return out, edge_traces(out, con)
    return out


# ---------------------------------------------------------------------------
# Perturbation form: base state, delta glue, plain version


@dataclass(frozen=True)
class E3PertBase:
    """The base state of the perturbation form and what every call around
    it shares (the counterpart of ``E3PertBase``/``build_pert_base``,
    pallas_euler3d.py:1847-1896, and of ``_euler3d_base_intermediates``,
    models/euler_cubesphere.py:294-354, in the model layout), computed in
    float64 once and cast to the working dtype. The kernel reads ``q0``,
    ``rhs0`` and ``halo0``; the glue ``traces0``; the plain version the
    rest."""

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
        return {"q0": self.q0, "rhs0": self.rhs0, "halo0": self.halo0}


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


def euler3d_operator_pert_plain(dq, halo, con: E3Constants, pert: E3PertBase):
    """Plain torch version of the perturbation RHS mode: ``rhs0 +
    [RHS(q0 + dq) - RHS(q0)]`` with the bracket expanded term by term
    around the base (the JAX package's ``_euler3d_rhs_core_pert`` with
    ``delta_input``, models/euler_cubesphere.py:357-623). ``halo`` is the
    halo of ``edge_traces_delta(dq)``. The JAX package writes
    ``log1p``/``expm1`` as compensated formulas (pallas_euler3d.py:726-736,
    Mosaic lacks them); torch has them, which moves results by ~1 ulp of
    the small arguments, far below every tolerance the tests state."""
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
    return pert.rhs0 + out


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
        if cdt is not None or bal is not None or emit_traces:
            raise ValueError("the perturbation form runs in RHS mode only (no stage, bal or traces)")
        tensors.update(_pert_tensors(con, pert))
    _check_tensors(con, tensors)


def _pert_tensors(con: E3Constants, pert: E3PertBase) -> dict:
    shapes = {"q0": con.state_shape, "rhs0": con.state_shape, "halo0": con.traces_shape}
    return {name: (t, shapes[name]) for name, t in pert.tensors.items()}


def _check_kernel_shape(con: E3Constants, name: str):
    if con.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name} takes float32 or float64, not {con.dtype}")
    if not (2 <= con.s <= 6) or con.nel_h < 2:
        raise ValueError(f"{name} takes 2 <= s <= 6 and nel_h >= 2, not s={con.s}, nel_h={con.nel_h}")


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
    panel-edge traces (5, 4, 6, nk, nh, s^2). With ``pert`` (RHS mode only)
    ``q`` is the perturbation dq around ``pert.q0`` and ``halo`` the halo of
    its delta traces (``edge_traces_delta``): returns RHS(q0 + dq) as
    ``rhs0 + delta``.

    A CPU tensor runs ``euler3d_operator_plain`` (``euler3d_operator_pert_plain``);
    a CUDA tensor launches the kernel (built from csrc/euler3d_operator.cu at
    first use) on the current stream, without synchronising, or raises."""
    global launches, pert_launches
    _check(q, halo, con, x, a, bal, cdt, emit_traces, pert)
    if q.device.type == "cpu":
        if pert is not None:
            return euler3d_operator_pert_plain(q, halo, con, pert)
        return euler3d_operator_plain(q, halo, con, x=x, a=a, b=b, cdt=cdt, bal=bal, emit_traces=emit_traces)
    if q.device.type != "cuda":
        raise ValueError(f"euler3d_operator runs on cpu or cuda tensors, not {q.device}")
    _check_kernel_shape(con, "euler3d_operator")

    from ..kernels.build import load_library

    lib = load_library("euler3d_operator")
    use_x = cdt is not None and a != 0.0
    out = torch.empty_like(q)
    traces = torch.empty(con.traces_shape, dtype=q.dtype, device=q.device) if emit_traces else None
    base = pert.tensors if pert is not None else {}
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.euler3d_operator_launch(
            1 if q.dtype == torch.float64 else 0, con.s, con.nel_h, con.nel_v,
            _ptr(q), _ptr(halo), _ptr(con.ops1d), _ptr(con.fields), _ptr(con.tch),
            _ptr(con.itf_x), _ptr(con.itf_y), _ptr(con.itf_z), _ptr(x if use_x else None), _ptr(bal),
            _ptr(base.get("q0")), _ptr(base.get("halo0")), _ptr(base.get("rhs0")),
            _ptr(out), _ptr(traces), float(a), float(b), float(cdt if cdt is not None else 0.0),
            1 if cdt is not None else 0, ctypes.c_void_p(stream),
        )
    if rc != 0:
        name = lib.euler3d_operator_error_string(rc).decode()
        raise RuntimeError(f"euler3d_operator kernel launch failed: CUDA error {rc} ({name})")
    if pert is not None:
        pert_launches += 1
    else:
        launches += 1
    return (out, traces) if emit_traces else out


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


def euler3d_tangent(q, v, halo_q, halo_v, con: E3Constants, pert: Optional[E3PertBase] = None):
    """The Jacobian action J(q).v of the operator in RHS mode (no stage,
    ``bal`` or traces), with ``halo_q`` q's neighbour halos and ``halo_v``
    the direction's (both (5, 4, 6, nk, nh, s^2)). With ``pert``, ``q`` is
    the perturbation dq around ``pert.q0`` and ``halo_q`` its delta halo:
    returns J(q0 + dq).v, the primal perturbation intermediates serving as
    the linearisation coefficients.

    A CPU tensor runs ``euler3d_tangent_plain`` (``euler3d_tangent_pert_plain``);
    a CUDA tensor launches the kernel's tangent mode (csrc/euler3d_operator.cu)
    on the current stream, without synchronising, or raises."""
    global tangent_launches, pert_tangent_launches
    tensors = {"q": (q, con.state_shape), "v": (v, con.state_shape),
               "halo_q": (halo_q, con.traces_shape), "halo_v": (halo_v, con.traces_shape)}
    if pert is not None:
        tensors.update(_pert_tensors(con, pert))
    _check_tensors(con, tensors)
    if q.device.type == "cpu":
        if pert is not None:
            return euler3d_tangent_pert_plain(q, v, halo_q, halo_v, con, pert)
        return euler3d_tangent_plain(q, v, halo_q, halo_v, con)
    if q.device.type != "cuda":
        raise ValueError(f"euler3d_tangent runs on cpu or cuda tensors, not {q.device}")
    _check_kernel_shape(con, "euler3d_tangent")

    from ..kernels.build import load_library

    lib = load_library("euler3d_operator")
    out = torch.empty_like(q)
    base = pert.tensors if pert is not None else {}
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.euler3d_tangent_launch(
            1 if q.dtype == torch.float64 else 0, con.s, con.nel_h, con.nel_v,
            _ptr(q), _ptr(v), _ptr(halo_q), _ptr(halo_v), _ptr(con.ops1d), _ptr(con.fields), _ptr(con.tch),
            _ptr(con.itf_x), _ptr(con.itf_y), _ptr(con.itf_z), _ptr(base.get("q0")), _ptr(base.get("halo0")),
            _ptr(out), ctypes.c_void_p(stream),
        )
    if rc != 0:
        name = lib.euler3d_operator_error_string(rc).decode()
        raise RuntimeError(f"euler3d_tangent kernel launch failed: CUDA error {rc} ({name})")
    if pert is not None:
        pert_tangent_launches += 1
    else:
        tangent_launches += 1
    return out
