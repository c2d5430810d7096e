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
"""

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..common.constants import GRAVITY, HEAT_CAPACITY_RATIO, P0, RD

# Kernel launches made by ``euler3d_operator`` and ``euler3d_tangent``, and
# calls of the plain tangent (a run on the card must make none).
launches = 0
tangent_launches = 0
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


def euler3d_operator_plain(q, halo, con: E3Constants, x=None, a: float = 0.0, b: float = 1.0,
                           cdt: Optional[float] = None, bal=None, emit_traces: bool = False):
    """Plain torch version of the operator; same arguments and results as
    ``euler3d_operator`` (written from the JAX package's
    models/euler_cubesphere.py:90-291, dense 3D operators)."""
    ss, s3 = con.s**2, con.s**3
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
    west, east = itf[..., :ss], itf[..., ss : 2 * ss]
    south, north = itf[..., 2 * ss : 3 * ss], itf[..., 3 * ss : 4 * ss]
    bot, top = itf[..., 4 * ss : 5 * ss], itf[..., 5 * ss :]
    hs, hn, hw, he = halo[:, 0], halo[:, 1], halo[:, 2], halo[:, 3]

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
    qL_x = torch.cat([hw.unsqueeze(-2), east], dim=-2)
    qR_x = torch.cat([west, he.unsqueeze(-2)], dim=-2)
    qL_y = torch.cat([hs.unsqueeze(-3), north], dim=-3)
    qR_y = torch.cat([south, hn.unsqueeze(-3)], dim=-3)
    qL_z = torch.cat([bot[:, :, 0:1], top], dim=2)
    qR_z = torch.cat([bot, top[:, :, -1:]], dim=2)
    w_bot, w_top = bot[3] / bot[0], top[3] / top[0]
    fam = {
        0: _rusanov(qL_x, qR_x, qL_x[1] / qL_x[0], qR_x[1] / qR_x[0], con.itf_x, 0),
        1: _rusanov(qL_y, qR_y, qL_y[2] / qL_y[0], qR_y[2] / qR_y[0], con.itf_y, 1),
        2: _rusanov(qL_z, qR_z, torch.cat([-w_bot[:, 0:1], w_top], dim=1),
                    torch.cat([w_bot, -w_top[:, -1:]], dim=1), con.itf_z, 2),
    }

    # 4. Boundary corrections: the element's own-side face pressures divide
    # the w-pressure flux and give the face log p.
    bund, lpf = [], []
    for d, dim in ((0, -2), (1, -3), (2, -4)):
        f, wadv, wpres, pL, pR = fam[d]
        n = pL.shape[dim] - 1
        p_neg, p_pos = pR.narrow(dim, 0, n), pL.narrow(dim, 1, n)
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


def _check(q, halo, con: E3Constants, x, a: float, bal):
    """Shape, dtype, device and contiguity of the tensors the operator reads."""
    tensors = {"q": (q, con.state_shape), "halo": (halo, con.traces_shape)}
    if a != 0.0:
        if x is None:
            raise ValueError("stage with a != 0 needs x")
        tensors["x"] = (x, con.state_shape)
    if bal is not None:
        tensors["bal"] = (bal, con.state_shape)
    _check_tensors(con, tensors)


def _check_kernel_shape(con: E3Constants, name: str):
    if con.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name} takes float32 or float64, not {con.dtype}")
    if not (2 <= con.s <= 6) or con.nel_h < 2:
        raise ValueError(f"{name} takes 2 <= s <= 6 and nel_h >= 2, not s={con.s}, nel_h={con.nel_h}")


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def euler3d_operator(q, halo, con: E3Constants, x=None, a: float = 0.0, b: float = 1.0,
                     cdt: Optional[float] = None, bal=None, emit_traces: bool = False):
    """The 3D Euler operator on ``q`` (5, 6, nk, ny, nx, s^3) with neighbour
    halos ``halo`` (5, 4, 6, nk, nh, s^2).

    RHS mode (``cdt is None``): returns RHS(q) (+ ``bal`` when given).
    Stage mode: returns ``a*x + b*q + cdt*(RHS(q) + bal)`` (``x`` is read
    only when ``a != 0``). With ``emit_traces`` also returns the output's
    panel-edge traces (5, 4, 6, nk, nh, s^2).

    A CPU tensor runs ``euler3d_operator_plain``; a CUDA tensor launches the
    kernel (built from csrc/euler3d_operator.cu at first use) on the current
    stream, without synchronising, or raises."""
    global launches
    _check(q, halo, con, x, a, bal)
    if q.device.type == "cpu":
        return euler3d_operator_plain(q, halo, con, x=x, a=a, b=b, cdt=cdt, bal=bal, emit_traces=emit_traces)
    if q.device.type != "cuda":
        raise ValueError(f"euler3d_operator runs on cpu or cuda tensors, not {q.device}")
    _check_kernel_shape(con, "euler3d_operator")

    from ..kernels.build import load_library

    lib = load_library("euler3d_operator")
    use_x = cdt is not None and a != 0.0
    out = torch.empty_like(q)
    traces = torch.empty(con.traces_shape, dtype=q.dtype, device=q.device) if emit_traces else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.euler3d_operator_launch(
            1 if q.dtype == torch.float64 else 0, con.s, con.nel_h, con.nel_v,
            _ptr(q), _ptr(halo), _ptr(con.ops1d), _ptr(con.fields), _ptr(con.tch),
            _ptr(con.itf_x), _ptr(con.itf_y), _ptr(con.itf_z), _ptr(x if use_x else None), _ptr(bal),
            _ptr(out), _ptr(traces), float(a), float(b), float(cdt if cdt is not None else 0.0),
            1 if cdt is not None else 0, ctypes.c_void_p(stream),
        )
    if rc != 0:
        name = lib.euler3d_operator_error_string(rc).decode()
        raise RuntimeError(f"euler3d_operator kernel launch failed: CUDA error {rc} ({name})")
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


def euler3d_tangent(q, v, halo_q, halo_v, con: E3Constants):
    """The Jacobian action J(q).v of the operator in RHS mode (no stage,
    ``bal`` or traces), with ``halo_q`` q's neighbour halos and ``halo_v``
    the direction's (both (5, 4, 6, nk, nh, s^2)).

    A CPU tensor runs ``euler3d_tangent_plain``; a CUDA tensor launches the
    kernel's tangent mode (csrc/euler3d_operator.cu) on the current stream,
    without synchronising, or raises."""
    global tangent_launches
    _check_tensors(con, {"q": (q, con.state_shape), "v": (v, con.state_shape),
                         "halo_q": (halo_q, con.traces_shape), "halo_v": (halo_v, con.traces_shape)})
    if q.device.type == "cpu":
        return euler3d_tangent_plain(q, v, halo_q, halo_v, con)
    if q.device.type != "cuda":
        raise ValueError(f"euler3d_tangent runs on cpu or cuda tensors, not {q.device}")
    _check_kernel_shape(con, "euler3d_tangent")

    from ..kernels.build import load_library

    lib = load_library("euler3d_operator")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.euler3d_tangent_launch(
            1 if q.dtype == torch.float64 else 0, con.s, con.nel_h, con.nel_v,
            _ptr(q), _ptr(v), _ptr(halo_q), _ptr(halo_v), _ptr(con.ops1d), _ptr(con.fields), _ptr(con.tch),
            _ptr(con.itf_x), _ptr(con.itf_y), _ptr(con.itf_z), _ptr(out), ctypes.c_void_p(stream),
        )
    if rc != 0:
        name = lib.euler3d_operator_error_string(rc).decode()
        raise RuntimeError(f"euler3d_tangent kernel launch failed: CUDA error {rc} ({name})")
    tangent_launches += 1
    return out
