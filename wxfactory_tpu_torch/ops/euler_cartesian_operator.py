"""The 2D Cartesian Euler operators: the DFR and finite-volume right-hand
sides, their Jacobian actions, their CUDA kernels' wrappers, their plain
torch versions and their constants.

Counterpart of the XLA right-hand sides ``make_rhs_euler_cartesian``
(``wxfactory_tpu/models/euler_cartesian.py:115-186``) and
``make_rhs_euler_cartesian_fv`` (``models/euler_cartesian_fv.py:64-92``) of
the JAX package, and of ``jax.jvp`` of each (its integrators' and
multigrid levels' Jacobian action). The JAX package runs no Pallas kernel
here; the port's card path runs the four kernels of
``csrc/euler_cartesian.cu``:

* ``euler_cartesian``: the DFR RHS, or an RK stage ``a*x + b*q +
  cdt*RHS(q)``, one launch (``euler_cartesian_operator_kernel``), counted in
  ``launches``;
* ``euler_cartesian_tangent``: J(q).v of the DFR RHS, one launch of the
  same element body over a dual number (value, tangent), counted in
  ``tangent_launches``;
* ``euler_cartesian_fv``: the FV RHS with the flux (ausm, rusanov, upwind)
  of its constants, one launch, counted in ``fv_launches``;
* ``euler_cartesian_fv_tangent``: J(q).v of the FV RHS, one launch,
  counted in ``fv_tangent_launches``: the multigrid's coarse levels take
  only this (no path of the port calls the FV RHS itself).

A CPU tensor runs the plain version (``*_plain``; counted in
``plain_calls`` and ``plain_tangent_calls``), a CUDA tensor launches the
kernel or raises: no fallback between them.

The DFR state is ``Q[4, nel_z, nel_x, s^2]`` = (rho, rho*u, rho*w,
rho*theta), node ``kz*s + kx``; the FV state ``Q[4, ncell_z, ncell_x]``
(a trailing axis of 1, the multigrid levels' s = 1 view, is taken and
given back). Rigid walls bound the domain on all four sides.

The plain tangents are ``torch.func.jvp`` of the plain RHS, which follows
``jax.jvp`` at every tie the functions have (``maximum(0, m)`` and
``minimum(0, m)`` at m = 0 give half the tangent in both; rusanov's
``maximum`` of the two speeds half of each), except ``abs``: torch's
derivative of |v| at v = 0 is 0, JAX's +1, so the rusanov flux takes |v|
as ``where(v >= 0, v, -v)``, whose derivative is JAX's and whose value is
the same.
"""

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..common.constants import (GRAVITY, HEAT_CAPACITY_RATIO, IDX_2D_RHO, IDX_2D_RHO_THETA, IDX_2D_RHO_U,
                                IDX_2D_RHO_W, P0, RD)

# Kernel launches of the four wrappers, and calls of the plain operators
# (DFR and FV) and of the plain tangents (a run on the card makes none).
launches = 0
tangent_launches = 0
fv_launches = 0
fv_tangent_launches = 0
plain_calls = 0
plain_tangent_calls = 0

# The orders the DFR kernels are instantiated for.
KERNEL_SOLPTS = (2, 3, 4, 5, 6)
# The FV fluxes, in the kernels' numbering.
FV_FLUXES = ("ausm", "rusanov", "upwind")


@dataclass(frozen=True)
class ECConstants:
    """The DFR operator's constants on one device and dtype: the JAX
    package's fused ``EE`` (s^2, 4s), ``DD`` (2s^2, s^2) and ``CC`` (4s,
    s^2), -2/dx and -2/dz folded into the last two, and the kernel's 1D
    factors ``ops1d``: en (s) | ep (s) | Dx (s, s) | Dz (s, s) | cxn (s) |
    cxp (s) | czn (s) | czp (s), with D[j, i] = d l_i/dx at node j times
    -2/dx (-2/dz) and the corrections' columns at -1 and +1 times the same."""

    s: int
    nel_x: int
    nel_z: int
    dtype: torch.dtype
    device: torch.device
    ee: torch.Tensor
    dd: torch.Tensor
    cc: torch.Tensor
    ops1d: torch.Tensor

    @property
    def state_shape(self):
        return (4, self.nel_z, self.nel_x, self.s * self.s)


def build_constants(geom, ops, dtype=torch.float64, device="cpu") -> ECConstants:
    """The DFR constants of a ``Cartesian2D`` and its ``DFROperators``."""
    s = ops.num_solpts
    scale_x = -2.0 / geom.delta_x1
    scale_z = -2.0 / geom.delta_x3
    ee = np.concatenate([ops.extrap_x, ops.extrap_z], axis=1)
    dd = np.concatenate([scale_x * ops.derivative_x, scale_z * ops.derivative_z], axis=0)
    cc = np.concatenate([scale_x * ops.correction_WE, scale_z * ops.correction_DU], axis=0)
    cn, cp = ops.diff_ext[1:-1, 0], ops.diff_ext[1:-1, -1]
    ops1d = np.concatenate([ops.extrap_neg, ops.extrap_pos, (scale_x * ops.diff_solpt).ravel(),
                            (scale_z * ops.diff_solpt).ravel(), scale_x * cn, scale_x * cp, scale_z * cn,
                            scale_z * cp])
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    ee = t(ee)
    # The tensors' own device ("cuda:0", not "cuda"), which the wrappers compare.
    return ECConstants(s=s, nel_x=geom.num_elements_x, nel_z=geom.num_elements_z, dtype=dtype, device=ee.device,
                       ee=ee, dd=t(dd), cc=t(cc), ops1d=t(ops1d))


@dataclass(frozen=True)
class ECFVConstants:
    """The FV operator's constants: the cell grid, the cell sizes and the
    interface flux."""

    ncell_x: int
    ncell_z: int
    dx: float
    dz: float
    flux: str
    dtype: torch.dtype
    device: torch.device


def build_fv_constants(geom, flux: str = "ausm", dtype=torch.float64, device="cpu") -> ECFVConstants:
    """The FV constants of a ``Cartesian2D``: one cell per element (its
    num_solpts = 1 view), as the JAX factory takes it."""
    if flux not in FV_FLUXES:
        raise ValueError(f"unknown FV flux {flux!r} (one of {', '.join(FV_FLUXES)})")
    return ECFVConstants(ncell_x=geom.num_elements_x, ncell_z=geom.num_elements_z, dx=geom.delta_x1,
                         dz=geom.delta_x3, flux=flux, dtype=dtype, device=torch.empty(0, device=device).device)


# ---------------------------------------------------------------------------
# The physics of the JAX package's models/euler_cartesian.py, on tensors


def pressure(rho_theta: torch.Tensor) -> torch.Tensor:
    """Equation of state p = p0 (Rd rho*theta / p0)^gamma, in the exp/log
    form of the JAX package (and of the reference's kernels)."""
    return P0 * torch.exp(HEAT_CAPACITY_RATIO * torch.log((RD / P0) * rho_theta))


def pointwise_fluxes(q: torch.Tensor):
    """The Euler fluxes F_x, F_z at every solution point."""
    rho, rho_u, rho_w, rho_theta = q[IDX_2D_RHO], q[IDX_2D_RHO_U], q[IDX_2D_RHO_W], q[IDX_2D_RHO_THETA]
    inv_rho = 1.0 / rho
    u = rho_u * inv_rho
    w = rho_w * inv_rho
    p = pressure(rho_theta)
    flux_x = torch.stack([rho_u, rho_u * u + p, rho_u * w, rho_theta * u])
    flux_z = torch.stack([rho_w, rho_w * u, rho_w * w + p, rho_theta * w])
    return flux_x, flux_z


def _max0(m):
    return torch.maximum(torch.zeros_like(m), m)


def _min0(m):
    return torch.minimum(torch.zeros_like(m), m)


def ausm_flux(ql: torch.Tensor, qr: torch.Tensor, direction: int) -> torch.Tensor:
    """The DFR model's AUSM interface flux between left and right face
    states (4, ...); ``direction`` 0 = x, 1 = z. The normal momentum row
    carries the pressure term only, as in the JAX package (its FV ausm adds
    the advected normal momentum too)."""
    rho_l, rho_r = ql[IDX_2D_RHO], qr[IDX_2D_RHO]
    rho_u_l, rho_u_r = ql[IDX_2D_RHO_U], qr[IDX_2D_RHO_U]
    rho_w_l, rho_w_r = ql[IDX_2D_RHO_W], qr[IDX_2D_RHO_W]
    rho_t_l, rho_t_r = ql[IDX_2D_RHO_THETA], qr[IDX_2D_RHO_THETA]

    inv_rho_l = 1.0 / rho_l
    inv_rho_r = 1.0 / rho_r
    p_l = pressure(rho_t_l)
    p_r = pressure(rho_t_r)
    a_l = torch.sqrt(HEAT_CAPACITY_RATIO * p_l * inv_rho_l)
    a_r = torch.sqrt(HEAT_CAPACITY_RATIO * p_r * inv_rho_r)

    if direction == 0:
        vn_l = rho_u_l * inv_rho_l
        vn_r = rho_u_r * inv_rho_r
    else:
        vn_l = rho_w_l * inv_rho_l
        vn_r = rho_w_r * inv_rho_r

    m_l = vn_l / a_l + 1.0
    m_r = vn_r / a_r - 1.0
    m = 0.25 * (m_l * m_l - m_r * m_r)
    m_max = _max0(m) * a_l
    m_min = _min0(m) * a_r

    f_rho = rho_l * m_max + rho_r * m_min
    f_theta = rho_t_l * m_max + rho_t_r * m_min
    p_half = 0.5 * (m_l * p_l - m_r * p_r)
    if direction == 0:
        f_rho_u = p_half
        f_rho_w = rho_w_l * m_max + rho_w_r * m_min
    else:
        f_rho_u = rho_u_l * m_max + rho_u_r * m_min
        f_rho_w = p_half
    return torch.stack([f_rho, f_rho_u, f_rho_w, f_theta])


def wall_flux(q_face: torch.Tensor, direction: int) -> torch.Tensor:
    """Rigid-wall flux: only the pressure term of the normal momentum."""
    p = pressure(q_face[IDX_2D_RHO_THETA])
    zero = torch.zeros_like(p)
    if direction == 0:
        return torch.stack([zero, p, zero, zero])
    return torch.stack([zero, zero, p, zero])


def _with_gravity(out: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``out`` with -rho g added to the rho*w row."""
    return torch.cat([out[:IDX_2D_RHO_W], (out[IDX_2D_RHO_W] + (-q[IDX_2D_RHO] * GRAVITY))[None],
                      out[IDX_2D_RHO_W + 1:]])


def _rhs(q: torch.Tensor, con: ECConstants) -> torch.Tensor:
    """The DFR RHS of the JAX package step by step: extrapolation, pointwise
    fluxes and their scaled divergence, AUSM at interior interfaces and
    walls on the four sides, the boundary correction, gravity."""
    s = con.s
    itf = q @ con.ee
    q_itf_x = itf[..., : 2 * s]
    q_itf_z = itf[..., 2 * s:]

    f_x, f_z = pointwise_fluxes(q)
    df = torch.cat([f_x, f_z], dim=-1) @ con.dd

    f_interior_x = ausm_flux(q_itf_x[..., :-1, s:], q_itf_x[..., 1:, :s], 0)
    f_wall_w = wall_flux(q_itf_x[..., 0:1, :s], 0)
    f_wall_e = wall_flux(q_itf_x[..., -1:, s:], 0)
    f_itf_x = torch.cat([torch.cat([f_wall_w, f_interior_x], dim=-2),
                         torch.cat([f_interior_x, f_wall_e], dim=-2)], dim=-1)

    f_interior_z = ausm_flux(q_itf_z[..., :-1, :, s:], q_itf_z[..., 1:, :, :s], 1)
    f_wall_b = wall_flux(q_itf_z[..., 0:1, :, :s], 1)
    f_wall_t = wall_flux(q_itf_z[..., -1:, :, s:], 1)
    f_itf_z = torch.cat([torch.cat([f_wall_b, f_interior_z], dim=-3),
                         torch.cat([f_interior_z, f_wall_t], dim=-3)], dim=-1)

    out = df + torch.cat([f_itf_x, f_itf_z], dim=-1) @ con.cc
    return _with_gravity(out, q)


def _stage(out, q, x, a: float, b: float, cdt: Optional[float]):
    """The RK stage combination ``a*x + b*q + cdt*out`` (``x`` read only
    when ``a != 0``); ``out`` itself in RHS mode (``cdt is None``)."""
    if cdt is None:
        return out
    out = b * q + cdt * out
    return a * x + out if a != 0.0 else out


def euler_cartesian_plain(q, con: ECConstants, x=None, a: float = 0.0, b: float = 1.0,
                          cdt: Optional[float] = None) -> torch.Tensor:
    """Plain torch version of ``euler_cartesian``, same arguments and
    result. Counted in ``plain_calls``."""
    global plain_calls
    plain_calls += 1
    return _stage(_rhs(q, con), q, x, a, b, cdt)


def euler_cartesian_tangent_plain(q, v, con: ECConstants) -> torch.Tensor:
    """Plain torch version of ``euler_cartesian_tangent``:
    ``torch.func.jvp`` of the plain RHS at q in the direction v. Counted in
    ``plain_tangent_calls``."""
    global plain_tangent_calls
    plain_tangent_calls += 1
    return torch.func.jvp(lambda q_: _rhs(q_, con), (q,), (v,))[1]


# ---------------------------------------------------------------------------
# The finite-volume RHS of the JAX package's models/euler_cartesian_fv.py


def _add_row(f: torch.Tensor, row: int, value: torch.Tensor) -> torch.Tensor:
    """``f.at[row].add(value)``."""
    return torch.stack([f[i] + value if i == row else f[i] for i in range(f.shape[0])])


def _abs_jax(v: torch.Tensor) -> torch.Tensor:
    """|v| with jax.jvp's derivative at 0 (+1; torch's abs gives 0)."""
    return torch.where(v >= 0, v, -v)


def _fv_ausm(ql, qr, pl, pr, normal: int):
    al = torch.sqrt(HEAT_CAPACITY_RATIO * pl / ql[IDX_2D_RHO])
    ar = torch.sqrt(HEAT_CAPACITY_RATIO * pr / qr[IDX_2D_RHO])
    ml = ql[normal] / (ql[IDX_2D_RHO] * al)
    mr = qr[normal] / (qr[IDX_2D_RHO] * ar)
    m = 0.25 * ((ml + 1.0) * (ml + 1.0) - (mr - 1.0) * (mr - 1.0))
    flux = ql * _max0(m) * al + qr * _min0(m) * ar
    return _add_row(flux, normal, 0.5 * ((1.0 + ml) * pl + (1.0 - mr) * pr))


def _fv_rusanov(ql, qr, pl, pr, normal: int):
    al = torch.sqrt(HEAT_CAPACITY_RATIO * pl / ql[IDX_2D_RHO])
    ar = torch.sqrt(HEAT_CAPACITY_RATIO * pr / qr[IDX_2D_RHO])
    vl = ql[normal] / ql[IDX_2D_RHO]
    vr = qr[normal] / qr[IDX_2D_RHO]
    eig = torch.maximum(_abs_jax(vl) + al, _abs_jax(vr) + ar)
    fl = _add_row(ql * vl, normal, pl)
    fr = _add_row(qr * vr, normal, pr)
    return 0.5 * (fl + fr - eig * (qr - ql))


def _fv_upwind(ql, qr, pl, pr, normal: int):
    vsum = ql[normal] + qr[normal]
    fl = _add_row(ql * (ql[normal] / ql[IDX_2D_RHO]), normal, pl)
    fr = _add_row(qr * (qr[normal] / qr[IDX_2D_RHO]), normal, pr)
    return torch.where(vsum > 0, fl, fr)


_FV = {"ausm": _fv_ausm, "rusanov": _fv_rusanov, "upwind": _fv_upwind}


def _fv_rhs(q: torch.Tensor, con: ECFVConstants) -> torch.Tensor:
    """The FV RHS on (4, ncell_z, ncell_x): the selected flux at interior
    interfaces, pressure-only walls, the flux difference, gravity."""
    riemann = _FV[con.flux]
    p = pressure(q[IDX_2D_RHO_THETA])

    fx = riemann(q[:, :, :-1], q[:, :, 1:], p[:, :-1], p[:, 1:], IDX_2D_RHO_U)
    zerocol = torch.zeros_like(fx[:, :, :1])
    wall_w = _add_row(zerocol, IDX_2D_RHO_U, p[:, :1])
    wall_e = _add_row(zerocol, IDX_2D_RHO_U, p[:, -1:])
    fx_all = torch.cat([wall_w, fx, wall_e], dim=2)

    fz = riemann(q[:, :-1, :], q[:, 1:, :], p[:-1, :], p[1:, :], IDX_2D_RHO_W)
    zerorow = torch.zeros_like(fz[:, :1, :])
    wall_b = _add_row(zerorow, IDX_2D_RHO_W, p[:1, :])
    wall_t = _add_row(zerorow, IDX_2D_RHO_W, p[-1:, :])
    fz_all = torch.cat([wall_b, fz, wall_t], dim=1)

    out = -(fx_all[:, :, 1:] - fx_all[:, :, :-1]) / con.dx - (fz_all[:, 1:, :] - fz_all[:, :-1, :]) / con.dz
    return _with_gravity(out, q)


def _cells(q: torch.Tensor, con: ECFVConstants) -> torch.Tensor:
    """The (4, ncell_z, ncell_x) view of an FV state with or without its
    trailing axis of 1."""
    return q.reshape(4, con.ncell_z, con.ncell_x)


def euler_cartesian_fv_plain(q, con: ECFVConstants) -> torch.Tensor:
    """Plain torch version of ``euler_cartesian_fv``: the FV RHS in q's
    shape. Counted in ``plain_calls``."""
    global plain_calls
    plain_calls += 1
    return _fv_rhs(_cells(q, con), con).reshape(q.shape)


def euler_cartesian_fv_tangent_plain(q, v, con: ECFVConstants) -> torch.Tensor:
    """Plain torch version of ``euler_cartesian_fv_tangent``:
    ``torch.func.jvp`` of the plain FV RHS. Counted in ``plain_tangent_calls``."""
    global plain_tangent_calls
    plain_tangent_calls += 1
    out = torch.func.jvp(lambda q_: _fv_rhs(q_, con), (_cells(q, con),), (_cells(v, con),))[1]
    return out.reshape(q.shape)


# ---------------------------------------------------------------------------
# The wrappers


def _check_tensors(con, tensors: dict):
    """Shape, dtype, device and contiguity of {name: (tensor, shape)}."""
    for name, (t, shape) in tensors.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
        if t.dtype != con.dtype or t.device != con.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; constants are {con.dtype} on {con.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _library(t: torch.Tensor, name: str):
    """The kernel library for a launch on ``t``'s device (built at first use)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {t.device}")
    if t.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name} takes float32 or float64, not {t.dtype}")
    from ..kernels.build import load_library

    return load_library("euler_cartesian")


def _check_rc(lib, rc: int, entry: str) -> None:
    if rc != 0:
        name = lib.euler_cartesian_error_string(rc).decode()
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc} ({name})")


def _check_solpts(con: ECConstants, name: str) -> None:
    if con.s not in KERNEL_SOLPTS:
        raise ValueError(f"{name}: the DFR kernels take s = {KERNEL_SOLPTS[0]}..{KERNEL_SOLPTS[-1]} solution "
                         f"points, not {con.s}")


def euler_cartesian(q, con: ECConstants, x=None, a: float = 0.0, b: float = 1.0,
                    cdt: Optional[float] = None) -> torch.Tensor:
    """The DFR RHS of ``q`` (4, nel_z, nel_x, s^2) in RHS mode (``cdt is
    None``), or the stage ``a*x + b*q + cdt*RHS(q)`` (``x`` read only when
    ``a != 0``). A CPU tensor runs ``euler_cartesian_plain``; a CUDA tensor
    makes one launch of ``euler_cartesian_operator_kernel`` on the current stream,
    without synchronising, counted in ``launches``, or raises (s = 2..6)."""
    global launches
    tensors = {"q": (q, con.state_shape)}
    use_x = cdt is not None and a != 0.0
    if use_x:
        if x is None:
            raise ValueError("stage with a != 0 needs x")
        tensors["x"] = (x, con.state_shape)
    _check_tensors(con, tensors)
    if q.device.type == "cpu":
        return euler_cartesian_plain(q, con, x=x, a=a, b=b, cdt=cdt)
    _check_solpts(con, "euler_cartesian")
    lib = _library(q, "euler_cartesian")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.euler_cartesian_launch(
            1 if q.dtype == torch.float64 else 0, con.s, con.nel_x, con.nel_z, _ptr(q), _ptr(con.ops1d),
            _ptr(x if use_x else None), _ptr(out), float(a), float(b), float(cdt if cdt is not None else 0.0),
            1 if cdt is not None else 0, ctypes.c_void_p(stream))
    _check_rc(lib, rc, "euler_cartesian_launch")
    launches += 1
    return out


def euler_cartesian_tangent(q, v, con: ECConstants) -> torch.Tensor:
    """J(q).v of the DFR RHS. A CPU tensor runs
    ``euler_cartesian_tangent_plain``; a CUDA tensor makes one launch of
    ``euler_cartesian_tangent_kernel`` (q and v read once), counted in
    ``tangent_launches``, or raises."""
    global tangent_launches
    _check_tensors(con, {"q": (q, con.state_shape), "v": (v, con.state_shape)})
    if q.device.type == "cpu":
        return euler_cartesian_tangent_plain(q, v, con)
    _check_solpts(con, "euler_cartesian_tangent")
    lib = _library(q, "euler_cartesian_tangent")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.euler_cartesian_tangent_launch(
            1 if q.dtype == torch.float64 else 0, con.s, con.nel_x, con.nel_z, _ptr(q), _ptr(v), _ptr(con.ops1d),
            _ptr(out), ctypes.c_void_p(stream))
    _check_rc(lib, rc, "euler_cartesian_tangent_launch")
    tangent_launches += 1
    return out


def _fv_shapes(q, con: ECFVConstants):
    cells = (4, con.ncell_z, con.ncell_x)
    if tuple(q.shape) not in (cells, cells + (1,)):
        raise ValueError(f"FV state shape {tuple(q.shape)}, not {cells} (or with a trailing 1)")
    return tuple(q.shape)


def euler_cartesian_fv(q, con: ECFVConstants) -> torch.Tensor:
    """The FV RHS of ``q`` (4, ncell_z, ncell_x[, 1]) in q's shape. A CPU
    tensor runs ``euler_cartesian_fv_plain``; a CUDA tensor makes one launch
    of ``euler_cartesian_fv_kernel`` with the constants' flux, counted in
    ``fv_launches``, or raises."""
    global fv_launches
    _check_tensors(con, {"q": (q, _fv_shapes(q, con))})
    if q.device.type == "cpu":
        return euler_cartesian_fv_plain(q, con)
    lib = _library(q, "euler_cartesian_fv")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.euler_cartesian_fv_launch(
            1 if q.dtype == torch.float64 else 0, FV_FLUXES.index(con.flux), con.ncell_x, con.ncell_z, _ptr(q),
            _ptr(out), float(con.dx), float(con.dz), ctypes.c_void_p(stream))
    _check_rc(lib, rc, "euler_cartesian_fv_launch")
    fv_launches += 1
    return out


def euler_cartesian_fv_tangent(q, v, con: ECFVConstants) -> torch.Tensor:
    """J(q).v of the FV RHS, in q's shape. A CPU tensor runs
    ``euler_cartesian_fv_tangent_plain``; a CUDA tensor makes one launch of
    ``euler_cartesian_fv_tangent_kernel``, counted in
    ``fv_tangent_launches``, or raises."""
    global fv_tangent_launches
    shape = _fv_shapes(q, con)
    _check_tensors(con, {"q": (q, shape), "v": (v, shape)})
    if q.device.type == "cpu":
        return euler_cartesian_fv_tangent_plain(q, v, con)
    lib = _library(q, "euler_cartesian_fv_tangent")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.euler_cartesian_fv_tangent_launch(
            1 if q.dtype == torch.float64 else 0, FV_FLUXES.index(con.flux), con.ncell_x, con.ncell_z, _ptr(q),
            _ptr(v), _ptr(out), float(con.dx), float(con.dz), ctypes.c_void_p(stream))
    _check_rc(lib, rc, "euler_cartesian_fv_tangent_launch")
    fv_tangent_launches += 1
    return out
