"""The whole shallow-water DFR spatial operator: CUDA kernel, its wrapper,
its plain torch version, its constants and the halo glue.

Counterpart of ``wxfactory_tpu/ops/pallas_sw_gen.py`` (``km_gen`` and the
glue ``packed_slabs`` / ``halo_from_slabs``) without the TPU layout
machinery: the state stays in the model layout ``Q[3, 6, nel, nel, s^2]``
(h, h*u1, h*u2), element ``(panel, ey, ex)``, node ``ky * s + kx``.

One operator call computes, for every element, the extrapolation to faces,
the sqrt(g)-weighted pointwise fluxes, the interior divergence, the AUSM
Mach-splitting interface fluxes, the boundary correction and the
Coriolis/Christoffel forcing (reference rhs_sw.py:81-238), optionally fused
with an RK stage combination ``a*x + b*q + cdt*RHS(q)`` and the output
state's panel-edge traces for the next stage's halo.

Panel-edge data travel as TRACES ``(3, 4, 6, nel, s)``: variable, side
(S, N, W, E — the topology's side order), panel, element along the edge,
point along the edge. ``edge_traces`` extracts them from a state (the
bootstrap glue), the kernel emits them from its output, and
``halo_from_traces`` turns them into the neighbour halos the operator
consumes (same layout; exchange with edge flips + 2x2 contravariant
rotation of the momenta). West/south panel-edge interfaces take qL from the
halo, east/north take qR from it.

``sw_operator`` runs the CUDA kernel for a CUDA tensor and
``sw_operator_plain`` for a CPU tensor; there is no fallback between them.
"""

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..common.constants import GRAVITY

# Kernel launches made by ``sw_operator`` (the plain version does not count).
launches = 0


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


# ---------------------------------------------------------------------------
# Halo glue (plain torch on either device; edge-sized work only)


def edge_traces(q: torch.Tensor, con: SWConstants) -> torch.Tensor:
    """Panel-edge face traces of a state, (3, 4, 6, nel, s) in (S, N, W, E)
    order — only the edge elements are extrapolated."""
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
    ``pallas_sw_gen.halo_from_slabs``)."""
    shape = traces.shape
    ex = topology.exchange_pool(traces.reshape(3, 4, 6, -1))
    b1, b2 = topology.rotate_vectors(ex[1], ex[2])
    return torch.stack([ex[0], b1, b2]).reshape(shape)


# ---------------------------------------------------------------------------
# Plain torch version


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
    adv_l = torch.clamp(big_m, min=0.0) * aL
    adv_r = torch.clamp(big_m, max=0.0) * aR
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


def sw_operator_plain(q, halo, con: SWConstants, x=None, a: float = 0.0, b: float = 1.0,
                      cdt: Optional[float] = None, emit_traces: bool = False):
    """Plain torch version of the operator; same arguments and results as
    ``sw_operator`` (written from models/shallow_water.py:130-252 and
    pallas_sw._element_stage / _ausm_slots of the JAX package)."""
    s = con.s
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
    df = torch.stack([-invsg * div[0], -invsg * div[1] - forcing_1, -invsg * div[2] - forcing_2])

    # Interface states: nel+1 interfaces per element row / column.
    itf = q @ con.ee  # (3, 6, nel, nel, 4s)
    west, east = itf[..., :s], itf[..., s : 2 * s]
    south, north = itf[..., 2 * s : 3 * s], itf[..., 3 * s :]
    hs, hn, hw, he = halo[:, 0], halo[:, 1], halo[:, 2], halo[:, 3]  # (3, 6, nel, s)
    qL_x = torch.cat([hw.unsqueeze(3), east], dim=3)
    qR_x = torch.cat([west, he.unsqueeze(3)], dim=3)
    qL_y = torch.cat([hs.unsqueeze(2), north], dim=2)
    qR_y = torch.cat([south, hn.unsqueeze(2)], dim=2)
    f_x = _ausm(qL_x, qR_x, con.itf_x[0], con.itf_x[1], con.itf_x[2], is_x=True)
    f_y = _ausm(qL_y, qR_y, con.itf_y[0], con.itf_y[1], con.itf_y[2], is_x=False)

    # Boundary correction from each element's four face fluxes.
    faces = torch.cat(
        [f_x[..., :-1, :], f_x[..., 1:, :], f_y[..., :-1, :, :], f_y[..., 1:, :, :]], dim=-1
    )
    rhs = df - invsg * (faces @ con.cc)

    if cdt is None:
        out = rhs
    else:
        out = b * q + cdt * rhs
        if a != 0.0:
            out = a * x + out
    if emit_traces:
        return out, edge_traces(out, con)
    return out


# ---------------------------------------------------------------------------
# Kernel wrapper


def _check(q, halo, con: SWConstants, x, a: float):
    """Shape, dtype, device and contiguity of the tensors the operator reads."""
    state = (3, 6, con.nel, con.nel, con.s * con.s)
    tensors = {"q": (q, state), "halo": (halo, (3, 4, 6, con.nel, con.s))}
    if a != 0.0:
        if x is None:
            raise ValueError("stage with a != 0 needs x")
        tensors["x"] = (x, state)
    for name, (t, shape) in tensors.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if t.dtype != con.dtype or t.device != con.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; constants are {con.dtype} on {con.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def sw_operator(q, halo, con: SWConstants, x=None, a: float = 0.0, b: float = 1.0,
                cdt: Optional[float] = None, emit_traces: bool = False):
    """The SW operator on ``q`` (3, 6, nel, nel, s^2) with neighbour halos
    ``halo`` (3, 4, 6, nel, s).

    RHS mode (``cdt is None``): returns RHS(q). Stage mode: returns
    ``a*x + b*q + cdt*RHS(q)`` (``x`` is read only when ``a != 0``). With
    ``emit_traces`` also returns the output's panel-edge traces
    (3, 4, 6, nel, s).

    A CPU tensor runs ``sw_operator_plain``; a CUDA tensor launches the
    kernel (built from csrc/sw_operator.cu at first use) on the current
    stream, without synchronising, or raises."""
    global launches
    _check(q, halo, con, x, a)
    if q.device.type == "cpu":
        return sw_operator_plain(q, halo, con, x=x, a=a, b=b, cdt=cdt, emit_traces=emit_traces)
    if q.device.type != "cuda":
        raise ValueError(f"sw_operator runs on cpu or cuda tensors, not {q.device}")
    if con.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"sw_operator takes float32 or float64, not {con.dtype}")
    if not (2 <= con.s <= 8) or con.nel < 2:
        raise ValueError(f"sw_operator takes 2 <= s <= 8 and nel >= 2, not s={con.s}, nel={con.nel}")

    from ..kernels.build import load_library

    lib = load_library("sw_operator")
    use_x = cdt is not None and a != 0.0
    out = torch.empty_like(q)
    traces = (
        torch.empty((3, 4, 6, con.nel, con.s), dtype=q.dtype, device=q.device)
        if emit_traces else None
    )
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.sw_operator_launch(
            1 if q.dtype == torch.float64 else 0, con.s, con.nel,
            ptr(q), ptr(halo), ptr(con.ops), ptr(con.fields), ptr(con.gridrot),
            ptr(con.itf_x), ptr(con.itf_y), ptr(x if use_x else None), ptr(out), ptr(traces),
            float(a), float(b), float(cdt if cdt is not None else 0.0),
            1 if cdt is not None else 0, ctypes.c_void_p(stream),
        )
    if rc != 0:
        name = lib.sw_operator_error_string(rc).decode()
        raise RuntimeError(f"sw_operator kernel launch failed: CUDA error {rc} ({name})")
    launches += 1
    return (out, traces) if emit_traces else out
