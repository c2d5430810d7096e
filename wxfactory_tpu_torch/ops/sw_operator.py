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
state's panel-edge traces for the next stage's halo. With a perturbation
base (``SWPertBase``, the 14 base planes) the state, halo, output and traces
carry deltas around the base state q0 and the output is ``rhs0 + delta``,
every flux expanded term by term around the base (never F(q0 + dq) -
F(q0), which float32 could not resolve).

Panel-edge data travel as TRACES ``(3, 4, 6, nel, s)``: variable, side
(S, N, W, E — the topology's side order), panel, element along the edge,
point along the edge. ``edge_traces`` extracts them from a state (the
bootstrap glue), the operator emits them from its output, and
``halo_from_traces`` turns them into the neighbour halos the operator
consumes (same layout; exchange with edge flips + 2x2 contravariant
rotation of the momenta). West/south panel-edge interfaces take qL from the
halo, east/north take qR from it. ``sw_run`` runs whole TVD-RK3 steps at
s=4 (one launch for all of them on a GPU).

Each wrapper (``sw_operator``, ``sw_edges``, ``sw_halo``, ``sw_run``) runs
its CUDA kernel for a CUDA tensor and its plain version for a CPU tensor;
there is no fallback between them.
"""

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..common.constants import GRAVITY

# Kernel launches made by the wrappers (the plain versions do not count):
# the operator in absolute and in perturbation form, the edge-trace and halo
# kernels and the whole-run kernel; and calls of the plain versions.
launches = 0
pert_launches = 0
edge_launches = 0
halo_launches = 0
run_launches = 0
plain_calls = 0


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

    @property
    def tensors(self):
        return {"q0": self.q0, "u0": self.u0, "itf0": self.itf0, "halo0": self.halo0, "rhs0": self.rhs0}


def build_base_planes(q0: torch.Tensor, con64: SWConstants, topology, dtype) -> SWPertBase:
    """The perturbation base around ``q0`` from float64 constants on the
    device that will run the operator (the counterpart of
    ``pallas_sw_gen.build_base_planes``): traces and halos come from the
    runtime's own trace and halo functions, the base RHS from
    ``sw_operator`` (kernels on a GPU, plain versions on the CPU), all in
    float64; the results are cast to ``dtype``."""
    if con64.dtype != torch.float64:
        raise ValueError("the perturbation base is built from float64 constants")
    q0 = q0.to(device=con64.device, dtype=torch.float64).contiguous()
    halo0 = sw_halo(sw_edges(q0, con64), topology)
    rhs0 = sw_operator(q0, halo0, con64)
    cast = lambda t: t.to(dtype).contiguous()
    return SWPertBase(q0=cast(q0), u0=cast(q0[1:3] / q0[0]), itf0=cast(q0 @ con64.ee), halo0=cast(halo0),
                      rhs0=cast(rhs0))


# ---------------------------------------------------------------------------
# Halo glue: plain versions and kernel wrappers


def edge_traces(q: torch.Tensor, con: SWConstants) -> torch.Tensor:
    """Panel-edge face traces of a state, (3, 4, 6, nel, s) in (S, N, W, E)
    order — only the edge elements are extrapolated (plain version of
    ``sw_edges``)."""
    global plain_calls
    plain_calls += 1
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
                      base: Optional[SWPertBase] = None):
    """Plain torch version of the operator; same arguments and results as
    ``sw_operator`` (written from models/shallow_water.py:130-252 and
    pallas_sw._element_stage / _ausm_slots of the JAX package; with
    ``base``, ``sw_operator_pert_plain``)."""
    global plain_calls
    if base is not None:
        return sw_operator_pert_plain(q, halo, con, base, x=x, a=a, b=b, cdt=cdt, emit_traces=emit_traces)
    plain_calls += 1
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

    # Interface fluxes at the nel+1 interfaces per element row / column.
    qL_x, qR_x, qL_y, qR_y = _interface_states(q @ con.ee, halo, con.s)
    f_x = _ausm(qL_x, qR_x, con.itf_x[0], con.itf_x[1], con.itf_x[2], is_x=True)
    f_y = _ausm(qL_y, qR_y, con.itf_y[0], con.itf_y[1], con.itf_y[2], is_x=False)
    rhs = df - invsg * _correction(f_x, f_y, con)
    return _finish(rhs, q, x, a, b, cdt, emit_traces, con)


def sw_operator_pert_plain(dq, halo, con: SWConstants, base: SWPertBase, x=None, a: float = 0.0,
                           b: float = 1.0, cdt: Optional[float] = None, emit_traces: bool = False):
    """Plain torch version of the perturbation form: ``dq`` is the
    perturbation around ``base.q0`` and ``halo`` the halo of its traces;
    returns ``rhs0 + [RHS(q0 + dq) - RHS(q0)]`` with the bracket expanded
    term by term (``pallas_sw._element_stage_pert`` and
    ``_ausm_delta_slots``, the JAX package's ``rhs_delta_core``,
    models/shallow_water.py:346-421), or the stage combination of delta
    states (which is the absolute one whenever a + b = 1), and with
    ``emit_traces`` the output's delta traces."""
    global plain_calls
    plain_calls += 1
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
    nel, s = con.nel, con.s
    state = (3, 6, nel, nel, s * s)
    halo_shape = (3, 4, 6, nel, s)
    tensors = {"q": (q, state)}
    if halo is not None:
        tensors["halo"] = (halo, halo_shape)
    if a != 0.0:
        if x is None:
            raise ValueError("stage with a != 0 needs x")
        tensors["x"] = (x, state)
    if base is not None:
        shapes = {"q0": state, "u0": (2, 6, nel, nel, s * s), "itf0": (3, 6, nel, nel, 4 * s),
                  "halo0": halo_shape, "rhs0": state}
        tensors.update({name: (t, shapes[name]) for name, t in base.tensors.items()})
    for name, (t, shape) in tensors.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if t.dtype != con.dtype or t.device != con.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; constants are {con.dtype} on {con.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _check_kernel_shape(con: SWConstants, name: str):
    if con.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name} takes float32 or float64, not {con.dtype}")
    if not (2 <= con.s <= 8) or con.nel < 2:
        raise ValueError(f"{name} takes 2 <= s <= 8 and nel >= 2, not s={con.s}, nel={con.nel}")


def sw_operator(q, halo, con: SWConstants, x=None, a: float = 0.0, b: float = 1.0,
                cdt: Optional[float] = None, emit_traces: bool = False,
                base: Optional[SWPertBase] = None):
    """The SW operator on ``q`` (3, 6, nel, nel, s^2) with neighbour halos
    ``halo`` (3, 4, 6, nel, s).

    RHS mode (``cdt is None``): returns RHS(q). Stage mode: returns
    ``a*x + b*q + cdt*RHS(q)`` (``x`` is read only when ``a != 0``). With
    ``emit_traces`` also returns the output's panel-edge traces
    (3, 4, 6, nel, s). With ``base`` (the perturbation form) ``q``, ``x``,
    ``halo``, the stage output and the traces are deltas around
    ``base.q0``, and the RHS is ``rhs0 + delta``.

    A CPU tensor runs ``sw_operator_plain``; a CUDA tensor launches the
    kernel (built from csrc/sw_operator.cu at first use) on the current
    stream, without synchronising, or raises."""
    global launches, pert_launches
    _check(q, halo, con, x, a, base)
    if q.device.type == "cpu":
        return sw_operator_plain(q, halo, con, x=x, a=a, b=b, cdt=cdt, emit_traces=emit_traces, base=base)
    if q.device.type != "cuda":
        raise ValueError(f"sw_operator runs on cpu or cuda tensors, not {q.device}")
    _check_kernel_shape(con, "sw_operator")

    from ..kernels.build import load_library

    lib = load_library("sw_operator")
    use_x = cdt is not None and a != 0.0
    out = torch.empty_like(q)
    traces = (
        torch.empty((3, 4, 6, con.nel, con.s), dtype=q.dtype, device=q.device)
        if emit_traces else None
    )
    pb = base.tensors if base is not None else {}
    with torch.cuda.device(q.device):
        rc = lib.sw_operator_launch(
            1 if q.dtype == torch.float64 else 0, con.s, con.nel,
            _ptr(q), _ptr(halo), _ptr(con.ops), _ptr(con.fields), _ptr(con.gridrot),
            _ptr(con.itf_x), _ptr(con.itf_y), _ptr(x if use_x else None),
            _ptr(pb.get("q0")), _ptr(pb.get("u0")), _ptr(pb.get("itf0")), _ptr(pb.get("halo0")),
            _ptr(pb.get("rhs0")), _ptr(out), _ptr(traces),
            float(a), float(b), float(cdt if cdt is not None else 0.0),
            1 if cdt is not None else 0, _stream(q.device),
        )
    _raise_on(rc, lib, "sw_operator")
    if base is not None:
        pert_launches += 1
    else:
        launches += 1
    return (out, traces) if emit_traces else out


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
             traces=None, plain: bool = False):
    """``nsteps`` TVD-RK3 steps of ``q`` as the explicit integrators chain
    them: the panel-edge traces of ``q`` (given, or bootstrapped here), then
    a halo and an operator stage a stage, each output's traces feeding the
    next stage's halo. ``plain``: the plain functions; otherwise the
    wrappers (the kernels on a GPU)."""
    if plain:
        edges, halo, operator = edge_traces, halo_from_traces, sw_operator_plain
    else:
        edges, halo, operator = sw_edges, sw_halo, sw_operator
    a, b, cdt = abc
    x = q
    traces = edges(q, con) if traces is None else traces
    for _ in range(nsteps):
        y = x
        for k in range(3):
            y, traces = operator(y, halo(traces, topology), con, x=x, a=a[k], b=b[k], cdt=cdt[k],
                                 emit_traces=True, base=base)
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
    _check(q, None, con, None, 0.0, base)
    if con.s != 4:
        raise ValueError(f"sw_run takes s = 4, not s = {con.s}")
    if nsteps < 1:
        raise ValueError(f"sw_run takes nsteps >= 1, not {nsteps}")
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
