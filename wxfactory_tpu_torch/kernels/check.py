"""Hold the port's CUDA kernels against their plain torch versions on the
same inputs, and count the bytes and operations each call needs (for the
memory/compute bound of ``chip_smoke.py``).

Shallow water (``compare_sw_operator``): Williamson case 6 with a seeded
perturbation. Tolerances, per variable, on the error scaled as stated:

* float64: 5e-12, the JAX kernel test's bound (tests/test_pallas_gen.py);
* float32: 1e-5 (sums in another order, f32 sqrt and divide).

Errors are scaled by each variable's max of the plain output, with one
exception: float32 RHS-mode outputs are scaled by each variable's max
flux-divergence term ``inv_sqrtG * div(F)``. The case-6 RHS is the residual
of terms 400 to 28,000 times larger at the checked shapes, so f32 round-off
in another summation order is that many times larger than the RHS's own
ulp: the plain f32 RHS differs from the f64 one by 1e-3 of its max at
nel=64, s=3. The error scaled by the RHS max is reported beside it.

3D Euler (``compare_euler3d_operator``): DCMIP 31 (or 77 on a rotating
planet) with seeded noise, 1e-3 relative on every variable plus a 0.1 m/s
random vertical wind, so no RHS row is a near-cancelled residual.
Tolerances, per variable:

* float64: 1e-12 of each variable's max of the plain output (the JAX
  kernel tests bound km3_fused against its pure-jnp body at 1e-12);
* float32: 1e-5 of a stated scale, per variable the larger of the output
  max and |cdt| (1 in RHS mode) times a term scale: the max of the flux
  divergence for rho, rho*u1, rho*u2, rho*theta, of the gravity term for
  rho*w (which the pressure gradient balances to ~1e-9). The f32 hydrostatic cancellation leaves the plain f32 RHS 1e2-1e4
  times its own ulp away from the f64 one, and the kernel sums in another
  order, so the RHS max is no scale for f32 round-off.

With the well-balanced offset (f32 only) the check also holds, at the
unperturbed base state, the kernel's RHS + bal against the f64 plain RHS:
within 1e-2 of each variable's max and 1e3 times closer than without the
offset (the bounds of the JAX test_balanced_offset_restores_base_state_rhs).

3D Euler tangent mode (``compare_euler3d_tangent``): J(q).v at q = q0 + dq,
dq = 1e-4 q0 N(0,1), in a direction v of 1e-3 of each variable's max times
N(0,1) (the inputs of the JAX test_tangent_kernel_matches_jvp, seeded with
numpy), against ``torch.func.jvp`` of the plain operator on the same
inputs:

* float64: 1e-12 of each variable's max of the plain J.v (the JAX tests
  bound the tangent kernel against jax.jvp at 1e-11);
* float32: 5e-5 of the float64 plain J.v's max per variable, the bound of
  the JAX test_tangent_kernel_f32_accuracy, or, where the float32 plain
  J.v on the same inputs is itself further than that, twice its distance
  (that test's second condition holds the kernel to 10 times its float32
  reference's). These inputs leave rho*u2 at round-off level at the
  equator faces of the symmetric dcmip31 state, where d|vn| = +-dvn flips
  with the sign of vn: rounding q and v to float32 alone moves even the
  float64 J.v by 6.4e-5 of scale at 4x2x3, and float32 arithmetic flips
  more. The float32 plain J.v's distance, the kernel's distance from it
  and that input-rounding distance are reported beside it.
"""

import functools

import numpy as np
import torch

from ..common.constants import GRAVITY
from ..geometry import make_cubed_sphere_2d, make_cubed_sphere_3d, make_metric_2d, make_metric_3d
from ..ops import euler3d_operator as e3op
from ..ops import sw_operator as swop
from ..ops.dfr import make_dfr_operators
from ..parallel.topology import CubedSphereTopology
from ..testcases import dcmip_planet_params, initial_state_3d, williamson_case6

TOLERANCE = {torch.float64: 5e-12, torch.float32: 1e-5}
DT = 30.0


def case6_inputs(nel: int, s: int, dtype, device, seed: int = 0):
    """(con, topology, x, y): constants, topology, and two case-6 states
    perturbed by 1e-3 relative seeded noise (x is the stage's a-term)."""
    geom = make_cubed_sphere_2d(nel, s)
    ops = make_dfr_operators(s)
    metric = make_metric_2d(geom)
    q = williamson_case6(geom)
    rng = np.random.default_rng(seed)
    x = q * (1.0 + 1e-3 * rng.standard_normal(q.shape))
    y = q * (1.0 + 1e-3 * rng.standard_normal(q.shape))
    con = swop.build_constants(ops, metric, nel, dtype=dtype, device=device)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return con, CubedSphereTopology(geom), t(x), t(y)


def per_variable_max(a: torch.Tensor) -> torch.Tensor:
    return a.abs().reshape(a.shape[0], -1).amax(dim=1)


def flux_divergence_scale(q: torch.Tensor, con) -> torch.Tensor:
    """Per-variable max of |inv_sqrtG * div(F)|, the pointwise-flux term
    of the RHS."""
    (sqrtg, h11, h12, h22, *_, invsg) = con.fields
    h, hu1, hu2 = q[0], q[1], q[2]
    u1, u2, hsq, half_g = hu1 / h, hu2 / h, h * h, 0.5 * GRAVITY
    fx = torch.stack([sqrtg * hu1, sqrtg * (hu1 * u1 + half_g * h11 * hsq),
                      sqrtg * (hu2 * u1 + half_g * h12 * hsq)])
    fy = torch.stack([sqrtg * hu2, sqrtg * (hu1 * u2 + half_g * h12 * hsq),
                      sqrtg * (hu2 * u2 + half_g * h22 * hsq)])
    return per_variable_max(invsg * (torch.cat([fx, fy], dim=-1) @ con.dd))


def _scaled(err: torch.Tensor, scale: torch.Tensor) -> float:
    return float((per_variable_max(err) / scale).max())


def compare_sw_operator(nel: int, s: int, dtype, device="cuda", seed: int = 0):
    """Kernel against plain in every mode; returns one dict per mode with
    the scaled error ``err``, its tolerance ``tol`` and ``ok``."""
    con, topology, x, y = case6_inputs(nel, s, dtype, device, seed)
    halo = swop.halo_from_traces(swop.edge_traces(y, con), topology)
    modes = {
        "rhs": dict(),
        "stage": dict(a=0.0, b=1.0, cdt=DT),
        "stage_x": dict(x=x, a=0.75, b=0.25, cdt=0.25 * DT),
        "stage_x_traces": dict(x=x, a=1.0 / 3.0, b=2.0 / 3.0, cdt=(2.0 / 3.0) * DT, emit_traces=True),
    }
    tol = TOLERANCE[dtype]
    results = []
    for mode, kw in modes.items():
        got = swop.sw_operator(y, halo, con, **kw)
        want = swop.sw_operator_plain(y, halo, con, **kw)
        if device != "cpu":
            torch.cuda.synchronize()
        got_tr = want_tr = None
        if kw.get("emit_traces"):
            (got, got_tr), (want, want_tr) = got, want
        row = {"nel": nel, "s": s, "dtype": str(dtype).replace("torch.", ""), "mode": mode,
               "max_abs_err": float((got - want).abs().max())}
        row["err_of_output_max"] = _scaled(got - want, per_variable_max(want))
        if mode == "rhs" and dtype == torch.float32:
            row["scale"] = "flux_divergence_max"
            row["err"] = _scaled(got - want, flux_divergence_scale(y, con))
        else:
            row["scale"] = "output_max"
            row["err"] = row["err_of_output_max"]
        if got_tr is not None:
            row["traces_err"] = _scaled(got_tr - want_tr, per_variable_max(want_tr))
        row["tol"] = tol
        row["ok"] = bool(
            np.isfinite(row["err"]) and row["err"] <= tol
            and row.get("traces_err", 0.0) <= tol and torch.isfinite(got).all().item()
        )
        results.append(row)
    return results


def sw_work(nel: int, s: int, dtype, stage: bool = False, use_x: bool = False,
            traces: bool = False, pert: bool = False):
    """(bytes, operations) of one SW operator call: each input read once,
    each output written once; the operations the function needs (an add,
    multiply, divide or sqrt is one, a fused multiply-add two), with each
    face extrapolated once and each interface flux computed once. The
    extrapolation, derivative and correction matrices are Kronecker
    products with the identity (``ops/dfr.py``), so they count by their 1D
    factors: s terms a face point and a derivative, one correction term
    from each of a node's four faces (the kernel's dense s^2 x s^2 products
    do s times that). The perturbation form (``pert``) also reads the 14
    base planes and does the delta expansion (~25 more operations a node,
    ~50 more an interface point)."""
    n_elem, s2, item = 6 * nel * nel, s * s, torch.finfo(dtype).bits // 8
    state = 3 * n_elem * s2
    words = 2 * state + (state if use_x else 0)  # q, out, x
    words += 13 * nel * nel * s2 + n_elem * s2  # one-panel metric, gridrot
    words += 2 * 3 * nel * (nel + 1) * s + 3 * 4 * 6 * nel * s * (2 if traces else 1)  # itf, halo, traces
    node, face = 30, 40
    if pert:
        words += 8 * n_elem * s2 + 3 * n_elem * 4 * s + 3 * 4 * 6 * nel * s  # q0, u0, rhs0, itf0, halo0
        node, face = 55, 90
    # node: pointwise + 2 derivatives x 3 variables x s fma + 4 faces x 3
    # variables fma; interface point: 2 sides x 3 variables x s fma + flux
    ops = n_elem * (s2 * (node + 12 * s + 24) + 2 * s * (12 * s + face))
    ops += n_elem * s2 * 3 * ((2 if stage else 0) + (2 if use_x else 0))
    return words * item, ops


def sw_pert_work(nel: int, s: int, dtype, **kw):
    """``sw_work`` of the perturbation form."""
    return sw_work(nel, s, dtype, pert=True, **kw)


def sw_edges_work(nel: int, s: int, dtype):
    """(bytes, operations) of the panel-edge traces of a state: the edge
    elements' nodes (4 nel - 4 elements a panel) and EE read, the traces
    written; s fused multiply-adds (two operations each) a trace point, by
    EE's 1D factor (the kernel's dense product does s^2)."""
    s2, item, npts = s * s, torch.finfo(dtype).bits // 8, 3 * 24 * nel * s
    words = 3 * 6 * (4 * nel - 4) * s2 + 4 * s * s2 + npts
    return words * item, 2 * s * npts


def sw_halo_work(nel: int, s: int, dtype):
    """(bytes, operations) of the halo exchange: traces read, the four
    rotation coefficients of each edge point read, the halo written (the
    24-row tables are negligible); the 2x2 rotation is 6 operations an edge
    point."""
    npts, item = 24 * nel * s, torch.finfo(dtype).bits // 8
    return (3 + 4 + 3) * npts * item, 6 * npts


def sw_run_work(nel: int, s: int, dtype, nsteps: int, pert: bool = False):
    """(bytes, operations) of ``nsteps`` whole TVD-RK3 steps in one call:
    the input state and the constants (and base planes) read once, the
    result written once — everything in between is the run's own — and
    3 nsteps stages of operator work (with the x term in two of three) and
    halo work."""
    nbytes, _ = sw_work(nel, s, dtype, pert=pert)
    ops = nsteps * (sum(sw_work(nel, s, dtype, stage=True, use_x=k > 0, traces=True, pert=pert)[1]
                        for k in range(3)) + 3 * sw_halo_work(nel, s, dtype)[1])
    return nbytes, ops


def euler3d_work(con, stage: bool = False, use_x: bool = False, use_bal: bool = False,
                 traces: bool = False):
    """(bytes, operations) of one 3D Euler operator call: each input read
    once, each output written once; operations counted from the algorithm
    (an add, multiply, divide, sqrt, log or exp is one; fma two), each face
    trace extrapolated once and each interface flux computed once."""
    nh, nk, s = con.nel_h, con.nel_v, con.s
    s2, s3 = s * s, s**3
    n_elem, item = 6 * nk * nh * nh, torch.finfo(con.dtype).bits // 8
    state = 5 * n_elem * s3
    words = state * (2 + (1 if use_x else 0) + (1 if use_bal else 0))  # q, out, x, bal
    words += con.fields.numel() + (con.tch.numel() if con.tch is not None else 0)
    words += con.itf_x.numel() + con.itf_y.numel() + con.itf_z.numel()
    words += 5 * 4 * 6 * nk * nh * s2 * (2 if traces else 1)  # halo, traces
    per_elem = s3 * (263 + 38 * s) + 6 * s2 * (10 * s + 2) + 3 * s2 * 90
    ops = n_elem * per_elem + state * ((2 if stage else 0) + (2 if use_x else 0) + (1 if use_bal else 0))
    return words * item, ops


@functools.lru_cache(maxsize=None)
def euler3d_setup(nel_h: int, nel_v: int, s: int, case: int = 31):
    """(geom, ops, metric, topology, q0) of a DCMIP case at one shape (host
    float64; cached, the metric at large shapes takes tens of seconds)."""
    scale, rotating = dcmip_planet_params(case)
    geom = make_cubed_sphere_3d(nel_h, nel_v, s, 10000.0, planet_scaling_factor=scale,
                                planet_is_rotating=rotating)
    ops = make_dfr_operators(s, three_d=True)
    topology = CubedSphereTopology(geom)
    metric = make_metric_3d(geom, ops, topology)
    return geom, ops, metric, topology, initial_state_3d(geom, case)


def euler3d_tangent_inputs(nel_h: int, nel_v: int, s: int, dtype, device, case: int = 31, seed: int = 7):
    """(con, topology, q, v): constants, a state q = q0 + dq with dq =
    1e-4 q0 N(0,1), and a direction v = 1e-3 max|q0| N(0,1) per variable
    (tests/test_pallas_euler3d.py:238-244)."""
    geom, ops, metric, topology, q0 = euler3d_setup(nel_h, nel_v, s, case)
    rng = np.random.default_rng(seed)
    dq = 1e-4 * q0 * rng.standard_normal(q0.shape)
    v = rng.standard_normal(q0.shape) * np.abs(q0).reshape(5, -1).max(axis=1).reshape(5, 1, 1, 1, 1, 1) * 1e-3
    con = e3op.build_constants(ops, metric, nel_h, nel_v, dtype=dtype, device=device)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return con, topology, t(q0 + dq), t(v)


def tangent_halos(q, v, con, topology):
    """(halo_q, halo_v): the neighbour halos of q and of the direction v."""
    traces = e3op.edge_traces(q, con)
    return (e3op.halo_from_traces(traces, topology),
            e3op.halo_from_traces(e3op.edge_traces_tangent(q, v, con, traces), topology))


def euler3d_inputs(nel_h: int, nel_v: int, s: int, dtype, device, case: int = 31, seed: int = 0):
    """(con, topology, x, y): constants and two noisy states of a DCMIP case
    (x is the stage's a-term)."""
    geom, ops, metric, topology, q = euler3d_setup(nel_h, nel_v, s, case)
    rng = np.random.default_rng(seed)

    def noisy():
        out = q * (1.0 + 1e-3 * rng.standard_normal(q.shape))
        out[3] += 0.1 * q[0] * rng.standard_normal(q[0].shape)
        return out

    x, y = noisy(), noisy()
    con = e3op.build_constants(ops, metric, nel_h, nel_v, dtype=dtype, device=device)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return con, topology, t(x), t(y)


def euler3d_term_scale(q: torch.Tensor, con) -> torch.Tensor:
    """Per-variable max of the RHS term that sets its size: the interior
    flux divergence ``inv_sqrtG * div(F)`` for rho, rho*u1, rho*u2,
    rho*theta, and the gravity term for rho*w."""
    fld = con.fields
    sqrtg, invsg, invdz = fld[0], fld[1], fld[2]
    rho = q[0]
    p = e3op.pressure(q[4])
    bundles = []
    for d in range(3):
        flux = sqrtg * (q[1 + d] / rho) * q
        hrow = [fld[3 + e3op.H_PAIRS.index(tuple(sorted((d, k))))] for k in range(3)]
        press = torch.stack([torch.zeros_like(p)] + [sqrtg * p * h for h in hrow] + [torch.zeros_like(p)])
        bundles.append(flux + press)
    div = invsg * (torch.cat(bundles, dim=-1) @ con.dd)
    gravity = invdz * GRAVITY * invsg * ((sqrtg * rho) @ con.hfk)
    scale = per_variable_max(div)
    scale[3] = gravity.abs().max()
    return scale


E3_TOLERANCE = {torch.float64: 1e-12, torch.float32: 1e-5}
E3_TANGENT_TOLERANCE = {torch.float64: 1e-12, torch.float32: 5e-5}
E3_DT = 0.1


def compare_euler3d_operator(nel_h: int, nel_v: int, s: int, dtype, device="cuda", case: int = 31,
                             seed: int = 0):
    """Kernel against plain in every mode (and, in f32, the well-balanced
    offset); returns one dict per mode with the scaled error ``err``, its
    tolerance ``tol`` and ``ok``."""
    con, topology, x, y = euler3d_inputs(nel_h, nel_v, s, dtype, device, case, seed)
    halo = e3op.halo_from_traces(e3op.edge_traces(y, con), topology)
    modes = {
        "rhs": dict(),
        "stage": dict(a=0.0, b=1.0, cdt=E3_DT),
        "stage_x": dict(x=x, a=0.75, b=0.25, cdt=0.25 * E3_DT),
        "stage_x_traces": dict(x=x, a=1.0 / 3.0, b=2.0 / 3.0, cdt=(2.0 / 3.0) * E3_DT, emit_traces=True),
    }
    base = {}
    if dtype == torch.float32:
        geom, ops, metric, _, q0 = euler3d_setup(nel_h, nel_v, s, case)
        con64 = e3op.build_constants(ops, metric, nel_h, nel_v, dtype=torch.float64, device=device)
        q064 = torch.as_tensor(q0, dtype=torch.float64, device=device)
        truth = e3op.euler3d_operator_plain(q064, e3op.halo_from_traces(e3op.edge_traces(q064, con64), topology),
                                            con64)
        q0c = q064.to(dtype)
        halo0 = e3op.halo_from_traces(e3op.edge_traces(q0c, con), topology)
        k0 = e3op.euler3d_operator(q0c, halo0, con).double()  # the offset of the operator it corrects
        bal = (truth - k0).to(dtype)
        modes["rhs_bal"] = dict(bal=bal)
        modes["stage_x_traces_bal"] = dict(modes["stage_x_traces"], bal=bal)
        sc = per_variable_max(truth)
        base = {
            "base_err_bal": _scaled(e3op.euler3d_operator(q0c, halo0, con, bal=bal).double() - truth, sc),
            "base_err_plain": _scaled(k0 - truth, sc),
        }
    tol = E3_TOLERANCE[dtype]
    term = euler3d_term_scale(y, con) if dtype == torch.float32 else None
    results = []
    for mode, kw in modes.items():
        got = e3op.euler3d_operator(y, halo, con, **kw)
        want = e3op.euler3d_operator_plain(y, halo, con, **kw)
        if device != "cpu":
            torch.cuda.synchronize()
        got_tr = want_tr = None
        if kw.get("emit_traces"):
            (got, got_tr), (want, want_tr) = got, want
        row = {"nel_h": nel_h, "nel_v": nel_v, "s": s, "case": case, "dtype": str(dtype).replace("torch.", ""),
               "mode": mode, "max_abs_err": float((got - want).abs().max())}
        row["err_of_output_max"] = _scaled(got - want, per_variable_max(want))
        if term is None:
            row["scale"], row["err"] = "output_max", row["err_of_output_max"]
        else:
            cdt = abs(kw.get("cdt", 1.0))
            row["scale"] = "max(output_max, cdt*term)" if "cdt" in kw else "max(output_max, term)"
            row["err"] = _scaled(got - want, torch.maximum(per_variable_max(want), cdt * term))
        if got_tr is not None:
            row["traces_err"] = _scaled(got_tr - want_tr, per_variable_max(want_tr))
        row["tol"] = tol
        ok = np.isfinite(row["err"]) and row["err"] <= tol and row.get("traces_err", 0.0) <= tol
        ok = ok and bool(torch.isfinite(got).all().item())
        if mode == "rhs_bal":
            row.update(base)
            ok = ok and base["base_err_bal"] < 1e-2 and base["base_err_bal"] < 1e-3 * base["base_err_plain"]
        row["ok"] = bool(ok)
        results.append(row)
    return results


def compare_euler3d_tangent(nel_h: int, nel_v: int, s: int, dtype, device="cuda", case: int = 31, seed: int = 7):
    """The tangent kernel against the plain tangent on the same inputs;
    returns one row with the scaled error ``err``, its tolerance ``tol`` and
    ``ok`` (scales in the module docstring)."""
    con, topology, q, v = euler3d_tangent_inputs(nel_h, nel_v, s, dtype, device, case, seed)
    halo_q, halo_v = tangent_halos(q, v, con, topology)
    got = e3op.euler3d_tangent(q, v, halo_q, halo_v, con)
    want = e3op.euler3d_tangent_plain(q, v, halo_q, halo_v, con)
    if device != "cpu":
        torch.cuda.synchronize()
    row = {"nel_h": nel_h, "nel_v": nel_v, "s": s, "case": case, "dtype": str(dtype).replace("torch.", ""),
           "mode": "tangent", "max_abs_err": float((got - want).abs().max())}
    if dtype == torch.float64:
        row["scale"], row["err"] = "output_max", _scaled(got - want, per_variable_max(want))
    else:
        con64, _, q64, v64 = euler3d_tangent_inputs(nel_h, nel_v, s, torch.float64, device, case, seed)
        f64_tangent = lambda q_, v_: e3op.euler3d_tangent_plain(q_, v_, *tangent_halos(q_, v_, con64, topology),
                                                               con64)
        truth = f64_tangent(q64, v64)
        sc = per_variable_max(truth)
        row["scale"] = "f64_plain_output_max"
        row["err"] = _scaled(got.double() - truth, sc)
        row["plain_err"] = _scaled(want.double() - truth, sc)
        row["kernel_vs_plain_err"] = _scaled(got.double() - want.double(), sc)
        # The float64 operator at the float32-rounded inputs: what rounding
        # the inputs alone moves J.v (large where a normal speed sits at
        # round-off level and d|vn| flips with its sign).
        row["input_rounding_err"] = _scaled(f64_tangent(q.double(), v.double()) - truth, sc)
    row["tol"] = E3_TANGENT_TOLERANCE[dtype]
    limit = max(row["tol"], 2.0 * row.get("plain_err", 0.0))
    row["ok"] = bool(np.isfinite(row["err"]) and row["err"] <= limit and torch.isfinite(got).all().item())
    return row


def euler3d_tangent_work(con):
    """(bytes, operations) of one tangent-mode call, counted as
    ``euler3d_work`` counts them: q, v and both halos read once, J.v
    written once, the metric read once; operations of the linearised
    algorithm (primal and derivative of each site: pointwise ~370 + 44 s a
    point, each face's primal and direction traces once, ~170 a face point
    for the Rusanov flux and its derivative)."""
    nh, nk, s = con.nel_h, con.nel_v, con.s
    s2, s3 = s * s, s**3
    n_elem, item = 6 * nk * nh * nh, torch.finfo(con.dtype).bits // 8
    words = 3 * 5 * n_elem * s3  # q, v, out
    words += con.fields.numel() + (con.tch.numel() if con.tch is not None else 0)
    words += con.itf_x.numel() + con.itf_y.numel() + con.itf_z.numel()
    words += 2 * 5 * 4 * 6 * nk * nh * s2  # halo_q, halo_v
    per_elem = s3 * (370 + 44 * s) + 6 * s2 * (20 * s + 4) + 3 * s2 * 170
    return words * item, n_elem * per_elem


def euler3d_pert_inputs(nel_h: int, nel_v: int, s: int, dtype, device, case: int = 31, seed: int = 7):
    """(con, topology, pert, dq, v): the perturbation form's inputs at the
    tangent inputs' state q0 + dq (``euler3d_tangent_inputs``): the base
    around q0 (built in float64 on ``device``, cast to ``dtype``), dq =
    q - q0 in ``dtype`` and the direction v."""
    geom, ops, metric, topology, q0 = euler3d_setup(nel_h, nel_v, s, case)
    con, _, q, v = euler3d_tangent_inputs(nel_h, nel_v, s, dtype, device, case, seed)
    con64 = e3op.build_constants(ops, metric, nel_h, nel_v, dtype=torch.float64, device=device)
    pert = e3op.build_pert_base(torch.as_tensor(q0), con64, topology, dtype)
    return con, topology, pert, (q - pert.q0).contiguous(), v


def pert_halos(dq, v, pert, con, topology):
    """(halo_dq, halo_v): the delta halo of dq and the direction's halo at
    q0 + dq (absolute state and traces, as ``Euler3DRHS.jtv_prep``)."""
    dtraces = e3op.edge_traces_delta(dq, pert, con)
    halo_v = e3op.halo_from_traces(e3op.edge_traces_tangent(pert.q0 + dq, v, con, pert.traces0 + dtraces), topology)
    return e3op.halo_from_traces(dtraces, topology), halo_v


def compare_euler3d_pert(nel_h: int, nel_v: int, s: int, dtype, device="cuda", case: int = 31, seed: int = 7):
    """The perturbation mode's kernel (RHS: rhs0 + delta; tangent: J(q0 +
    dq).v) against its plain version on the same inputs; returns one row
    per mode.

    float64: the kernel within 1e-12 of the plain output, scaled per
    variable by the larger of the output max and the RHS term scale in RHS
    mode (``euler3d_term_scale``, as the absolute RHS check), by the output
    max in tangent mode. float32: the kernel against the float64 plain
    output on the same (float64) inputs, within 5e-5 of that scale or twice
    the float32 plain output's distance, the rule of the tangent check."""
    con, topology, pert, dq, v = euler3d_pert_inputs(nel_h, nel_v, s, dtype, device, case, seed)
    halo_dq, halo_v = pert_halos(dq, v, pert, con, topology)
    rows = []
    truth = None
    if dtype == torch.float32:
        con64, _, pert64, dq64, v64 = euler3d_pert_inputs(nel_h, nel_v, s, torch.float64, device, case, seed)
        h64 = pert_halos(dq64, v64, pert64, con64, topology)
        truth = {"rhs": e3op.euler3d_operator_pert_plain(dq64, h64[0], con64, pert64),
                 "tangent": e3op.euler3d_tangent_pert_plain(dq64, v64, *h64, con64, pert64)}
    for mode in ("rhs", "tangent"):
        if mode == "rhs":
            got = e3op.euler3d_operator(dq, halo_dq, con, pert=pert)
            want = e3op.euler3d_operator_pert_plain(dq, halo_dq, con, pert)
        else:
            got = e3op.euler3d_tangent(dq, v, halo_dq, halo_v, con, pert=pert)
            want = e3op.euler3d_tangent_pert_plain(dq, v, halo_dq, halo_v, con, pert)
        if device != "cpu":
            torch.cuda.synchronize()
        ref = want if truth is None else truth[mode]
        scale = per_variable_max(ref)
        if mode == "rhs":
            scale = torch.maximum(scale, euler3d_term_scale(pert.q0 + dq, con).to(ref.dtype))
        row = {"nel_h": nel_h, "nel_v": nel_v, "s": s, "case": case, "dtype": str(dtype).replace("torch.", ""),
               "mode": f"pert_{mode}", "max_abs_err": float((got - want).abs().max()),
               "scale": "max(output_max, term)" if mode == "rhs" else "output_max"}
        row["err"] = _scaled(got.to(ref.dtype) - ref, scale)
        if truth is None:
            row["tol"] = E3_TOLERANCE[dtype]
            limit = row["tol"]
        else:
            row["scale"] = "f64_plain_" + row["scale"]
            row["plain_err"] = _scaled(want.double() - ref, scale)
            row["kernel_vs_plain_err"] = _scaled(got.double() - want.double(), scale)
            row["tol"] = E3_TANGENT_TOLERANCE[dtype]
            limit = max(row["tol"], 2.0 * row["plain_err"])
        row["ok"] = bool(np.isfinite(row["err"]) and row["err"] <= limit and torch.isfinite(got).all().item())
        rows.append(row)
    return rows


def euler3d_pert_work(con, tangent: bool = False):
    """(bytes, operations) of one perturbation-mode call, counted as
    ``euler3d_work`` counts them. RHS mode reads dq, q0, rhs0, the metric,
    the delta and base halos and writes rhs0 + delta; tangent mode reads
    dq, q0, v, the metric and three halos (delta, base, direction) and
    writes J.v. Operations of the expanded algorithm: each face's base and
    perturbation traces once (and the direction's in tangent mode), the
    pointwise deltas (~330 + 40 s a point; tangent ~430 + 44 s), ~200
    operations a face point for the delta Rusanov flux and its face
    corrections (tangent ~280 with the linearised flux)."""
    nh, nk, s = con.nel_h, con.nel_v, con.s
    s2, s3 = s * s, s**3
    n_elem, item = 6 * nk * nh * nh, torch.finfo(con.dtype).bits // 8
    words = 4 * 5 * n_elem * s3  # dq, q0, rhs0 or v, out
    words += con.fields.numel() + (con.tch.numel() if con.tch is not None else 0)
    words += con.itf_x.numel() + con.itf_y.numel() + con.itf_z.numel()
    words += (3 if tangent else 2) * 5 * 4 * 6 * nk * nh * s2  # halos
    if tangent:
        per_elem = s3 * (430 + 44 * s) + 6 * s2 * 3 * (10 * s + 4) + 3 * s2 * 280
    else:
        per_elem = s3 * (330 + 40 * s) + 6 * s2 * 2 * (10 * s + 4) + 3 * s2 * 200
    return words * item, n_elem * per_elem


# ---------------------------------------------------------------------------
# Shallow water: perturbation form, halo and edge-trace kernels, whole runs

SW_PERT_TOLERANCE = {torch.float64: 1e-12, torch.float32: 1e-5}
GLUE_TOLERANCE = {torch.float64: 1e-14, torch.float32: 1e-6}


@functools.lru_cache(maxsize=None)
def sw_setup(nel: int, s: int):
    """(geom, ops, metric, topology, q0) of Williamson case 6 (host float64;
    cached)."""
    geom = make_cubed_sphere_2d(nel, s)
    metric = make_metric_2d(geom)
    return geom, make_dfr_operators(s), metric, CubedSphereTopology(geom), williamson_case6(geom)


def sw_delta(q0: np.ndarray) -> np.ndarray:
    """The perturbation of the JAX perturbation tests, 1e-3 q0 sin(0.37 k)
    (tests/test_pallas_gen.py:111): it moves face Mach numbers across zero
    where the base's are near it."""
    return 1e-3 * q0 * np.sin(np.arange(q0.size).reshape(q0.shape) * 0.37)


def sw_pert_inputs(nel: int, s: int, dtype, device, seed: int = 0):
    """(con, topology, base, dq, x): the case-6 perturbation base (built in
    float64 on ``device``, cast to ``dtype``), dq = ``sw_delta(q0)`` and a
    second perturbation x (seeded noise of 1e-3 relative), both in
    ``dtype``."""
    geom, ops, metric, topology, q0 = sw_setup(nel, s)
    con = swop.build_constants(ops, metric, nel, dtype=dtype, device=device)
    con64 = swop.build_constants(ops, metric, nel, dtype=torch.float64, device=device)
    base = swop.build_base_planes(torch.as_tensor(q0), con64, topology, dtype)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return con, topology, base, t(sw_delta(q0)), t(1e-3 * q0 * rng.standard_normal(q0.shape))


def _sw_pert_modes(x):
    return {
        "rhs": dict(),
        "stage": dict(a=0.0, b=1.0, cdt=DT),
        "stage_x": dict(x=x, a=0.75, b=0.25, cdt=0.25 * DT),
        "stage_x_traces": dict(x=x, a=1.0 / 3.0, b=2.0 / 3.0, cdt=(2.0 / 3.0) * DT, emit_traces=True),
    }


def compare_sw_pert(nel: int, s: int, dtype, device="cuda", seed: int = 0):
    """The operator's perturbation mode against its plain version in every
    mode (RHS rhs0 + delta, stages of deltas, emitted delta traces); one row
    per mode.

    float64: within 1e-12 of each variable's max of the plain output (the
    JAX test of km_gen's perturbation mode, tests/test_pallas_gen.py:104-122).
    float32: against the float64 plain output on the same (float64) inputs,
    within twice the float32 plain output's distance from it, or 1e-5 of
    scale where that is larger (the f32 bound of the absolute check)."""
    con, topology, base, dq, x = sw_pert_inputs(nel, s, dtype, device, seed)
    halo = swop.halo_from_traces(swop.edge_traces(dq, con), topology)
    truth = None
    if dtype == torch.float32:
        con64, _, base64, dq64, x64 = sw_pert_inputs(nel, s, torch.float64, device, seed)
        halo64 = swop.halo_from_traces(swop.edge_traces(dq64, con64), topology)
        truth = {m: swop.sw_operator_pert_plain(dq64, halo64, con64, base64, **kw)
                 for m, kw in _sw_pert_modes(x64).items()}
    rows = []
    for mode, kw in _sw_pert_modes(x).items():
        got = swop.sw_operator(dq, halo, con, base=base, **kw)
        want = swop.sw_operator_pert_plain(dq, halo, con, base, **kw)
        if device != "cpu":
            torch.cuda.synchronize()
        ref = want if truth is None else truth[mode]
        got_tr = want_tr = ref_tr = None
        if kw.get("emit_traces"):
            (got, got_tr), (want, want_tr), (ref, ref_tr) = got, want, ref
        row = {"nel": nel, "s": s, "dtype": str(dtype).replace("torch.", ""), "mode": f"pert_{mode}",
               "max_abs_err": float((got - want).abs().max()), "scale": "output_max"}
        scale = per_variable_max(ref)
        row["err"] = _scaled(got.to(ref.dtype) - ref, scale)
        if got_tr is not None:
            row["traces_err"] = _scaled(got_tr.to(ref.dtype) - ref_tr, per_variable_max(ref_tr))
        if truth is None:
            row["tol"] = limit = limit_tr = SW_PERT_TOLERANCE[dtype]
        else:
            row["scale"] = "f64_plain_output_max"
            row["plain_err"] = _scaled(want.double() - ref, scale)
            row["tol"] = SW_PERT_TOLERANCE[dtype]
            limit = max(row["tol"], 2.0 * row["plain_err"])
            if got_tr is not None:
                row["plain_traces_err"] = _scaled(want_tr.double() - ref_tr, per_variable_max(ref_tr))
                limit_tr = max(row["tol"], 2.0 * row["plain_traces_err"])
        ok = np.isfinite(row["err"]) and row["err"] <= limit and bool(torch.isfinite(got).all().item())
        if got_tr is not None:
            ok = ok and row["traces_err"] <= limit_tr
        row["ok"] = bool(ok)
        rows.append(row)
    return rows


def _glue_row(nel: int, s: int, dtype, mode: str, kernel, plain, device) -> list:
    got, want = kernel(), plain()
    if device != "cpu":
        torch.cuda.synchronize()
    err = _scaled(got - want, per_variable_max(want))
    tol = GLUE_TOLERANCE[dtype]
    return [{"nel": nel, "s": s, "dtype": str(dtype).replace("torch.", ""), "mode": mode,
             "max_abs_err": float((got - want).abs().max()), "scale": "output_max", "err": err, "tol": tol,
             "ok": bool(np.isfinite(err) and err <= tol)}]


def compare_sw_edges(nel: int, s: int, dtype, device="cuda", seed: int = 0):
    """The edge-trace kernel (``sw_edges``) against ``edge_traces`` on a
    perturbed case-6 state; one row, within 1e-14 of each variable's max in
    float64 (the same fma chain against a matmul), 1e-6 in float32."""
    con, _, _, y = case6_inputs(nel, s, dtype, device, seed)
    return _glue_row(nel, s, dtype, "edges", lambda: swop.sw_edges(y, con), lambda: swop.edge_traces(y, con), device)


def compare_sw_halo(nel: int, s: int, dtype, device="cuda", seed: int = 0):
    """The halo kernel (``sw_halo``) against ``halo_from_traces`` on seeded
    random traces (as the JAX test_kh_exchange_matches_xla_exchange); one
    row, within 1e-14 of each variable's max in float64 (one fused
    multiply-add against two roundings in the rotation), 1e-6 in float32."""
    topology = sw_setup(nel, s)[3]
    rng = np.random.default_rng(seed)
    traces = torch.as_tensor(rng.standard_normal((3, 4, 6, nel, s)), dtype=dtype, device=device)
    return _glue_row(nel, s, dtype, "halo", lambda: swop.sw_halo(traces, topology),
                     lambda: swop.halo_from_traces(traces, topology), device)


def compare_sw_run(nel: int, dtype, nsteps: int, pert: bool, device="cuda", dt: float = 30.0):
    """The whole-run kernel (``sw_run``, s=4) against its plain version (the
    loop of plain stages) and against the chained per-stage kernels, from
    case 6 (absolute) or from ``sw_delta(q0)`` around q0 (perturbation).

    float64: within 1e-12 of each variable's max of the plain result (the
    JAX test holds kr_run to rtol 1e-13, atol 1e-10 of iterated stages).
    float32: against the float64 plain result, within twice the float32
    plain result's distance from it or 1e-5. Against the chain the run is
    asked to be bit for bit equal (the same device functions and
    coefficients); ``bit_identical`` and the largest difference are
    reported, and the difference must stay within the same limit."""
    s = 4
    con, topology, base, dq, _ = sw_pert_inputs(nel, s, dtype, device)
    geom, ops, metric, _, q0 = sw_setup(nel, s)
    q = dq if pert else torch.as_tensor(q0, dtype=dtype, device=device)
    base = base if pert else None
    abc = swop.tvdrk3_abc(dt)
    got = swop.sw_run(q, nsteps, abc, con, topology, base=base)
    want = swop.sw_run_plain(q, nsteps, abc, con, topology, base=base)
    chain = swop.sw_chain(q, nsteps, abc, con, topology, base=base)
    if device != "cpu":
        torch.cuda.synchronize()
    ref = want
    row = {"nel": nel, "s": s, "dtype": str(dtype).replace("torch.", ""), "nsteps": nsteps,
           "mode": "run_pert" if pert else "run", "dt": dt, "max_abs_err": float((got - want).abs().max()),
           "scale": "output_max"}
    if dtype == torch.float32:
        con64, _, base64, dq64, _ = sw_pert_inputs(nel, s, torch.float64, device)
        q64 = dq64 if pert else torch.as_tensor(q0, dtype=torch.float64, device=device)
        ref = swop.sw_run_plain(q64, nsteps, abc, con64, topology, base=base64 if pert else None)
        row["scale"] = "f64_plain_output_max"
        row["plain_err"] = _scaled(want.double() - ref, per_variable_max(ref))
    scale = per_variable_max(ref)
    row["err"] = _scaled(got.to(ref.dtype) - ref, scale)
    row["tol"] = SW_PERT_TOLERANCE[dtype]
    limit = max(row["tol"], 2.0 * row.get("plain_err", 0.0))
    row["bit_identical"] = bool(torch.equal(got, chain))
    row["chain_max_abs_err"] = float((got - chain).abs().max())
    row["chain_err"] = _scaled(got.to(ref.dtype) - chain.to(ref.dtype), scale)
    row["ok"] = bool(np.isfinite(row["err"]) and row["err"] <= limit and row["chain_err"] <= limit
                     and torch.isfinite(got).all().item())
    return row
