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
Every SW row (operator, perturbation mode, tile, whole run) also holds
mass: ``mass_err`` below, of the h change (weights ``sw_mass_weights``),
within the row's tolerance.

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

Every 3D operator row also holds mass (``mass_err``): the sqrt(g)- and
quadrature-weighted integral of the kernel's rho change (its RHS, or out -
a*x - b*q in stage mode) over the sphere or tile, against the plain
version's, within the operator tolerance of the change's absolute integral
plus four units of rounding of the output's (a stage's rho change is the
small difference of two near-equal states, which the output's rounding
bounds).

3D Euler tangent mode (``compare_euler3d_tangent``): J(q).v from the prep
and apply kernels at q = q0 + dq, dq = 1e-4 q0 N(0,1), in a direction v
of 1e-3 of each variable's max times N(0,1) (the inputs of the JAX
test_tangent_kernel_matches_jvp, seeded with numpy), against
``torch.func.jvp`` of the plain operator on the same inputs, and the
apply's linearity (``tangent_linearity_err``) within the same tolerance;
each kernel also against its own plain version (``compare_tangent_kernels``:
the apply on the prep's buffer within the tangent tolerance, the float64
prep's buffer within the operator tolerance of each row's max, each row of
the float32 prep's buffer within the float32 operator tolerance of the
float64 prep's row, or twice the plain float32 prep's distance from it;
w_pres, a sum the hydrostatic balance cancels, scaled by its interior
term):

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
from ..models import Euler3DRHS, ShallowWaterRHS
from ..ops import euler3d_operator as e3op
from ..ops import sw_operator as swop
from ..ops.dfr import make_dfr_operators
from ..parallel.topology import CubedSphereTopology
from ..testcases import dcmip_planet_params, initial_state_3d, williamson_case5, williamson_case6

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
    the scaled error ``err``, its tolerance ``tol``, the mass check
    (``mass_err`` of the h change, within ``tol``) and ``ok``."""
    con, topology, x, y = case6_inputs(nel, s, dtype, device, seed)
    halo = swop.halo_from_traces(swop.edge_traces(y, con), topology)
    wsg = sw_mass_weights(make_dfr_operators(s), con)
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
        row["mass_err"], row["mass_tol"] = mass_err(got, want, wsg, dtype, kw.get("x"), y, kw.get("a", 0.0),
                                                    kw.get("b", 1.0), "cdt" in kw, tol=tol)
        row["ok"] = bool(
            np.isfinite(row["err"]) and row["err"] <= tol
            and row.get("traces_err", 0.0) <= tol and torch.isfinite(got).all().item()
            and row["mass_err"] <= row["mass_tol"]
        )
        results.append(row)
    return results


def sw_work(nel: int, s: int, dtype, stage: bool = False, use_x: bool = False,
            traces: bool = False, pert: bool = False, npanel: int = 6, state: bool = False, topo: bool = False):
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
    ~50 more an interface point). ``npanel=1``: one nel x nel tile (the
    tile kernel), which reads its own slice of the metric. ``state``: the
    whole-sphere state mode (``halo=None``), which reads no halo: each
    panel-edge face point takes its neighbour's 3 values from the
    neighbour panel's nodes, which are elements of q and counted with it,
    reads the 4 rotation coefficients of the halo tables and rotates the
    momenta (6 operations); it writes no traces. ``topo``: the state mode
    with bottom topography also reads hsurf at the nodes and at the
    interfaces and the two forcing coefficients (3 words a node, 1 an
    interface point), adds hsurf to each h node of a face trace (s adds a
    face point of each side), subtracts it at each interface point from
    both sides (2) and adds two forcing products a node (4); in the
    perturbation form (``pert`` and ``topo``) the base planes carry the
    rest, so it reads the two forcing coefficients (2 words a node) and
    adds their two products with dh (4 operations a node)."""
    n_elem, s2, item = npanel * nel * nel, s * s, torch.finfo(dtype).bits // 8
    nstate = 3 * n_elem * s2
    words = 2 * nstate + (nstate if use_x else 0)  # q, out, x
    words += 13 * nel * nel * s2 + n_elem * s2  # one-panel metric, gridrot
    edge = 3 * 4 * npanel * nel * s
    words += 2 * 3 * nel * (nel + 1) * s  # itf
    words += 4 * edge // 3 if state else edge * (2 if traces else 1)  # conv (four an edge point); halo, traces
    node, face = 30, 40
    if pert:
        words += 8 * n_elem * s2 + 3 * n_elem * 4 * s + edge  # q0, u0, rhs0, itf0, halo0
        node, face = 55, 90
    # node: pointwise + 2 derivatives x 3 variables x s fma + 4 faces x 3
    # variables fma; interface point: 2 sides x 3 variables x s fma + flux
    ops = n_elem * (s2 * (node + 12 * s + 24) + 2 * s * (12 * s + face))
    ops += n_elem * s2 * 3 * ((2 if stage else 0) + (2 if use_x else 0))
    if state:
        ops += 6 * edge // 3
    if topo and pert:
        words += 2 * n_elem * s2
        ops += 4 * n_elem * s2
    elif topo:
        n_itf = 2 * 6 * nel * (nel + 1) * s
        words += 3 * n_elem * s2 + n_itf
        ops += 4 * n_elem * s2 + n_itf * (2 * s + 2)
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
    n_elem, item = con.npanel * nk * nh * nh, torch.finfo(con.dtype).bits // 8
    state = 5 * n_elem * s3
    words = state * (2 + (1 if use_x else 0) + (1 if use_bal else 0))  # q, out, x, bal
    words += _metric_words(con)
    words += 5 * 4 * con.npanel * nk * nh * s2 * (2 if traces else 1)  # halo, traces
    per_elem = s3 * (263 + 38 * s) + 6 * s2 * (10 * s + 2) + 3 * s2 * 90
    ops = n_elem * per_elem + state * ((2 if stage else 0) + (2 if use_x else 0) + (1 if use_bal else 0))
    ops += _sponge_ops(con)
    return words * item, ops


def _metric_words(con) -> int:
    """Words of the metric a call of the operator reads: the interior fields
    (one panel's, or all six on a per-panel metric), the time Christoffels,
    the interface metric and the Rayleigh sponge's planes."""
    words = con.fields.numel() + (con.tch.numel() if con.tch is not None else 0)
    words += con.itf_x.numel() + con.itf_y.numel() + con.itf_z.numel()
    return words + (con.sponge.numel() if con.sponge is not None else 0)


def _sponge_ops(con) -> int:
    """Operations of the Rayleigh sponge (3 rows of mask q - q0 (mask u_ref)
    added: 4 a node and row)."""
    return 0 if con.sponge is None else 12 * (con.sponge.numel() // 4)


# The model top of each DCMIP case (m): DCMIP 11/12, 20 and 21/22's
# specifications; 10 km for the others.
DCMIP_ZTOP = {11: 12000.0, 12: 12000.0, 20: 12000.0, 21: 30000.0, 22: 30000.0}


@functools.lru_cache(maxsize=None)
def euler3d_case(nel_h: int, nel_v: int, s: int, case: int = 31):
    """(geom, ops, metric, topology, q0, damping) of a DCMIP case at one
    shape (host float64; the terrain cases on their geometry with
    topography, 21/22 with their Rayleigh damping; cached, the metric at
    large shapes takes tens of seconds)."""
    scale, rotating = dcmip_planet_params(case)
    geom = make_cubed_sphere_3d(nel_h, nel_v, s, DCMIP_ZTOP.get(case, 10000.0), planet_scaling_factor=scale,
                                planet_is_rotating=rotating)
    ops = make_dfr_operators(s, three_d=True)
    topology = CubedSphereTopology(geom)
    q0, geom, metric, damping = initial_state_3d(geom, case, lambda g: make_metric_3d(g, ops, topology))
    return geom, ops, metric, topology, q0, damping


def euler3d_setup(nel_h: int, nel_v: int, s: int, case: int = 31):
    """(geom, ops, metric, topology, q0) of ``euler3d_case``."""
    return euler3d_case(nel_h, nel_v, s, case)[:5]


def euler3d_constants(nel_h: int, nel_v: int, s: int, case: int, dtype, device):
    """The operator's constants of a DCMIP case: every panel's metric on a
    geometry with topography, and the Rayleigh sponge of 21/22."""
    geom, ops, metric, _, _, damping = euler3d_case(nel_h, nel_v, s, case)
    return e3op.build_constants(ops, metric, nel_h, nel_v, dtype=dtype, device=device,
                                panel_metric=e3op.has_topography(geom), damping=damping)


def euler3d_tangent_inputs(nel_h: int, nel_v: int, s: int, dtype, device, case: int = 31, seed: int = 7):
    """(con, topology, q, v): constants, a state q = q0 + dq with dq =
    1e-4 q0 N(0,1), and a direction v = 1e-3 max|q0| N(0,1) per variable
    (tests/test_pallas_euler3d.py:238-244)."""
    geom, ops, metric, topology, q0 = euler3d_setup(nel_h, nel_v, s, case)
    rng = np.random.default_rng(seed)
    dq = 1e-4 * q0 * rng.standard_normal(q0.shape)
    v = rng.standard_normal(q0.shape) * np.abs(q0).reshape(5, -1).max(axis=1).reshape(5, 1, 1, 1, 1, 1) * 1e-3
    con = euler3d_constants(nel_h, nel_v, s, case, dtype, device)
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
    con = euler3d_constants(nel_h, nel_v, s, case, dtype, device)
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


def mass_weights(ops, con) -> torch.Tensor:
    """sqrt(g) times the quadrature weights w_i w_j w_k at every node of the
    constants' panel (or tile), float64: the weights of the mass integral
    (``output.global_mass_3d``)."""
    w = torch.as_tensor(np.asarray(ops.weights), dtype=torch.float64, device=con.fields.device)
    return con.fields[0].double() * torch.einsum("i,j,k->ijk", w, w, w).reshape(-1)


def sw_mass_weights(ops, con) -> torch.Tensor:
    """sqrt(g) times the quadrature weights w_i w_j at every node of the SW
    constants' panel (or tile), float64: the weights of the h integral."""
    w = torch.as_tensor(np.asarray(ops.weights), dtype=torch.float64, device=con.fields.device)
    return con.fields[0].double() * torch.outer(w, w).reshape(-1)


def mass_err(got, want, wsg, dtype, x=None, y=None, a: float = 0.0, b: float = 1.0, stage: bool = False,
             tol=None):
    """(err, limit) of the kernel's mass change against the plain version's:
    the weighted integrals (weights ``wsg``) of their rho (SW: h) change
    (the RHS, or ``out - a*x - b*y`` in stage mode), in float64; err is
    their difference over the plain change's absolute integral, limit the
    operator tolerance ``tol`` (default: the 3D one of the dtype) plus four
    units of rounding of the plain output's absolute integral over the
    same."""
    def change(out):
        c = out[0].double()
        if stage:
            c = c - b * y[0].double() - (a * x[0].double() if x is not None and a != 0.0 else 0.0)
        return wsg * c

    want_c = change(want)
    scale = float(want_c.abs().sum())
    rounding = 4.0 * torch.finfo(dtype).eps * float((wsg * want[0].double()).abs().sum())
    err = abs(float(change(got).sum() - want_c.sum())) / scale
    return err, (E3_TOLERANCE[dtype] if tol is None else tol) + rounding / scale


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
        con64 = euler3d_constants(nel_h, nel_v, s, case, torch.float64, device)
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
    wsg = mass_weights(euler3d_setup(nel_h, nel_v, s, case)[1], con)
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
               "mode": mode, "max_abs_err": float((got - want).abs().max()), "output_max": float(want.abs().max())}
        row["err_of_output_max"] = _scaled(got - want, per_variable_max(want))
        if term is None:
            row["scale"], row["err"] = "output_max", row["err_of_output_max"]
        else:
            cdt = abs(kw.get("cdt", 1.0))
            row["scale"] = "max(output_max, cdt*term)" if "cdt" in kw else "max(output_max, term)"
            row["err"] = _scaled(got - want, torch.maximum(per_variable_max(want), cdt * term))
        if got_tr is not None:
            tr_scale = per_variable_max(want_tr)
            if term is not None and con.panel_metric:
                # The traces of the output on its own scale: DCMIP 20's
                # winds are 0, so its momentum traces are cdt times RHS
                # contributions, whose float32 round-off the term scale
                # sets (as it does the output's).
                tr_scale = torch.maximum(tr_scale, abs(kw.get("cdt", 1.0)) * term)
                row["traces_scale"] = "max(traces_max, cdt*term)"
            row["traces_err"] = _scaled(got_tr - want_tr, tr_scale)
        row["tol"] = tol
        row["mass_err"], row["mass_tol"] = mass_err(got, want, wsg, dtype, kw.get("x"), y, kw.get("a", 0.0),
                                                    kw.get("b", 1.0), "cdt" in kw)
        ok = np.isfinite(row["err"]) and row["err"] <= tol and row.get("traces_err", 0.0) <= tol
        ok = ok and bool(torch.isfinite(got).all().item()) and row["mass_err"] <= row["mass_tol"]
        if mode == "rhs_bal":
            row.update(base)
            ok = ok and base["base_err_bal"] < 1e-2 and base["base_err_bal"] < 1e-3 * base["base_err_plain"]
        row["ok"] = bool(ok)
        results.append(row)
    return results


# The linearity check's combination a*v + b*w, w the direction rolled by
# one node.
TANGENT_LINEARITY = (0.7, -1.3)


def tangent_linearity_err(q, v, halo_q, direction_halo, con, pert=None) -> float:
    """How far the apply is from linear: apply(a v + b w) against a
    apply(v) + b apply(w) for one prep at q (``direction_halo``: the halo of
    a direction), scaled by each variable's max of apply(a v + b w)."""
    a, b = TANGENT_LINEARITY
    w = v.roll(1, dims=-1).contiguous()
    coef = e3op.euler3d_tangent_prep(q, halo_q, con, pert)
    apply = lambda x: e3op.euler3d_tangent_apply(x, direction_halo(x), coef, con)
    got = apply((a * v + b * w).contiguous()).double()
    return _scaled(got - (a * apply(v).double() + b * apply(w).double()), per_variable_max(got))


def _prep_rows(coef, con) -> dict:
    """{name: row} of a coefficient buffer: the node rows and each
    family's interface rows, the selector weights left out (a
    rounding-level tie may flip them)."""
    node, faces = e3op._tangent_parts(coef.values, con)
    rows = {name: node[..., r, :] for r, name in enumerate(e3op.TANGENT_NODE_ROWS)}
    for fam, face in zip("xyz", faces):
        rows.update({f"{fam}.{name}": face[r] for r, name in enumerate(e3op.TANGENT_FACE_ROWS) if name != "weight_L"})
    return rows


def compare_tangent_kernels(q, v, halo_q, halo_v, con, pert=None, ref64=None) -> dict:
    """Each tangent kernel against its plain version on the same inputs:
    the prep's coefficient buffer against ``euler3d_tangent_prep_plain``'s,
    row by row scaled by the row's max (``prep_err``; the selector weights
    apart: ``prep_weight_flips``, the share of entries that differ), and
    the apply on the prep's buffer against ``euler3d_tangent_apply_plain``
    on the same buffer, scaled by each variable's max (``apply_err``).

    With ``ref64``, the float64 plain prep's buffer at the float64 inputs
    (float32 checks), each row of the kernel's and of the plain float32
    buffer against it, scaled by its row's max (w_pres by a term scale):
    ``prep_rows`` {row: [kernel, plain]}, and ``prep_rows_over`` the rows
    where the kernel is further than ``prep_row_limit``."""
    coef = e3op.euler3d_tangent_prep(q, halo_q, con, pert)
    want = e3op.euler3d_tangent_prep_plain(q, halo_q, con, pert)
    got_jv = e3op.euler3d_tangent_apply(v, halo_v, coef, con)
    want_jv = e3op.euler3d_tangent_apply_plain(v, halo_v, coef, con)
    got_rows, want_rows = _prep_rows(coef, con), _prep_rows(want, con)
    weight = e3op.TANGENT_FACE_ROWS.index("weight_L")
    (_, gf), (_, wf) = e3op._tangent_parts(coef.values, con), e3op._tangent_parts(want.values, con)
    flips = sum(int((g[weight] != w[weight]).sum()) for g, w in zip(gf, wf))
    row_err = lambda g, w: float((g.double() - w).abs().max() / w.abs().max().clamp_min(1e-300))
    diffs = {k: float((got_rows[k] - want_rows[k]).abs().max()) for k in got_rows}
    worst = max(diffs, key=diffs.get)
    out = {
        "prep_err": max(row_err(got_rows[k], want_rows[k].double()) for k in got_rows),
        "prep_max_abs_err": diffs[worst],
        "prep_max_abs_row": worst,  # the row of prep_max_abs_err, and its max |value|
        "prep_max_abs_row_max": float(want_rows[worst].abs().max()),
        "prep_weight_flips": flips / sum(g[weight].numel() for g in gf),
        "apply_err": _scaled(got_jv - want_jv, per_variable_max(want_jv)),
        "apply_max_abs_err": float((got_jv - want_jv).abs().max()),
        "apply_output_max": float(want_jv.abs().max()),
    }
    if ref64 is not None:
        ref_rows = _prep_rows(ref64, con)
        # w_pres is a sum whose terms the hydrostatic balance cancels ~7-fold:
        # its scale is the larger of its max and the interior term's.
        scale = {k: r.abs().max() for k, r in ref_rows.items()}
        scale["w_pres"] = torch.maximum(scale["w_pres"], con.fields[-1].abs().max().double())
        err = lambda g, k: float((g.double() - ref_rows[k]).abs().max() / scale[k].clamp_min(1e-300))
        out["prep_rows"] = {k: [err(got_rows[k], k), err(want_rows[k], k)] for k in got_rows}
        out["prep_row_limit"] = f"max({E3_TOLERANCE[torch.float32]:g}, 2 * plain)"
        out["prep_rows_over"] = [k for k, (kern, plain) in out["prep_rows"].items()
                                 if not kern <= max(E3_TOLERANCE[torch.float32], 2.0 * plain)]
    return out


def _tangent_kernels_ok(row, dtype) -> bool:
    """The apply within the tangent tolerance of its plain version on the
    same buffer. The float64 prep within the operator tolerance of its
    plain version, row by row; each row of the float32 prep within the
    float32 operator tolerance of the float64 prep's row, or within twice
    the plain float32 prep's distance from it (the rule of the float32 J.v
    checks: the w_pres row is a sum the hydrostatic balance cancels)."""
    if dtype == torch.float64:
        prep_ok = row["prep_err"] <= E3_TOLERANCE[dtype]
    else:
        prep_ok = "prep_rows" in row and not row["prep_rows_over"]
    return prep_ok and row["apply_err"] <= E3_TANGENT_TOLERANCE[dtype]


def _same_side(ref64, coef, con) -> e3op.TangentCoefficients:
    """The float64 prep's buffer ``ref64`` with the selector weights of the
    buffer ``coef``. Where the Rusanov speeds aL = |vL| + cL and aR = |vR| +
    cR lie within rounding of each other (at rest, the two sides' sound
    speeds), float32 may order them either way, and d max(aL, aR) takes the
    larger side's derivative: the float64 apply on this buffer takes the
    side ``coef`` took (either one-sided derivative is the function's), so
    a float32 J.v is held to it at every element."""
    values = ref64.values.clone()
    weight = e3op.TANGENT_FACE_ROWS.index("weight_L")
    for f64, f32 in zip(e3op._tangent_parts(values, con)[1], e3op._tangent_parts(coef.values, con)[1]):
        f64[weight] = f32[weight].to(f64.dtype)
    return e3op.TangentCoefficients(values, ref64.pert)


def _side_truths(row, q, halo_q, con, pert, ref64, v64, halo_v64, con64):
    """The truths of the float32 J.v rows on terrain (``panel_metric``):
    the float64 apply on ``ref64`` (the float64 plain prep) with the
    selector weights of the kernel's prep and of the plain float32 prep at
    ``q`` (``_same_side``), [kernel's, plain's]. ``side_flips`` [kernel,
    plain]: the interface points where that prep took another side than
    float64's, of ``interface_points``."""
    preps = (e3op.euler3d_tangent_prep(q, halo_q, con, pert), e3op.euler3d_tangent_prep_plain(q, halo_q, con, pert))
    weight = e3op.TANGENT_FACE_ROWS.index("weight_L")
    ref_faces = e3op._tangent_parts(ref64.values, con64)[1]
    flips = lambda c: sum(int((f[weight].double() != r[weight]).sum())
                          for f, r in zip(e3op._tangent_parts(c.values, con64)[1], ref_faces))
    row["side_flips"] = [flips(c) for c in preps]
    row["interface_points"] = sum(r[weight].numel() for r in ref_faces)
    return [e3op.euler3d_tangent_apply_plain(v64, halo_v64, _same_side(ref64, c, con64), con64) for c in preps]


def compare_euler3d_tangent(nel_h: int, nel_v: int, s: int, dtype, device="cuda", case: int = 31, seed: int = 7):
    """The tangent kernels (prep, then apply) against the plain tangent
    (``torch.func.jvp`` of the plain operator) on the same inputs, and the
    apply's linearity in v (within the same tolerance); returns one row with
    the scaled error ``err``, ``linearity_err``, the tolerance ``tol`` and
    ``ok`` (scales in the module docstring)."""
    con, topology, q, v = euler3d_tangent_inputs(nel_h, nel_v, s, dtype, device, case, seed)
    halo_q, halo_v = tangent_halos(q, v, con, topology)
    got = e3op.euler3d_tangent(q, v, halo_q, halo_v, con)
    want = e3op.euler3d_tangent_plain(q, v, halo_q, halo_v, con)
    traces = e3op.edge_traces(q, con)
    direction_halo = lambda x: e3op.halo_from_traces(e3op.edge_traces_tangent(q, x, con, traces), topology)
    linearity = tangent_linearity_err(q, v, halo_q, direction_halo, con)
    if device != "cpu":
        torch.cuda.synchronize()
    if dtype == torch.float64:
        row = {"scale": "output_max", "err": _scaled(got - want, per_variable_max(want)),
               **compare_tangent_kernels(q, v, halo_q, halo_v, con)}
    else:
        con64, _, q64, v64 = euler3d_tangent_inputs(nel_h, nel_v, s, torch.float64, device, case, seed)
        ref64 = e3op.euler3d_tangent_prep_plain(q64, tangent_halos(q64, v64, con64, topology)[0], con64)
        row = compare_tangent_kernels(q, v, halo_q, halo_v, con, ref64=ref64)
        f64_tangent = lambda q_, v_: e3op.euler3d_tangent_plain(q_, v_, *tangent_halos(q_, v_, con64, topology),
                                                               con64)
        truth = f64_tangent(q64, v64)
        sc = per_variable_max(truth)
        row["scale"] = "f64_plain_output_max"
        truth_got = truth_want = truth
        if con.panel_metric:
            truth_got, truth_want = _side_truths(row, q, halo_q, con, None, ref64, v64,
                                                 tangent_halos(q64, v64, con64, topology)[1], con64)
        row["err"] = _scaled(got.double() - truth_got, sc)
        row["plain_err"] = _scaled(want.double() - truth_want, sc)
        row["kernel_vs_plain_err"] = _scaled(got.double() - want.double(), sc)
        # The float64 operator at the float32-rounded inputs: what rounding
        # the inputs alone moves J.v (large where a normal speed sits at
        # round-off level and d|vn| flips with its sign).
        row["input_rounding_err"] = _scaled(f64_tangent(q.double(), v.double()) - truth, sc)
    row = {"nel_h": nel_h, "nel_v": nel_v, "s": s, "case": case, "dtype": str(dtype).replace("torch.", ""),
           "mode": "tangent", "max_abs_err": float((got - want).abs().max()), "linearity_err": linearity, **row}
    row["tol"] = E3_TANGENT_TOLERANCE[dtype]
    limit = max(row["tol"], 2.0 * row.get("plain_err", 0.0))
    row["ok"] = bool(np.isfinite(row["err"]) and row["err"] <= limit and linearity <= row["tol"]
                     and _tangent_kernels_ok(row, dtype) and torch.isfinite(got).all().item())
    return row


def euler3d_tangent_work(con):
    """(bytes, operations) of the Jacobian action J(q).v as one call (the
    function's bound; the apply's own is ``euler3d_tangent_apply_work``),
    counted as ``euler3d_work`` counts them: q, v and both halos read once,
    J.v written once, the metric read once; operations of the linearised
    algorithm (primal and derivative of each site: pointwise ~370 + 44 s a
    point, each face's primal and direction traces once, ~170 a face point
    for the Rusanov flux and its derivative)."""
    nh, nk, s = con.nel_h, con.nel_v, con.s
    s2, s3 = s * s, s**3
    n_elem, item = 6 * nk * nh * nh, torch.finfo(con.dtype).bits // 8
    words = 3 * 5 * n_elem * s3  # q, v, out
    words += _metric_words(con)
    words += 2 * 5 * 4 * 6 * nk * nh * s2  # halo_q, halo_v
    per_elem = s3 * (370 + 44 * s) + 6 * s2 * (20 * s + 4) + 3 * s2 * 170
    return words * item, n_elem * per_elem + _sponge_ops(con)


def _tangent_read_words(con) -> int:
    """Words of the metric the apply reads: every interior field but the
    interior w-pressure term (folded into the coefficients), the time
    Christoffels, the interface metric and the Rayleigh sponge's planes."""
    return _metric_words(con) - con.fields[-1].numel()


def euler3d_tangent_apply_work(con):
    """(bytes, operations) of one apply, counted as ``euler3d_work`` counts
    them: v and its halo read once, J.v written once, the coefficient
    buffer (``tangent_layout``) and the metric it needs read once. The
    apply's own floor, beside the function's (``euler3d_tangent_work``):
    the coefficients are its price for doing no transcendental, square root
    or division. Operations of its linear algebra: ~270 + 38 s a point
    (log-tangent rows, divergence, corrections, gradients, forcing), ~22 s
    + 114 a face point an element (both direction traces and the flux
    derivative; an interior interface is computed from each side)."""
    nh, nk, s = con.nel_h, con.nel_v, con.s
    s2, s3 = s * s, s**3
    n_elem, item = 6 * nk * nh * nh, torch.finfo(con.dtype).bits // 8
    words = 2 * 5 * n_elem * s3 + e3op.tangent_layout(con)["size"] + _tangent_read_words(con)
    words += 5 * 4 * 6 * nk * nh * s2  # halo_v
    per_elem = s3 * (270 + 38 * s) + 6 * s2 * (22 * s + 114)
    return words * item, n_elem * per_elem + _sponge_ops(con)


def euler3d_tangent_prep_work(con, pert: bool = False):
    """(bytes, operations) of one prep, counted as ``euler3d_work`` counts
    them: q (and q0) and the halo (and the base halo) read once, the
    coefficient buffer written once, the metric it needs (sqrt(g), h^{k2},
    the w-pressure term, the interface metric) read once. Operations: the
    primal pointwise work (~40 + 12 s a point, ~70 + 12 s in perturbation
    form), each face's own and neighbour primal traces with the pressures,
    sound speeds, eigenvalue and coefficients (~24 s + 60 a face point,
    ~48 s + 110 in perturbation form)."""
    nh, nk, s = con.nel_h, con.nel_v, con.s
    s2, s3 = s * s, s**3
    n_elem, item = 6 * nk * nh * nh, torch.finfo(con.dtype).bits // 8
    metric_panels = 6 if con.panel_metric else 1
    words = (2 if pert else 1) * (5 * n_elem * s3 + 5 * 4 * 6 * nk * nh * s2) + e3op.tangent_layout(con)["size"]
    words += 5 * metric_panels * nk * nh * nh * s3 + con.itf_x.numel() + con.itf_y.numel() + con.itf_z.numel()
    if pert:
        per_elem = s3 * (70 + 12 * s) + 6 * s2 * (48 * s + 110)
    else:
        per_elem = s3 * (40 + 12 * s) + 6 * s2 * (24 * s + 60)
    return words * item, n_elem * per_elem


def tangent_kernel_resources(dtype, s: int) -> dict:
    """{"prep", "pert_prep", "apply": {registers, local_bytes, smem_bytes,
    blocks_per_sm, threads}}: what the runtime reports of the tangent
    kernels at one dtype and s (on the card; builds the library)."""
    import ctypes

    from .build import load_library

    lib = load_library("euler3d_operator")
    out = {}
    for kernel, name in enumerate(("prep", "pert_prep", "apply")):
        info = (ctypes.c_int * 5)()
        rc = lib.euler3d_tangent_resources(1 if dtype == torch.float64 else 0, s, kernel,
                                           ctypes.cast(info, ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"euler3d_tangent_resources failed: CUDA error {rc}")
        out[name] = dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm", "threads"), info))
    return out


def operator_kernel_resources(dtype, s: int) -> dict:
    """{"absolute", "perturbation": {"interface", "volume": {registers,
    local_bytes, smem_bytes, blocks_per_sm, threads}}}: what the runtime
    reports of the operator's two kernels at one dtype and s (on the card;
    builds the library)."""
    import ctypes

    from .build import load_library

    lib = load_library("euler3d_operator")
    out = {}
    for pert, form in enumerate(("absolute", "perturbation")):
        out[form] = {}
        for kernel, name in enumerate(("interface", "volume")):
            info = (ctypes.c_int * 5)()
            rc = lib.euler3d_operator_resources(1 if dtype == torch.float64 else 0, s, pert, kernel,
                                                ctypes.cast(info, ctypes.c_void_p))
            if rc != 0:
                raise RuntimeError(f"euler3d_operator_resources failed: CUDA error {rc}")
            out[form][name] = dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm", "threads"), info))
    return out


def terrain_kernel_resources(dtype, s: int) -> dict:
    """{"interface", "volume", "pert_interface", "pert_volume", "prep",
    "pert_prep", "apply": {registers, local_bytes, smem_bytes,
    blocks_per_sm, threads}}: what the runtime reports of the terrain
    instantiations (per-panel metric; the volume pass and apply with the
    sponge's parameter) at one dtype and s (on the card; builds the
    library)."""
    import ctypes

    from .build import load_library

    lib = load_library("euler3d_terrain")
    keys = ("registers", "local_bytes", "smem_bytes", "blocks_per_sm", "threads")
    out = {}
    names = ("interface", "volume", "pert_interface", "pert_volume", "prep", "pert_prep", "apply")
    for kernel, name in enumerate(names):
        info = (ctypes.c_int * 5)()
        rc = lib.euler3d_terrain_resources(1 if dtype == torch.float64 else 0, s, kernel,
                                           ctypes.cast(info, ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"terrain kernel resources ({name}) failed: CUDA error {rc}")
        out[name] = dict(zip(keys, info))
    return out


def compare_terrain_flat(nel_h: int, nel_v: int, s: int, dtype, device="cuda", seed: int = 0):
    """The terrain instantiations on flat constants: DCMIP 31's one-panel
    constants copied to every panel (``e3op.expand_panels``) through the
    terrain kernels against the same constants through the kernels without
    terrain, asked bit for bit (``torch.equal``) in every mode: the RHS,
    stage + x + traces, the perturbation RHS and stage + traces, the prep
    (absolute and perturbation) and the apply. Returns one row."""
    con, topology, x, y = euler3d_inputs(nel_h, nel_v, s, dtype, device, 31, seed)
    cx = e3op.expand_panels(con)
    halo = e3op.halo_from_traces(e3op.edge_traces(y, con), topology)
    _, _, pert, dq, v = euler3d_pert_inputs(nel_h, nel_v, s, dtype, device, 31, seed)
    halo_dq, halo_v = pert_halos(dq, v, pert, con, topology)
    calls = {
        "rhs": lambda c: (e3op.euler3d_operator(y, halo, c),),
        "stage_x_traces": lambda c: e3op.euler3d_operator(y, halo, c, x=x, a=0.75, b=0.25, cdt=0.25 * E3_DT,
                                                          emit_traces=True),
        "pert_rhs": lambda c: (e3op.euler3d_operator(dq, halo_dq, c, pert=pert),),
        "pert_stage_traces": lambda c: e3op.euler3d_operator(dq, halo_dq, c, b=1.0, cdt=E3_DT, emit_traces=True,
                                                             pert=pert),
        "prep": lambda c: (e3op.euler3d_tangent_prep(y, halo, c).values,),
        "pert_prep": lambda c: (e3op.euler3d_tangent_prep(dq, halo_dq, c, pert).values,),
        "apply": lambda c: (e3op.euler3d_tangent_apply(v, halo_v, e3op.euler3d_tangent_prep(dq, halo_dq, con, pert),
                                                       c),),
    }
    identical = {mode: all(torch.equal(a, b) for a, b in zip(call(con), call(cx))) for mode, call in calls.items()}
    return {"nel_h": nel_h, "nel_v": nel_v, "s": s, "case": 31, "dtype": str(dtype).replace("torch.", ""),
            "mode": "terrain_on_flat_constants", "identical": identical, "err": 0.0 if all(identical.values()) else
            float("inf"), "tol": 0.0, "max_abs_err": 0.0, "ok": all(identical.values())}


def compare_sponge_rows(nel_h: int, nel_v: int, s: int, dtype, device="cuda", seed: int = 0):
    """The Rayleigh sponge acts on the momenta only: on DCMIP 21's noisy
    state, the terrain kernels' RHS and J.v with the sponge against the same
    calls without it (``sponge=None``): rho and rho*theta bit for bit, and
    the difference of the momentum rows against the plain sponge term ``mask
    q[1+i] - q[0] (mask u_ref_i)`` (of v for J.v) within the dtype's
    operator tolerance of the larger of that term's and the rows' max (the
    difference of two outputs carries their rounding). Returns one row."""
    import dataclasses

    con, topology, x, y = euler3d_inputs(nel_h, nel_v, s, dtype, device, 21, seed)
    bare = dataclasses.replace(con, sponge=None)
    halo = e3op.halo_from_traces(e3op.edge_traces(y, con), topology)
    coef = e3op.euler3d_tangent_prep(y, halo, con)
    v = (x - y).contiguous()
    calls = {"rhs": (lambda c: e3op.euler3d_operator(y, halo, c), y),
             "apply": (lambda c: e3op.euler3d_tangent_apply(v, halo, coef, c), v)}
    row = {"nel_h": nel_h, "nel_v": nel_v, "s": s, "case": 21, "dtype": str(dtype).replace("torch.", ""),
           "mode": "sponge_rows", "tol": E3_TOLERANCE[dtype], "max_abs_err": 0.0}
    ok = True
    for mode, (call, q) in calls.items():
        with_sponge, without = call(con), call(bare)
        sp = con.sponge.double()
        term = sp[0] * q[1:4].double() - q[0].double() * sp[1:4]
        diff = without[1:4].double() - with_sponge[1:4].double()  # the RHS subtracts the sponge's forcing
        row[f"{mode}_other_rows_identical"] = bool(torch.equal(with_sponge[0], without[0])
                                                   and torch.equal(with_sponge[4], without[4]))
        scale = torch.maximum(term.abs().max(), with_sponge[1:4].double().abs().max())
        row[f"{mode}_err"] = float((diff - term).abs().max() / scale)
        ok = ok and row[f"{mode}_other_rows_identical"] and row[f"{mode}_err"] <= row["tol"]
    row["err"] = max(row["rhs_err"], row["apply_err"])
    row["ok"] = bool(ok)
    return row


def sw_kernel_resources(dtype, s: int) -> dict:
    """{"absolute", "perturbation", "state_absolute", "state_perturbation",
    "state_topo", "state_pert_topo": {registers, local_bytes, smem_bytes,
    blocks_per_sm, threads}} of the SW operator kernel at one dtype and s
    (its largest block; halo plane and state mode, and the state mode with
    topography in absolute and perturbation form),
    and at s = 4 also "run", "run_pert" of the
    whole-run kernel: what the runtime reports (on the card; builds the
    libraries)."""
    import ctypes

    from .build import load_library

    keys = ("registers", "local_bytes", "smem_bytes", "blocks_per_sm", "threads")
    f64 = 1 if dtype == torch.float64 else 0
    out = {}
    lib = load_library("sw_operator")
    for pert, form in enumerate(("absolute", "perturbation")):
        for prefix, entry in (("", lib.sw_operator_resources), ("state_", lib.sw_operator_state_resources)):
            info = (ctypes.c_int * 5)()
            rc = entry(f64, s, pert, ctypes.cast(info, ctypes.c_void_p))
            if rc != 0:
                raise RuntimeError(f"{prefix}operator resources failed: CUDA error {rc}")
            out[prefix + form] = dict(zip(keys, info))
        if s == 4:
            info = (ctypes.c_int * 5)()
            rc = load_library("sw_run").sw_run_resources(f64, pert, ctypes.cast(info, ctypes.c_void_p))
            if rc != 0:
                raise RuntimeError(f"sw_run_resources failed: CUDA error {rc}")
            out["run_pert" if pert else "run"] = dict(zip(keys, info))
    for name, entry in (("state_topo", lib.sw_operator_topo_resources),
                        ("state_pert_topo", lib.sw_operator_pert_topo_resources)):
        info = (ctypes.c_int * 5)()
        rc = entry(f64, s, ctypes.cast(info, ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"{name} operator resources failed: CUDA error {rc}")
        out[name] = dict(zip(keys, info))
    return out


def euler3d_pert_inputs(nel_h: int, nel_v: int, s: int, dtype, device, case: int = 31, seed: int = 7):
    """(con, topology, pert, dq, v): the perturbation form's inputs at the
    tangent inputs' state q0 + dq (``euler3d_tangent_inputs``): the base
    around q0 (built in float64 on ``device``, cast to ``dtype``), dq =
    q - q0 in ``dtype`` and the direction v."""
    geom, ops, metric, topology, q0 = euler3d_setup(nel_h, nel_v, s, case)
    con, _, q, v = euler3d_tangent_inputs(nel_h, nel_v, s, dtype, device, case, seed)
    con64 = euler3d_constants(nel_h, nel_v, s, case, torch.float64, device)
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
    truth = ref64 = None
    if dtype == torch.float32:
        con64, _, pert64, dq64, v64 = euler3d_pert_inputs(nel_h, nel_v, s, torch.float64, device, case, seed)
        h64 = pert_halos(dq64, v64, pert64, con64, topology)
        truth = {"rhs": e3op.euler3d_operator_pert_plain(dq64, h64[0], con64, pert64),
                 "tangent": e3op.euler3d_tangent_pert_plain(dq64, v64, *h64, con64, pert64)}
        ref64 = e3op.euler3d_tangent_prep_plain(dq64, h64[0], con64, pert64)
    for mode in ("rhs", "tangent"):
        linearity = None
        if mode == "rhs":
            got = e3op.euler3d_operator(dq, halo_dq, con, pert=pert)
            want = e3op.euler3d_operator_pert_plain(dq, halo_dq, con, pert)
        else:
            got = e3op.euler3d_tangent(dq, v, halo_dq, halo_v, con, pert=pert)
            want = e3op.euler3d_tangent_pert_plain(dq, v, halo_dq, halo_v, con, pert)
            linearity = tangent_linearity_err(dq, v, halo_dq, lambda x: pert_halos(dq, x, pert, con, topology)[1],
                                              con, pert)
        if device != "cpu":
            torch.cuda.synchronize()
        ref = want if truth is None else truth[mode]
        scale = per_variable_max(ref)
        if mode == "rhs":
            scale = torch.maximum(scale, euler3d_term_scale(pert.q0 + dq, con).to(ref.dtype))
        row = {"nel_h": nel_h, "nel_v": nel_v, "s": s, "case": case, "dtype": str(dtype).replace("torch.", ""),
               "mode": f"pert_{mode}", "max_abs_err": float((got - want).abs().max()),
               "output_max": float(want.abs().max()),
               "scale": "max(output_max, term)" if mode == "rhs" else "output_max"}
        ref_got = ref_want = ref
        if truth is not None and mode == "tangent" and con.panel_metric:
            ref_got, ref_want = _side_truths(row, dq, halo_dq, con, pert, ref64, v64, h64[1], con64)
        row["err"] = _scaled(got.to(ref.dtype) - ref_got, scale)
        if truth is None:
            row["tol"] = E3_TOLERANCE[dtype]
            limit = row["tol"]
        else:
            row["scale"] = "f64_plain_" + row["scale"]
            row["plain_err"] = _scaled(want.double() - ref_want, scale)
            row["kernel_vs_plain_err"] = _scaled(got.double() - want.double(), scale)
            row["tol"] = E3_TANGENT_TOLERANCE[dtype]
            limit = max(row["tol"], 2.0 * row["plain_err"])
        ok = np.isfinite(row["err"]) and row["err"] <= limit and torch.isfinite(got).all().item()
        if mode == "rhs":
            wsg = mass_weights(euler3d_setup(nel_h, nel_v, s, case)[1], con)
            row["mass_err"], row["mass_tol"] = mass_err(got, want, wsg, dtype)
            ok = ok and row["mass_err"] <= row["mass_tol"]
        if linearity is not None:
            row["linearity_err"] = linearity
            row.update(compare_tangent_kernels(dq, v, halo_dq, halo_v, con, pert, ref64))
            ok = ok and linearity <= E3_TANGENT_TOLERANCE[dtype] and _tangent_kernels_ok(row, dtype)
        row["ok"] = bool(ok)
        rows.append(row)
    return rows


def compare_euler3d_pert_stage(nel_h: int, nel_v: int, s: int, dtype, device="cuda", case: int = 31,
                               seed: int = 7):
    """The perturbation mode's stage kernel (``a*dx + b*dq + cdt*(rhs0 +
    delta)`` with the output's delta traces) against its plain version on
    the same inputs, at a = 0 and a != 0; returns one row per mode.

    float64: the output within 1e-12 of the plain output per variable,
    scaled by the larger of its max and cdt times the RHS term scale (the
    absolute stage check's scale), the traces within 1e-12 of the plain
    traces' max. float32: both against the float64 plain version on the
    float64 inputs, within 5e-5 of those scales or twice the float32 plain
    version's distance (the rule of ``compare_euler3d_pert``). In both, the
    kernel's emitted traces within the dtype's operator tolerance
    (``E3_TOLERANCE``) of ``edge_traces_delta`` of its own output, the
    bootstrap they stand in for."""
    con, topology, pert, dq, _ = euler3d_pert_inputs(nel_h, nel_v, s, dtype, device, case, seed)
    q0 = euler3d_setup(nel_h, nel_v, s, case)[4]
    dx64 = 1e-4 * q0 * np.random.default_rng(seed + 1).standard_normal(q0.shape)
    dx = torch.as_tensor(dx64, dtype=dtype, device=device)
    halo = e3op.halo_from_traces(e3op.edge_traces_delta(dq, pert, con), topology)
    modes = {"pert_stage": dict(a=0.0, b=1.0, cdt=E3_DT),
             "pert_stage_x": dict(x=dx, a=0.75, b=0.25, cdt=0.25 * E3_DT)}
    truth = {}
    if dtype == torch.float32:
        con64, _, pert64, dq64, _ = euler3d_pert_inputs(nel_h, nel_v, s, torch.float64, device, case, seed)
        halo64 = e3op.halo_from_traces(e3op.edge_traces_delta(dq64, pert64, con64), topology)
        x64 = torch.as_tensor(dx64, device=device)
        for mode, kw in modes.items():
            kw64 = dict(kw, x=x64) if "x" in kw else kw
            truth[mode] = e3op.euler3d_operator_pert_plain(dq64, halo64, con64, pert64, emit_traces=True, **kw64)
    term = euler3d_term_scale(pert.q0 + dq, con)
    wsg = mass_weights(euler3d_setup(nel_h, nel_v, s, case)[1], con)
    rows = []
    for mode, kw in modes.items():
        got, got_tr = e3op.euler3d_operator(dq, halo, con, emit_traces=True, pert=pert, **kw)
        want, want_tr = e3op.euler3d_operator_pert_plain(dq, halo, con, pert, emit_traces=True, **kw)
        self_tr = e3op.edge_traces_delta(got, pert, con)
        if device != "cpu":
            torch.cuda.synchronize()
        ref, ref_tr = truth.get(mode, (want, want_tr))
        scale = torch.maximum(per_variable_max(ref), kw["cdt"] * term.to(ref.dtype))
        tr_scale = per_variable_max(ref_tr)
        row = {"nel_h": nel_h, "nel_v": nel_v, "s": s, "case": case, "dtype": str(dtype).replace("torch.", ""),
               "mode": mode, "max_abs_err": float((got - want).abs().max()), "output_max": float(want.abs().max()),
               "scale": "max(output_max, cdt*term)", "err": _scaled(got.to(ref.dtype) - ref, scale),
               "traces_err": _scaled(got_tr.to(ref.dtype) - ref_tr, tr_scale),
               "traces_self_err": _scaled(got_tr - self_tr, per_variable_max(self_tr))}
        if not truth:
            row["tol"] = E3_TOLERANCE[dtype]
            limit = traces_limit = row["tol"]
        else:
            row["scale"] = "f64_plain_" + row["scale"]
            row["plain_err"] = _scaled(want.double() - ref, scale)
            row["plain_traces_err"] = _scaled(want_tr.double() - ref_tr, tr_scale)
            row["tol"] = E3_TANGENT_TOLERANCE[dtype]
            limit = max(row["tol"], 2.0 * row["plain_err"])
            traces_limit = max(row["tol"], 2.0 * row["plain_traces_err"])
        ok = np.isfinite(row["err"]) and row["err"] <= limit and row["traces_err"] <= traces_limit
        ok = ok and row["traces_self_err"] <= E3_TOLERANCE[dtype]
        row["mass_err"], row["mass_tol"] = mass_err(got, want, wsg, dtype, kw.get("x"), dq, kw["a"], kw["b"], True)
        ok = ok and row["mass_err"] <= row["mass_tol"]
        row["ok"] = bool(ok and torch.isfinite(got).all().item() and torch.isfinite(got_tr).all().item())
        rows.append(row)
    return rows


def euler3d_pert_work(con, tangent: bool = False, stage: bool = False, use_x: bool = False,
                      traces: bool = False):
    """(bytes, operations) of one perturbation-mode call, counted as
    ``euler3d_work`` counts them. RHS mode reads dq, q0, rhs0, the metric,
    the delta and base halos and writes rhs0 + delta; tangent mode reads
    dq, q0, v, the metric and three halos (delta, base, direction) and
    writes J.v. Operations of the expanded algorithm: each face's base and
    perturbation traces once (and the direction's in tangent mode), the
    pointwise deltas (~330 + 40 s a point; tangent ~430 + 44 s), ~200
    operations a face point for the delta Rusanov flux and its face
    corrections (tangent ~280 with the linearised flux). Stage mode adds
    the combination b*dq + cdt*out (and a*x: x read once) a value; the
    delta traces read the base traces and write the output's, 14 s + 4
    operations an edge face point and variable row (the extrapolation, and
    for rho and rho*theta the log1p of the quotient and t0*expm1)."""
    nh, nk, s = con.nel_h, con.nel_v, con.s
    s2, s3 = s * s, s**3
    n_elem, item = con.npanel * nk * nh * nh, torch.finfo(con.dtype).bits // 8
    state, edge = 5 * n_elem * s3, 5 * 4 * con.npanel * nk * nh * s2
    words = 4 * state  # dq, q0, rhs0 or v, out
    words += _metric_words(con)
    words += (3 if tangent else 2) * edge  # halos
    words += (state if use_x else 0) + (2 * edge if traces else 0)  # x; traces0 and the traces
    if tangent:
        per_elem = s3 * (430 + 44 * s) + 6 * s2 * 3 * (10 * s + 4) + 3 * s2 * 280
    else:
        per_elem = s3 * (330 + 40 * s) + 6 * s2 * 2 * (10 * s + 4) + 3 * s2 * 200
    ops = n_elem * per_elem + state * ((2 if stage else 0) + (2 if use_x else 0))
    ops += edge * (14 * s + 4) if traces else 0
    return words * item, ops


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
    scale where that is larger (the f32 bound of the absolute check).
    Each row also holds mass: ``mass_err`` of the h change against the
    plain version's, within ``SW_PERT_TOLERANCE``."""
    con, topology, base, dq, x = sw_pert_inputs(nel, s, dtype, device, seed)
    halo = swop.halo_from_traces(swop.edge_traces(dq, con), topology)
    wsg = sw_mass_weights(sw_setup(nel, s)[1], con)
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
        row["mass_err"], row["mass_tol"] = mass_err(got, want, wsg, dtype, kw.get("x"), dq, kw.get("a", 0.0),
                                                    kw.get("b", 1.0), "cdt" in kw, tol=SW_PERT_TOLERANCE[dtype])
        row["ok"] = bool(ok and row["mass_err"] <= row["mass_tol"])
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


def compare_sw_state_halo(nel: int, s: int, dtype, device="cuda", seed: int = 0):
    """The operator's state mode (``halo=None``: each panel-edge face reads
    the neighbour panel's state) against the same operator fed
    ``sw_halo(sw_edges(q))`` (on the card the edge-trace, halo and operator
    kernels, three launches), absolute and perturbation form, RHS and
    stages with a = 0 and a != 0; one row per mode. The two are asked to be
    bit for bit equal (``bit_identical``, ``torch.equal``: the state mode
    calls the same device functions in the same order). Each row also
    holds mass against the plain version (``mass_err`` of the h change,
    within the operator's tolerance), and reports its distance from it."""
    con, topology, x, y = case6_inputs(nel, s, dtype, device, seed)
    pcon, _, base, dq, dx = sw_pert_inputs(nel, s, dtype, device, seed)
    wsg = sw_mass_weights(sw_setup(nel, s)[1], con)
    modes = {"rhs": {}, "stage": dict(a=0.0, b=1.0, cdt=DT), "stage_x": dict(a=0.75, b=0.25, cdt=0.25 * DT)}
    rows = []
    for form, q, c, b, xx, tol in (("", y, con, None, x, TOLERANCE[dtype]),
                                   ("pert_", dq, pcon, base, dx, SW_PERT_TOLERANCE[dtype])):
        for mode, kw in modes.items():
            kw = dict(kw, x=xx) if "a" in kw and kw["a"] != 0.0 else kw
            got = swop.sw_operator(q, None, c, base=b, topology=topology, **kw)
            route = swop.sw_operator(q, swop.sw_halo(swop.sw_edges(q, c), topology), c, base=b, **kw)
            plain = swop.sw_operator_plain(q, None, c, base=b, topology=topology, **kw)
            if device != "cpu":
                torch.cuda.synchronize()
            row = {"nel": nel, "s": s, "dtype": str(dtype).replace("torch.", ""), "mode": f"state_{form}{mode}",
                   "bit_identical": bool(torch.equal(got, route)),
                   "max_abs_err": float((got - route).abs().max()), "scale": "route_output_max",
                   "err": _scaled(got - route, per_variable_max(route)),
                   "plain_err": _scaled(got - plain, per_variable_max(plain)), "tol": tol}
            row["mass_err"], row["mass_tol"] = mass_err(got, plain, wsg, dtype, kw.get("x"), q, kw.get("a", 0.0),
                                                        kw.get("b", 1.0), "cdt" in kw, tol=tol)
            row["ok"] = bool(row["bit_identical"] and torch.isfinite(got).all().item()
                             and row["mass_err"] <= row["mass_tol"])
            rows.append(row)
    return rows


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
    reported, and the difference must stay within the same limit. The run's
    h change over all its steps also holds mass against the plain loop's
    (``mass_err``, within ``SW_PERT_TOLERANCE``)."""
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
    row["mass_err"], row["mass_tol"] = mass_err(got, want, sw_mass_weights(ops, con), dtype, y=q, stage=True,
                                                tol=SW_PERT_TOLERANCE[dtype])
    row["ok"] = bool(np.isfinite(row["err"]) and row["err"] <= limit and row["chain_err"] <= limit
                     and torch.isfinite(got).all().item() and row["mass_err"] <= row["mass_tol"])
    return row


# ---------------------------------------------------------------------------
# Shallow water: the Jacobian action J(q).v (the tangent kernel)

SW_TANGENT_TOLERANCE = {torch.float64: 1e-12, torch.float32: 1e-5}
# Steps of the centred difference (q +- eps v) against the tangent; the
# direction is 1e-3 of each variable's max, so eps = 0.01 moves q by 1e-5 of
# it.
SW_FD_STEPS = (0.01, 0.005)
SW_FD_QUANTILE = 0.99


@functools.lru_cache(maxsize=None)
def sw_topo_setup(nel: int, s: int):
    """(geom, ops, metric, topology, q0, topo) of Williamson case 5 (host
    float64; ``topo`` the numpy Topography; cached)."""
    geom = make_cubed_sphere_2d(nel, s)
    ops = make_dfr_operators(s)
    q0, topo = williamson_case5(geom, ops)
    return geom, ops, make_metric_2d(geom), CubedSphereTopology(geom), q0, topo


def sw_topo_inputs(nel: int, s: int, dtype, device, seed: int = 0):
    """(con, topology, topo, x, y, zero): case-5 constants, topology and
    topography planes (``ops.sw_operator.SWTopography``), two case-5 states
    perturbed by 1e-3 relative seeded noise (x the stage's a-term), and the
    same planes all zero (which must give the bits of no topography)."""
    geom, ops, metric, topology, q0, topo = sw_topo_setup(nel, s)
    rng = np.random.default_rng(seed)
    x = q0 * (1.0 + 1e-3 * rng.standard_normal(q0.shape))
    y = q0 * (1.0 + 1e-3 * rng.standard_normal(q0.shape))
    con = swop.build_constants(ops, metric, nel, dtype=dtype, device=device)
    planes = swop.build_topography(topo, metric, dtype=dtype, device=device)
    zero = swop.SWTopography(**{k: torch.zeros_like(getattr(planes, k)) for k in ("hsurf", "hsurf_x", "hsurf_y",
                                                                                 "force")})
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return con, topology, planes, t(x), t(y), zero


def compare_sw_topo_operator(nel: int, s: int, dtype, device="cuda", seed: int = 0):
    """The state mode with case-5 topography (RHS, stage, stage with x)
    against its plain version, each variable scaled by its max of the plain
    output, within ``TOLERANCE`` (float32 RHS: the flux-divergence scale, as
    ``compare_sw_operator``), with mass (the h change's weighted integral,
    ``mass_err``). On the card also, bit for bit (``torch.equal``): the
    topography entry with null planes against the entry without
    topography, and with all-zero planes against null planes
    (``null_equals_plain``, ``zero_equals_null``)."""
    con, topology, topo, x, y, zero = sw_topo_inputs(nel, s, dtype, device, seed)
    wsg = sw_mass_weights(make_dfr_operators(s), con)
    modes = {"rhs": dict(), "stage": dict(a=0.0, b=1.0, cdt=DT), "stage_x": dict(x=x, a=0.75, b=0.25, cdt=0.25 * DT)}
    tol = TOLERANCE[dtype]
    rows = []
    for mode, kw in modes.items():
        got = swop.sw_operator(y, None, con, topology=topology, topo=topo, **kw)
        want = swop.sw_operator_plain(y, None, con, topology=topology, topo=topo, **kw)
        row = {"nel": nel, "s": s, "dtype": str(dtype).replace("torch.", ""), "mode": f"topo_{mode}",
               "max_abs_err": float((got - want).abs().max()), "tol": tol,
               "err_of_output_max": _scaled(got - want, per_variable_max(want))}
        if mode == "rhs" and dtype == torch.float32:
            row["scale"], row["err"] = "flux_divergence_max", _scaled(got - want, flux_divergence_scale(y, con))
        else:
            row["scale"], row["err"] = "output_max", row["err_of_output_max"]
        row["mass_err"], row["mass_tol"] = mass_err(got, want, wsg, dtype, kw.get("x"), y, kw.get("a", 0.0),
                                                    kw.get("b", 1.0), "cdt" in kw, tol=tol)
        ok = (np.isfinite(row["err"]) and row["err"] <= tol and bool(torch.isfinite(got).all().item())
              and row["mass_err"] <= row["mass_tol"])
        if device != "cpu":
            tables = swop.halo_tables(topology, y.device, y.dtype)
            plain_kernel = swop.sw_operator(y, None, con, topology=topology, **kw)
            null = swop._launch_operator_topo(y, con, kw.get("x"), kw.get("a", 0.0), kw.get("b", 1.0),
                                              kw.get("cdt"), tables, None)
            zeros = swop._launch_operator_topo(y, con, kw.get("x"), kw.get("a", 0.0), kw.get("b", 1.0),
                                               kw.get("cdt"), tables, zero)
            row["null_equals_plain"] = bool(torch.equal(null, plain_kernel))
            row["zero_equals_null"] = bool(torch.equal(zeros, null))
            ok = ok and row["null_equals_plain"] and row["zero_equals_null"]
        row["ok"] = bool(ok)
        rows.append(row)
    return rows


def sw_pert_topo_inputs(nel: int, s: int, dtype, device, seed: int = 0):
    """(con, topology, base, topo, dq, x): the perturbation base around
    Williamson case 5's state with its topography (built in float64 on
    ``device``, cast to ``dtype``), the topography planes in ``dtype``,
    dq = ``sw_delta(q0)`` and a second perturbation x (seeded noise of 1e-3
    relative), both in ``dtype``."""
    geom, ops, metric, topology, q0, topo = sw_topo_setup(nel, s)
    con = swop.build_constants(ops, metric, nel, dtype=dtype, device=device)
    con64 = swop.build_constants(ops, metric, nel, dtype=torch.float64, device=device)
    topo64 = swop.build_topography(topo, metric, dtype=torch.float64, device=device)
    base = swop.build_base_planes(torch.as_tensor(q0), con64, topology, dtype, topo=topo64)
    planes = topo64 if dtype == torch.float64 else swop.build_topography(topo, metric, dtype=dtype, device=device)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return con, topology, base, planes, t(sw_delta(q0)), t(1e-3 * q0 * rng.standard_normal(q0.shape))


def compare_sw_pert_topo(nel: int, s: int, dtype, device="cuda", seed: int = 0):
    """The perturbation form's state mode with case-5 topography (RHS rhs0 +
    delta, stage, stage with x) against its plain version; one row per mode.

    float64: within ``SW_PERT_TOLERANCE`` of each variable's scale.
    float32: against the float64 plain output on the same (float64)
    inputs, within twice the float32 plain output's distance from it, or
    ``SW_PERT_TOLERANCE`` where that is larger (``compare_sw_pert``). The
    scale is each variable's max of that output in the stage modes and, in
    RHS mode, its term scale (the flux divergence of q0 + dq,
    ``flux_divergence_scale``): case 5's flow over the mountain is
    balanced, so its RHS is a residual of terms far larger than itself.
    Each row also holds mass (``mass_err``). On the card it also reports,
    bit for bit (``zero_equals_flat``), the kernel with all-zero forcing
    planes on a base without topography against the perturbation kernel
    without topography (reported, not gated: the two kernels are compiled
    apart)."""
    con, topology, base, topo, dq, x = sw_pert_topo_inputs(nel, s, dtype, device, seed)
    con64, _, base64, topo64, dq64, x64 = sw_pert_topo_inputs(nel, s, torch.float64, device, seed)
    wsg = sw_mass_weights(sw_setup(nel, s)[1], con)
    modes = {"rhs": dict(), "stage": dict(a=0.0, b=1.0, cdt=DT), "stage_x": dict(x=x, a=0.75, b=0.25, cdt=0.25 * DT)}
    truth = None
    if dtype == torch.float32:
        truth = {m: swop.sw_operator_pert_plain(dq64, None, con64, base64, topology=topology, topo=topo64,
                                                **(dict(kw, x=x64) if "x" in kw else kw))
                 for m, kw in modes.items()}
    term = flux_divergence_scale(base64.q0 + dq64, con64)
    tol = SW_PERT_TOLERANCE[dtype]
    rows = []
    for mode, kw in modes.items():
        got = swop.sw_operator(dq, None, con, base=base, topology=topology, topo=topo, **kw)
        want = swop.sw_operator_pert_plain(dq, None, con, base, topology=topology, topo=topo, **kw)
        if device != "cpu":
            torch.cuda.synchronize()
        ref = want if truth is None else truth[mode]
        scale = term if mode == "rhs" else per_variable_max(ref)
        row = {"nel": nel, "s": s, "dtype": str(dtype).replace("torch.", ""), "mode": f"pert_topo_{mode}",
               "max_abs_err": float((got - want).abs().max()),
               "scale": "flux_divergence_max" if mode == "rhs" else "output_max",
               "err": _scaled(got.to(ref.dtype) - ref, scale), "tol": tol}
        limit = tol
        if truth is not None:
            row["scale"] = "f64_plain_" + row["scale"]
            row["plain_err"] = _scaled(want.double() - ref, scale)
            limit = max(tol, 2.0 * row["plain_err"])
        row["mass_err"], row["mass_tol"] = mass_err(got, want, wsg, dtype, kw.get("x"), dq, kw.get("a", 0.0),
                                                    kw.get("b", 1.0), "cdt" in kw, tol=tol)
        row["ok"] = bool(np.isfinite(row["err"]) and row["err"] <= limit and torch.isfinite(got).all().item()
                         and row["mass_err"] <= row["mass_tol"])
        if device != "cpu":
            flat_con, _, flat_base, flat_dq, _ = sw_pert_inputs(nel, s, dtype, device, seed)
            tables = swop.halo_tables(topology, dq.device, dq.dtype)
            flat_kw = {k: v for k, v in kw.items() if k != "x"}
            zero = swop._launch_operator("sw_operator_state_pert_topo_launch", flat_dq, None, flat_con, x,
                                         kw.get("a", 0.0), kw.get("b", 1.0), kw.get("cdt"), False, flat_base,
                                         tables, force=torch.zeros_like(topo.force))
            flat = swop.sw_operator(flat_dq, None, flat_con, x=x, base=flat_base, topology=topology, **flat_kw)
            row["zero_equals_flat"] = bool(torch.equal(zero, flat))
        rows.append(row)
    return rows


def sw_tangent_inputs(nel: int, s: int, dtype, device, seed: int = 7):
    """(con, topology, states, v, w): the constants; the linearisation points
    {"case6": Williamson case 6 plus seeded noise of 1e-3 of each variable's
    max (added, not multiplied: case 6's hu2 is 1e-16 on its symmetry lines,
    and relative noise would leave their interfaces' split Mach number
    within rounding of the kink at 0), "rest": case 6's h with zero
    momentum, where every interface's split Mach number is exactly 0 (the
    tie)}; two directions v, w of 1e-3 of each variable's max of case 6
    times N(0,1) (numpy's seeded generator)."""
    geom, ops, metric, topology, q0 = sw_setup(nel, s)
    rng = np.random.default_rng(seed)
    scale = 1e-3 * np.abs(q0).reshape(3, -1).max(axis=1).reshape(3, 1, 1, 1, 1)
    q = q0 + scale * rng.standard_normal(q0.shape)
    rest = np.concatenate([q0[:1], np.zeros_like(q0[1:])])
    v = scale * rng.standard_normal(q0.shape)
    w = scale * rng.standard_normal(q0.shape)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    con = swop.build_constants(ops, metric, nel, dtype=dtype, device=device)
    return con, topology, {"case6": t(q), "rest": t(rest)}, t(v), t(w)


def sw_tangent_fd_order(q, v, con, topology, jv, topo=None) -> dict:
    """The centred difference (RHS(q + eps v) - RHS(q - eps v)) / (2 eps) of
    the operator (``sw_operator``, the kernel on a card) against the tangent
    ``jv`` at the steps ``SW_FD_STEPS``: the 99th percentile of the
    pointwise distance scaled by each variable's max of ``jv`` at each step
    and the order log2 of their ratio (2 for a correct tangent). The
    operator has a kink wherever an interface's split Mach number crosses 0
    (max(0, M)), and a few interfaces of a large grid cross it within +-eps
    v, where the difference has no derivative to approach; they set the max
    (reported beside), not the percentile. At s = 1 the plain operator
    (the operator kernel starts at s = 2)."""
    p99, worst = [], []
    op = swop.sw_operator if con.s >= 2 else swop.sw_operator_plain
    for eps in SW_FD_STEPS:
        fd = (op((q + eps * v).contiguous(), None, con, topology=topology, topo=topo)
              - op((q - eps * v).contiguous(), None, con, topology=topology, topo=topo)) / (2.0 * eps)
        e = ((fd - jv).abs().double() / per_variable_max(jv).double().reshape(3, 1, 1, 1, 1)).reshape(-1)
        p99.append(float(torch.quantile(e, SW_FD_QUANTILE)))
        worst.append(float(e.max()))
    order = float(np.log(p99[0] / p99[1]) / np.log(SW_FD_STEPS[0] / SW_FD_STEPS[1])) if p99[1] > 0 else 0.0
    return {"fd_steps": list(SW_FD_STEPS), "fd_err_p99": p99, "fd_err_max": worst, "fd_order": order}


def _sw_prep_rows(coef, con) -> dict:
    """{row name: values} of an SW coefficient buffer (``sw_tangent_layout``;
    face rows per family)."""
    node, face_x, face_y = swop._tangent_parts(coef, con)
    rows = {name: node[r] for r, name in enumerate(swop.SW_TANGENT_NODE_ROWS)}
    for fam, face in (("x", face_x), ("y", face_y)):
        rows.update({f"{fam}.{name}": face[r] for r, name in enumerate(swop.SW_TANGENT_FACE_ROWS)})
    return rows


def sw_tie_mask(coef64, con, thresh: float = 1e-6) -> torch.Tensor:
    """(6, nel, nel) bool: the elements of a panel beside an interface point
    whose split Mach number M (the float64 prep's buffer ``coef64``) is
    within ``thresh`` of its kink at 0 but not on it, where float32 rounding
    can land M on either side or on the tie and the flux's derivative jumps
    by dM (half of it at the tie): two correct float32 J.v differ there by
    up to dM. An M of exactly 0 (no wind) is the tie in any precision."""
    _, face_x, face_y = swop._tangent_parts(coef64, con)
    nel = con.nel
    near = lambda m: ((m != 0) & (m.abs() < thresh)).any(dim=-1)  # an exact 0 (no wind) is a tie in any precision
    near_x = near(face_x[12])  # (6, nel, nel+1): interface m of row ey
    near_y = near(face_y[12])  # (6, nel+1, nel): interface m of column ex
    mask = near_x[:, :, 1:] | near_x[:, :, :-1] | near_y[:, 1:, :] | near_y[:, :-1, :]
    return mask.reshape(6, nel, nel)


def compare_sw_tangent_kernels(q, v, coef, con, topology, ref64=None, topo=None) -> dict:
    """Each SW tangent kernel against its plain version on the same inputs:
    the prep's buffer ``coef`` against ``sw_tangent_prep_plain``'s, row by
    row scaled by the row's max (``prep_err``), and the apply on ``coef``
    against ``sw_tangent_apply_plain`` on the same buffer, scaled by each
    variable's max (``apply_err``). With ``ref64``, the float64 plain prep's
    buffer at the float64 inputs (float32 checks): each row of the kernel's
    and of the plain float32 buffer against it, scaled by its row's max
    (``prep_rows`` {row: [kernel, plain]}), and ``prep_rows_over`` the rows
    where the kernel is further than the float32 tangent tolerance or twice
    the plain buffer."""
    want = swop.sw_tangent_prep_plain(q, con, topology, topo)
    got_jv = swop.sw_tangent_apply(coef, v, con, topology, topo)
    want_jv = swop.sw_tangent_apply_plain(coef, v, con, topology, topo)
    got_rows, want_rows = _sw_prep_rows(coef, con), _sw_prep_rows(want, con)
    row_err = lambda g, w: float((g.double() - w).abs().max() / w.abs().max().clamp_min(1e-300))
    out = {
        "prep_err": max(row_err(got_rows[k], want_rows[k].double()) for k in got_rows),
        "prep_max_abs_err": max(float((got_rows[k] - want_rows[k]).abs().max()) for k in got_rows),
        "apply_err": _scaled(got_jv - want_jv, per_variable_max(want_jv).clamp_min(1e-300)),
        "apply_max_abs_err": float((got_jv - want_jv).abs().max()),
    }
    if ref64 is not None:
        ref_rows = _sw_prep_rows(ref64, con)
        err = lambda g, k: float((g.double() - ref_rows[k]).abs().max() / ref_rows[k].abs().max().clamp_min(1e-300))
        limit = SW_TANGENT_TOLERANCE[torch.float32]
        out["prep_rows"] = {k: [err(got_rows[k], k), err(want_rows[k], k)] for k in got_rows}
        out["prep_row_limit"] = f"max({limit:g}, 2 * plain)"
        out["prep_rows_over"] = [k for k, (kern, plain) in out["prep_rows"].items()
                                 if not kern <= max(limit, 2.0 * plain)]
    return out


def sw_topo_tangent_inputs(nel: int, s: int, dtype, device, seed: int = 7):
    """(con, topology, states, v, w, topo): ``sw_tangent_inputs`` on
    Williamson case 5 with its topography planes: the points {"case5":
    case 5 plus seeded noise of 1e-3 of each variable's max, "rest5": case
    5's h at rest, every split Mach number 0}."""
    geom, ops, metric, topology, q0, topo = sw_topo_setup(nel, s)
    rng = np.random.default_rng(seed)
    scale = 1e-3 * np.abs(q0).reshape(3, -1).max(axis=1).reshape(3, 1, 1, 1, 1)
    q = q0 + scale * rng.standard_normal(q0.shape)
    rest = np.concatenate([q0[:1], np.zeros_like(q0[1:])])
    v = scale * rng.standard_normal(q0.shape)
    w = scale * rng.standard_normal(q0.shape)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    con = swop.build_constants(ops, metric, nel, dtype=dtype, device=device)
    return (con, topology, {"case5": t(q), "rest5": t(rest)}, t(v), t(w),
            swop.build_topography(topo, metric, dtype=dtype, device=device))


def compare_sw_tangent(nel: int, s: int, dtype, device="cuda", seed: int = 7, case: int = 6):
    """The tangent kernels (``sw_tangent_prep``, then ``sw_tangent_apply``)
    against the plain tangent (``sw_tangent_plain``, torch.func.jvp of the
    plain operator) at the case-6 and rest linearisation points of
    ``sw_tangent_inputs``, and each kernel against its plain version
    (``compare_sw_tangent_kernels``); one row each point.

    float64: J.v within 1e-12 of each variable's max of the plain J.v (the
    JAX tests' bound of the 3D tangent kernel against jax.jvp, tightened as
    the 3D port's checks are); the prep's rows and the apply within the
    same of their plain versions. float32: J.v against the float64 plain
    J.v on the same inputs, within twice the float32 plain J.v's distance
    from it, or 1e-5 of scale where that is larger; the prep's rows against
    the float64 plain prep's by the same rule, the apply within 1e-5 of its
    plain version on the same buffer. Also, within the J.v's limit: the
    apply's linearity in v (``J(a v + b w)`` against ``a Jv + b Jw`` on one
    buffer); and mass, the weighted integral of (J.v)_h against the plain
    version's (``mass_err``). float64 rows also hold the kernels against a
    centred difference of the operator kernel (``sw_tangent_fd_order``:
    order above 1.5 and a distance below 1e-8 at the smaller step), at the
    case-6 point (at rest every interface sits on the kink); at s = 1 (the
    fv-mg levels) the operator has no kernel and the plain operator's
    difference stands in.

    ``case=5``: the same on Williamson case 5 with its topography
    (``sw_topo_tangent_inputs``: the kernels with topography), the
    centred difference at the "case5" point. Its float32 rows leave out of
    the gated error the elements beside an interface whose float64 split
    Mach number lies within 1e-6 of its kink (``sw_tie_mask``): case 5's
    winds cross zero near the poles, and at (64,7) one such interface puts
    the float32 plain J.v 2.8e-4 of h's max from the float64 one and the
    kernel, rounding M to the other side, exactly twice that; the error
    over every element is reported beside (``err_all``)."""
    def inputs(dt):
        if case == 5:
            return sw_topo_tangent_inputs(nel, s, dt, device, seed)
        return (*sw_tangent_inputs(nel, s, dt, device, seed), None)

    con, topology, states, v, w, topo = inputs(dtype)
    wsg = sw_mass_weights(sw_setup(nel, s)[1], con)
    tol = SW_TANGENT_TOLERANCE[dtype]
    truth = ref64 = None
    if dtype == torch.float32:
        con64, _, states64, v64, _, topo64 = inputs(torch.float64)
        truth = {k: swop.sw_tangent_plain(q, v64, con64, topology, topo64) for k, q in states64.items()}
        ref64 = {k: swop.sw_tangent_prep_plain(q, con64, topology, topo64) for k, q in states64.items()}
    rows = []
    a, b = TANGENT_LINEARITY
    for point, q in states.items():
        coef = swop.sw_tangent_prep(q, con, topology, topo)
        got = swop.sw_tangent_apply(coef, v, con, topology, topo)
        want = swop.sw_tangent_plain(q, v, con, topology, topo)
        combo = swop.sw_tangent_apply(coef, (a * v + b * w).contiguous(), con, topology, topo)
        lin = a * got + b * swop.sw_tangent_apply(coef, w, con, topology, topo)
        split = compare_sw_tangent_kernels(q, v, coef, con, topology, None if ref64 is None else ref64[point], topo)
        if device != "cpu":
            torch.cuda.synchronize()
        ref = want if truth is None else truth[point]
        scale = per_variable_max(ref)
        keep = None
        if truth is not None and topo is not None:
            tie = sw_tie_mask(ref64[point], con).to(ref.device)
            keep = (~tie).reshape(1, 6, nel, nel, 1).to(ref.dtype)
        row = {"nel": nel, "s": s, "dtype": str(dtype).replace("torch.", ""), "mode": f"tangent_{point}",
               "max_abs_err": float((got - want).abs().max()), "scale": "output_max",
               "err": _scaled((got.to(ref.dtype) - ref) * (1.0 if keep is None else keep), scale), "tol": tol,
               "linearity_err": _scaled(combo - lin, per_variable_max(lin)), **split}
        limit = tol
        if truth is not None:
            row["scale"] = "f64_plain_output_max"
            row["plain_err"] = _scaled((want.double() - ref) * (1.0 if keep is None else keep), scale)
            if keep is not None:
                row["tie_elements"] = int((keep == 0).sum())
                row["err_all"] = _scaled(got.to(ref.dtype) - ref, scale)
                row["plain_err_all"] = _scaled(want.double() - ref, scale)
            row["plain_to_kernel_err"] = _scaled(got - want, per_variable_max(want))
            limit = max(tol, 2.0 * row["plain_err"])
        row["limit"] = limit
        row["mass_err"], row["mass_tol"] = mass_err(got, want, wsg, dtype, tol=tol)
        mass = lambda t: float((wsg * t[0].double()).sum() / (wsg * t[0].double()).abs().sum())
        row["mass_of_output"], row["mass_of_plain"] = mass(got), mass(want)
        prep_ok = row["prep_err"] <= tol if truth is None else not row["prep_rows_over"]
        ok = (np.isfinite(row["err"]) and row["err"] <= limit and row["linearity_err"] <= limit
              and bool(torch.isfinite(got).all().item()) and row["mass_err"] <= row["mass_tol"]
              and prep_ok and row["apply_err"] <= tol)
        if dtype == torch.float64 and point in ("case6", "case5"):
            row.update(sw_tangent_fd_order(q, v, con, topology, got, topo))
            ok = ok and row["fd_order"] > 1.5 and row["fd_err_p99"][1] < 1e-8
        row["ok"] = bool(ok)
        rows.append(row)
    return rows


def sw_tangent_work(nel: int, s: int, dtype, topo: bool = False):
    """(bytes, operations) of the Jacobian action J(q).v as one call (the
    function's bound; the prep's and the apply's own are
    ``sw_tangent_prep_work`` and ``sw_tangent_apply_work``): q and v read
    once each (the neighbour elements' and neighbour panels' nodes are
    elements of q and v, counted with them), J.v written once, the
    one-panel metric, gridrot, the interface metric and the 4 rotation
    coefficients of each panel-edge point read once; the operations the
    function needs (an add, multiply, divide or sqrt one, a fused
    multiply-add two), with each face of q and of v extrapolated once and
    each interface's flux tangent computed once: ~70 a node for the
    pointwise fluxes' and forcing's tangents, and about 100 an interface
    point for the AUSM flux and its tangent; derivative, extrapolation and
    correction by the 1D factors as ``sw_work`` counts them, and the
    rotation of q's and v's halo values (12 an edge point). ``topo``: also
    hsurf at the nodes and interfaces and the two forcing coefficients read
    (3 words a node, 1 an interface point), h + hsurf at each face node and
    the interface's hsurf taken from both sides (2 s + 2 an interface
    point), two forcing products of dh a node (4)."""
    n_elem, s2, item = 6 * nel * nel, s * s, torch.finfo(dtype).bits // 8
    nstate = 3 * n_elem * s2
    edge_points = 4 * 6 * nel * s
    words = 3 * nstate + 13 * nel * nel * s2 + n_elem * s2 + 2 * 3 * nel * (nel + 1) * s + 4 * edge_points
    ops = n_elem * (s2 * (70 + 12 * s + 24) + 2 * s * (24 * s + 100)) + 12 * edge_points
    if topo:
        n_itf = 2 * 6 * nel * (nel + 1) * s
        words += 3 * n_elem * s2 + n_itf
        ops += 4 * n_elem * s2 + n_itf * (2 * s + 2)
    return words * item, ops


def _sw_tangent_buffer_words(nel: int, s: int) -> int:
    """Words of the SW coefficient buffer (``sw_tangent_layout``)."""
    return 3 * 6 * nel * nel * s * s + 2 * len(swop.SW_TANGENT_FACE_ROWS) * 6 * nel * (nel + 1) * s


def sw_tangent_prep_work(nel: int, s: int, dtype, topo: bool = False):
    """(bytes, operations) of one prep: q read once, the coefficient buffer
    written once, the interface metric's H row (the sound speeds' factor)
    and the 4 rotation coefficients of each panel-edge point read once.
    Operations: 2 divisions a node; an interface point's two traces (2 x 3
    variables x s fused multiply-adds), the rotation of its halo value at
    a panel edge (6), and the primal AUSM coefficients (~25: two square
    roots, four divisions, the split Mach number). ``topo``: hsurf at the
    nodes and the interfaces read too (1 word a node and an interface
    point), h + hsurf at each face node of both sides and the interface's
    hsurf taken from both (2 s + 2 an interface point)."""
    n_elem, s2, item = 6 * nel * nel, s * s, torch.finfo(dtype).bits // 8
    n_itf = 2 * 6 * nel * (nel + 1) * s
    edge_points = 4 * 6 * nel * s
    words = 3 * n_elem * s2 + _sw_tangent_buffer_words(nel, s) + 2 * nel * (nel + 1) * s + 4 * edge_points
    ops = n_elem * s2 * 2 + n_itf * (12 * s + 25) + 6 * edge_points
    if topo:
        words += n_elem * s2 + n_itf
        ops += n_itf * (2 * s + 2)
    return words * item, ops


def sw_tangent_apply_work(nel: int, s: int, dtype, topo: bool = False):
    """(bytes, operations) of one apply, counted as ``sw_tangent_work``
    counts them: v read once, J.v written once, the coefficient buffer, the
    one-panel metric, gridrot, the interface metric and the rotation
    coefficients read once. The apply's own floor, beside the function's:
    the buffer (3 words a node, 13 an interface point) is its price for
    doing no square root or division and reading no q. Operations of its
    linear algebra: ~50 a node for the pointwise tangents, the derivative
    and correction as ``sw_work`` counts them, and at each of an element's
    4s face points (an interior interface from each side) the two direction
    traces (2 x 3 variables x s fused multiply-adds) and ~60 for the flux
    tangent; the rotation of v's halo values (6 an edge point). ``topo``:
    the two forcing coefficients read (2 words a node) and their products
    with dh added (4 a node)."""
    n_elem, s2, item = 6 * nel * nel, s * s, torch.finfo(dtype).bits // 8
    nstate = 3 * n_elem * s2
    edge_points = 4 * 6 * nel * s
    words = 2 * nstate + _sw_tangent_buffer_words(nel, s) + 13 * nel * nel * s2 + n_elem * s2
    words += 2 * 3 * nel * (nel + 1) * s + 4 * edge_points
    ops = n_elem * (s2 * (50 + 12 * s + 24) + 4 * s * (12 * s + 60)) + 6 * edge_points
    if topo:
        words += 2 * n_elem * s2
        ops += 4 * n_elem * s2
    return words * item, ops


def sw_tangent_resources(dtype, s: int) -> dict:
    """{"prep", "apply", "prep_topo", "apply_topo": {registers, local_bytes,
    smem_bytes, blocks_per_sm, threads}} of the SW tangent kernels (and
    those with topography) at one dtype and s (the apply at its
    largest block; the prep's static shared memory is not counted), as the
    runtime reports them (on the card; builds the library)."""
    import ctypes

    from .build import load_library

    lib = load_library("sw_operator")
    out = {}
    for kernel, name in enumerate(("prep", "apply", "prep_topo", "apply_topo")):
        info = (ctypes.c_int * 5)()
        rc = lib.sw_tangent_resources(1 if dtype == torch.float64 else 0, s, kernel, ctypes.cast(info, ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"sw_tangent_resources failed: CUDA error {rc}")
        out[name] = dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm", "threads"), info))
    return out


# ---------------------------------------------------------------------------
# Tile kernels (the tile-parallel step's per-tile launches)

# (nt, s, N): tile width, solution points and the mesh whose tile is checked
# (N = 2: a tile with two panel edges and two edges inside the panel).
SW_TILE_SHAPES = ((4, 3, 2), (8, 4, 2), (32, 3, 2), (64, 4, 1))
# (nt, nk, s, case, N); case 77 is the rotating planet (time Christoffels);
# at nt = 7 the tile's 147 elements leave the operator's volume pass (9
# elements a block at s=3) a partial last block.
E3_TILE_SHAPES = ((2, 3, 2, 31, 2), (5, 8, 3, 31, 2), (10, 20, 3, 31, 2), (20, 20, 3, 31, 1), (2, 3, 3, 77, 2),
                  (7, 3, 3, 31, 2))
TILE_TOLERANCE = {torch.float64: 1e-12, torch.float32: 1e-5}


def cast_constants(obj, dtype):
    """A constants or base dataclass with its floating tensors cast."""
    import dataclasses

    cast = lambda v: v.to(dtype) if isinstance(v, torch.Tensor) and v.is_floating_point() else v
    return dataclasses.replace(obj, **{f.name: cast(getattr(obj, f.name)) for f in dataclasses.fields(obj)})


def checked_tile(n: int):
    """The tile whose kernel is checked on a (6, n, n) mesh: panel 1's
    north-west tile (at n = 2 its north and west sides are panel edges,
    its south and east sides lie inside the panel)."""
    return (1, n - 1, 0)


def _tile_halos(states, cons, perts, mesh, exchange, nt, edges):
    """Every tile's halo of a global state, through the tile edge traces
    and the tile exchange (the tile step's own glue)."""
    from ..parallel.mesh import tile_view

    tiles = mesh.tiles()
    traces = [edges(tile_view(states, *tiles[t], nt).contiguous(), cons[t], perts[t]) for t in range(mesh.ntiles)]
    return exchange(traces)


def sw_tile_inputs(nt: int, s: int, n: int, device, seed: int = 0):
    """float64 inputs of the checked tile of a case-6 sphere of nel = n*nt:
    (con, base, inputs, term): the tile's constants and perturbation base,
    and {y, x, halo_y, dq, dx, halo_dq} (absolute states with 1e-3 relative
    noise; the perturbation ``sw_delta`` and seeded noise), the halos from
    the tile exchange; and the flux-divergence scale of y."""
    from ..parallel.exchange import TileExchange
    from ..parallel.mesh import TileMesh, tile_index, tile_view
    from ..parallel.shard_map_sw import build_tile_tables

    geom, ops, metric, topology, q0 = sw_setup(n * nt, s)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    y, x = (t(q0 * (1.0 + 1e-3 * rng.standard_normal(q0.shape))) for _ in range(2))
    dq, dx = t(sw_delta(q0)), t(1e-3 * q0 * rng.standard_normal(q0.shape))
    con = swop.build_constants(ops, metric, n * nt, device=device)
    mesh = TileMesh(n)
    tiles = mesh.tiles()
    cons = [swop.tile_constants(con, ty * nt, tx * nt, nt, p) for p, ty, tx in tiles]
    exchange = TileExchange(build_tile_tables(topology, n, s), mesh, (3, 4, 1, nt, s), (1, nt, 1, s), device=device)
    edges = lambda q, c, _: swop.tile_edge_traces(q, c)
    k = tile_index(*checked_tile(n), n)
    p, ty, tx = tiles[k]
    base64 = swop.build_base_planes(t(q0), con, topology, torch.float64)
    view = lambda a: tile_view(a, p, ty, tx, nt).contiguous()
    inputs = {"y": view(y), "x": view(x), "dq": view(dq), "dx": view(dx),
              "halo_y": _tile_halos(y, cons, [None] * len(tiles), mesh, exchange, nt, edges)[k].clone(),
              "halo_dq": _tile_halos(dq, cons, [None] * len(tiles), mesh, exchange, nt, edges)[k].clone()}
    base = swop.tile_base(base64, ty * nt, tx * nt, nt, p, torch.float64)
    return cons[k], base, inputs, flux_divergence_scale(inputs["y"], cons[k])


def _tile_modes(inputs, dt, pert: bool):
    """(name, state, halo, kwargs) of the checked modes: RHS, a stage with
    a = 0 and one with a != 0, both with emitted traces."""
    y, h, x = (inputs["dq"], inputs["halo_dq"], inputs["dx"]) if pert else (inputs["y"], inputs["halo_y"], inputs["x"])
    pre = "pert_" if pert else ""
    return [(pre + "rhs", y, h, dict()),
            (pre + "stage_traces", y, h, dict(a=0.0, b=1.0, cdt=dt, emit_traces=True)),
            (pre + "stage_x_traces", y, h, dict(x=x, a=0.75, b=0.25, cdt=0.25 * dt, emit_traces=True))]


def _compare_tile(kernel, plain, con64, base64, inputs64, term, dtype, row0, dt, base_kw, wsg=None):
    """Kernel against plain on one tile in every mode of ``_tile_modes``.
    float64: within 1e-12 of the scale (per variable, the larger of the
    output max and |cdt| (1 in RHS mode) times the RHS term scale ``term``).
    float32: the kernel on the float32 rounding of the inputs against the
    float64 plain output, within 1e-5 of that scale or twice the float32
    plain output's distance from it; the traces likewise, scaled by their
    max. With mass weights ``wsg`` also the mass change against the plain
    version's (``mass_err``)."""
    con, base = cast_constants(con64, dtype), cast_constants(base64, dtype)
    inputs = {k: v.to(dtype) for k, v in inputs64.items()}
    tol = TILE_TOLERANCE[dtype]
    rows = []
    for pert in (False, True):
        extra = {base_kw: base} if pert else {}
        extra64 = {base_kw: base64} if pert else {}
        for (mode, y, h, kw), (_, y64, h64, kw64) in zip(_tile_modes(inputs, dt, pert),
                                                         _tile_modes(inputs64, dt, pert)):
            got = kernel(y, h, con, **kw, **extra)
            want = plain(y, h, con, **kw, **extra)
            ref = want if dtype == torch.float64 else plain(y64, h64, con64, **kw64, **extra64)
            if y.device.type != "cpu":
                torch.cuda.synchronize()
            got_tr = want_tr = ref_tr = None
            if kw.get("emit_traces"):
                (got, got_tr), (want, want_tr), (ref, ref_tr) = got, want, ref
            scale = torch.maximum(per_variable_max(ref), abs(kw.get("cdt", 1.0)) * term.to(ref.dtype))
            row = dict(row0, dtype=str(dtype).replace("torch.", ""), mode=mode,
                       max_abs_err=float((got - want).abs().max()), scale="max(output_max, cdt*term)",
                       err=_scaled(got.to(ref.dtype) - ref, scale), tol=tol)
            limit = limit_tr = tol
            if got_tr is not None:
                row["traces_err"] = _scaled(got_tr.to(ref.dtype) - ref_tr, per_variable_max(ref_tr))
            if dtype != torch.float64:
                row["scale"] = "f64_plain_" + row["scale"]
                row["plain_err"] = _scaled(want.double() - ref, scale)
                limit = max(tol, 2.0 * row["plain_err"])
                if got_tr is not None:
                    row["plain_traces_err"] = _scaled(want_tr.double() - ref_tr, per_variable_max(ref_tr))
                    limit_tr = max(tol, 2.0 * row["plain_traces_err"])
            ok = np.isfinite(row["err"]) and row["err"] <= limit and bool(torch.isfinite(got).all().item())
            if got_tr is not None:
                ok = ok and row["traces_err"] <= limit_tr and bool(torch.isfinite(got_tr).all().item())
            if wsg is not None:
                row["mass_err"], row["mass_tol"] = mass_err(got, want, wsg, dtype, kw.get("x"), y, kw.get("a", 0.0),
                                                            kw.get("b", 1.0), "cdt" in kw, tol=tol)
                ok = ok and row["mass_err"] <= row["mass_tol"]
            row["ok"] = bool(ok)
            rows.append(row)
    return rows


def compare_sw_tile(nt: int, s: int, n: int, dtype, device="cuda", seed: int = 0):
    """The SW tile kernel (``sw_tile_operator``) against its plain version
    on the checked tile of a case-6 sphere of nel = n*nt, absolute and
    perturbation form, RHS and stages with a = 0 and a != 0 (tolerances
    and the mass check of the h change: ``_compare_tile``); one row per
    mode."""
    con64, base64, inputs64, term = sw_tile_inputs(nt, s, n, device, seed)
    return _compare_tile(swop.sw_tile_operator, swop.sw_tile_operator_plain, con64, base64, inputs64, term, dtype,
                         {"nt": nt, "s": s, "n": n}, DT, "base", sw_mass_weights(sw_setup(n * nt, s)[1], con64))


def euler3d_tile_inputs(nt: int, nk: int, s: int, case: int, n: int, device, seed: int = 0):
    """float64 inputs of the checked tile of a DCMIP sphere of nel_h = n*nt:
    (con, pert, inputs, term): the tile's constants and perturbation base,
    {y, x, halo_y, dq, dx, halo_dq} (``euler3d_inputs``' noisy states and
    ``euler3d_pert_inputs``' perturbation, a second perturbation of 1e-4
    q0 N(0,1)), the halos from the tile exchange; and the RHS term scale
    of y."""
    from ..parallel.exchange import TileExchange
    from ..parallel.mesh import TileMesh, tile_index, tile_view
    from ..parallel.shard_map_sw import build_tile_tables

    nel_h = n * nt
    con, topology, x, y = euler3d_inputs(nel_h, nk, s, torch.float64, device, case, seed)
    _, _, pert64, dq, _ = euler3d_pert_inputs(nel_h, nk, s, torch.float64, device, case, seed)
    q0 = euler3d_setup(nel_h, nk, s, case)[4]
    dx = torch.as_tensor(1e-4 * q0 * np.random.default_rng(seed + 1).standard_normal(q0.shape), device=device)
    mesh = TileMesh(n)
    tiles = mesh.tiles()
    cons = [e3op.tile_constants(con, ty * nt, tx * nt, nt, p) for p, ty, tx in tiles]
    perts = [e3op.tile_pert_base(pert64, ty * nt, tx * nt, nt, p, torch.float64) for p, ty, tx in tiles]
    exchange = TileExchange(build_tile_tables(topology, n, s), mesh, (5, 4, 1, nk, nt, s * s), (nk, nt, s, s),
                            device=device)
    k = tile_index(*checked_tile(n), n)
    p, ty, tx = tiles[k]
    view = lambda a: tile_view(a, p, ty, tx, nt).contiguous()
    inputs = {"y": view(y), "x": view(x), "dq": view(dq), "dx": view(dx),
              "halo_y": _tile_halos(y, cons, [None] * len(tiles), mesh, exchange, nt, e3op.tile_edge_traces)[k],
              "halo_dq": _tile_halos(dq, cons, perts, mesh, exchange, nt, e3op.tile_edge_traces)[k]}
    inputs = {key: v.clone() for key, v in inputs.items()}
    return cons[k], perts[k], inputs, euler3d_term_scale(inputs["y"], cons[k])


def compare_euler3d_tile(nt: int, nk: int, s: int, case: int, n: int, dtype, device="cuda", seed: int = 0):
    """The 3D tile kernel (``euler3d_tile_operator``) against its plain
    version on the checked tile of a DCMIP sphere of nel_h = n*nt,
    absolute and perturbation form, RHS and stages with a = 0 and a != 0
    (tolerances and the mass check: ``_compare_tile``); one row per mode."""
    con64, pert64, inputs64, term = euler3d_tile_inputs(nt, nk, s, case, n, device, seed)
    wsg = mass_weights(euler3d_setup(n * nt, nk, s, case)[1], con64)
    return _compare_tile(e3op.euler3d_tile_operator, e3op.euler3d_tile_operator_plain, con64, pert64, inputs64,
                         term, dtype, {"nt": nt, "nk": nk, "s": s, "case": case, "n": n}, E3_DT, "pert", wsg)


def sw_tile_work(nt: int, s: int, dtype, **kw):
    """``sw_work`` of one tile launch: the tile's own metric slice read
    whole (no L2 sharing across the six panels' launches)."""
    return sw_work(nt, s, dtype, npanel=1, **kw)


def euler3d_tile_work(con, pert: bool = False, **kw):
    """``euler3d_work`` (``euler3d_pert_work`` with ``pert``) of one tile
    launch with tile constants."""
    return euler3d_pert_work(con, **kw) if pert else euler3d_work(con, **kw)


# ---------------------------------------------------------------------------
# RHSs whose CPU Jacobian action is the tangent kernels' plain pair


class PlainPairShallowWater(ShallowWaterRHS):
    """An absolute-form ``ShallowWaterRHS`` whose Jacobian action runs the
    split the card runs, with the kernels' plain versions on every device:
    ``jtv_prep`` the prep's (``ops.sw_operator.sw_tangent_prep_plain``, the
    coefficient buffer, once per linearisation point), ``jtv_apply`` the
    apply's (``sw_tangent_apply_plain``, once per action). On the CPU an
    action costs ~1/20 of the model's ``torch.func.jvp`` of the plain
    operator and agrees with it within 1e-12 of scale
    (tests/test_torch_sw_tangent_split.py), so the integrator parity tests
    can afford full solves."""

    def jtv_prep(self, q: torch.Tensor) -> torch.Tensor:
        if self.base is not None:
            raise ValueError("PlainPairShallowWater is the absolute form")
        return swop.sw_tangent_prep_plain(q.to(self.dtype).contiguous(), self.con, self.topology, self.topo)

    def jtv_apply(self, prep: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return swop.sw_tangent_apply_plain(prep, v.to(self.dtype).contiguous(), self.con, self.topology, self.topo)


class PlainPairEuler3D(Euler3DRHS):
    """An absolute-form ``Euler3DRHS`` whose Jacobian action runs the split
    the card runs with the kernels' plain versions: ``jtv_prep`` adds the
    prep's plain coefficient buffer (``ops.euler3d_operator.
    euler3d_tangent_prep_plain``) to the model's prep, ``jtv_apply`` the
    tangent glue and the apply's plain version (``euler3d_tangent_apply_plain``);
    ~1/18 of the model's CPU ``torch.func.jvp`` at 2x2x2, s = 2, within
    1e-12 of it (tests/test_torch_euler3d_tangent_split.py)."""

    def jtv_prep(self, q: torch.Tensor):
        if self.pert is not None:
            raise ValueError("PlainPairEuler3D is the absolute form")
        q_in, qa, traces, halo, _ = super().jtv_prep(q)
        return q_in, qa, traces, halo, e3op.euler3d_tangent_prep_plain(q_in, halo, self.con)

    def jtv_apply(self, prep, v: torch.Tensor) -> torch.Tensor:
        _, qa, traces, _, coef = prep
        halo_v = self.halo(e3op.edge_traces_tangent(qa, v, self.con, traces))
        return e3op.euler3d_tangent_apply_plain(v, halo_v, coef, self.con)


# ---------------------------------------------------------------------------
# Tracer advection under prescribed winds (DCMIP 11 and 12)
#
# ``compare_euler3d_advection``: the advection kernel against its plain
# version on DCMIP 11 (4 tracers) or 12 (1) with seeded noise (1e-3
# relative on every row, and 0.1 rho N(0,1) added to each tracer, so no
# tracer RHS is a near-cancelled residual and DCMIP 12's zero layers carry
# a tracer), in RHS mode and in stage mode with and without x and with the
# emitted traces. Rows 0-4 of the RHS must be exactly 0. Every row's error
# is scaled by the larger of its output max and |cdt| (1 in RHS mode) times
# the tracer's flux-divergence scale (``advection_term_scale``; rows 0-4:
# their output max). float64: within 1e-12; float32: against the plain
# float64 output on the same (float32-rounded) inputs, within 1e-5 or twice
# the plain float32 output's distance from it. Each tracer's mass: the
# kernel's change (the RHS, or out - a*x - b*y) against the plain
# version's, as ``mass_err`` holds rho (``advection_mass_err``), and the
# kernel RHS's own integral over its absolute integral (zero to
# round-off: both elements of an interface read one flux).

ADVECTION_DT = 300.0
ADVECTION_CASES = {4: 11, 1: 12}


def advection_inputs(nel_h: int, nel_v: int, s: int, ntracer: int, dtype, device, seed: int = 0):
    """(con, topology, ops, x, y): constants and two noisy DCMIP 11 (4
    tracers) or 12 (1 tracer) states (x is the stage's a-term)."""
    geom, ops, metric, topology, q = euler3d_setup(nel_h, nel_v, s, ADVECTION_CASES[ntracer])
    rng = np.random.default_rng(seed)

    def noisy():
        out = q * (1.0 + 1e-3 * rng.standard_normal(q.shape))
        out[5:] += 0.1 * q[0] * rng.standard_normal(q[5:].shape)
        return out

    x, y = noisy(), noisy()
    con = euler3d_constants(nel_h, nel_v, s, ADVECTION_CASES[ntracer], dtype, device)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return con, topology, ops, t(x), t(y)


def advection_term_scale(q: torch.Tensor, con) -> torch.Tensor:
    """Per-row scale of the advection RHS: for each tracer row the max of
    its interior flux divergence ``inv_sqrtG * div(sqrt(g) u q_k)``; 0 for
    rows 0-4 (their RHS is 0)."""
    sqrtg, invsg = con.fields[0], con.fields[1]
    flux = torch.cat([sqrtg * (q[1 + d] / q[0]) * q[5:] for d in range(3)], dim=-1)
    scale = torch.zeros(q.shape[0], dtype=torch.float64, device=q.device)
    scale[5:] = per_variable_max(invsg * (flux @ con.dd)).double()
    return scale


def advection_mass(out, row: int, wsg, x=None, y=None, a: float = 0.0, b: float = 1.0, stage: bool = False):
    """(integral, absolute integral) of row ``row``'s change (the RHS, or
    out - a*x - b*y in stage mode) weighted by ``wsg``, in float64."""
    c = out[row].double()
    if stage:
        c = c - b * y[row].double() - (a * x[row].double() if x is not None and a != 0.0 else 0.0)
    c = wsg * c
    return float(c.sum()), float(c.abs().sum())


def compare_euler3d_advection(nel_h: int, nel_v: int, s: int, ntracer: int, dtype, device="cuda", seed: int = 0):
    """The advection kernel (``ops.euler3d_advection``) against its plain
    version in every mode on ``advection_inputs`` (``compare_advection``)."""
    con, topology, ops, x, y = advection_inputs(nel_h, nel_v, s, ntracer, dtype, device, seed)
    con64 = con if dtype == torch.float64 else euler3d_constants(nel_h, nel_v, s, ADVECTION_CASES[ntracer],
                                                                 torch.float64, device)
    return compare_advection(con, con64, topology, ops, x, y)


def compare_advection(con, con64, topology, ops, x, y):
    """The advection kernel against its plain version on the states ``x``
    (the stage's a-term) and ``y`` of ``con``'s dtype and device (``con64``:
    the float64 constants of the float32 truth); one dict per mode with the
    scaled error ``err`` (worst row), its tolerance ``tol``, each row's
    error ``row_err``, each tracer's mass error against the plain version
    and own relative mass (RHS mode), and ``ok``."""
    nel_h, nel_v, s, ntracer, dtype, device = con.nel_h, con.nel_v, con.s, y.shape[0] - 5, con.dtype, con.device
    halo = e3op.halo_from_traces(e3op.edge_traces(y, con), topology)
    modes = {
        "rhs": dict(),
        "stage": dict(a=0.0, b=1.0, cdt=ADVECTION_DT),
        "stage_x": dict(x=x, a=0.75, b=0.25, cdt=0.25 * ADVECTION_DT),
        "stage_x_traces": dict(x=x, a=1.0 / 3.0, b=2.0 / 3.0, cdt=(2.0 / 3.0) * ADVECTION_DT, emit_traces=True),
    }
    f64 = dtype == torch.float64
    tol = E3_TOLERANCE[dtype]
    term = advection_term_scale(y.double(), con64)
    wsg = mass_weights(ops, con)
    if not f64:  # the float64 truth on the float32-rounded inputs
        y64, x64, halo64 = y.double(), x.double(), halo.double()
    results = []
    for mode, kw in modes.items():
        got = e3op.euler3d_advection(y, halo, con, **kw)
        want = e3op.euler3d_advection_plain(y, halo, con, **kw)
        if device.type != "cpu":
            torch.cuda.synchronize()
        got_tr = want_tr = truth_tr = None
        if kw.get("emit_traces"):
            (got, got_tr), (want, want_tr) = got, want
        cdt = abs(kw.get("cdt", 1.0))
        scale = torch.maximum(per_variable_max(want).double(), cdt * term)
        scale = torch.where(scale > 0, scale, torch.ones_like(scale))  # rows 0-4 of the RHS: exactly 0
        err = lambda a, b: (per_variable_max((a.double() - b.double())) / scale)
        row = {"nel_h": nel_h, "nel_v": nel_v, "s": s, "ntracer": ntracer, "dtype": str(dtype).replace("torch.", ""),
               "mode": mode, "max_abs_err": float((got - want).abs().max()), "scale": "max(output_max, cdt*term)"}
        row_err = err(got, want)
        if f64:
            row["row_err"] = [float(e) for e in row_err]
            row["err"] = float(row_err.max())
            row["tol"] = tol
            ok = row["err"] <= tol
        else:
            kw64 = dict(kw, x=x64) if "x" in kw else kw
            truth = e3op.euler3d_advection_plain(y64, halo64, con64, **kw64)
            if kw.get("emit_traces"):
                truth, truth_tr = truth
            kernel_err, plain_err = err(got, truth), err(want, truth)
            limit = torch.clamp(2.0 * plain_err, min=tol)
            row.update(row_err=[float(e) for e in kernel_err], plain_row_err=[float(e) for e in plain_err],
                       err=float((kernel_err / limit).max()) * tol, tol=tol, kernel_vs_plain=float(row_err.max()))
            ok = bool((kernel_err <= limit).all())
        if got_tr is not None:
            tr_scale = per_variable_max(want_tr).double()
            if f64:
                row["traces_err"] = float((per_variable_max(got_tr.double() - want_tr.double()) / tr_scale).max())
                ok = ok and row["traces_err"] <= tol
            else:
                kt = per_variable_max(got_tr.double() - truth_tr) / tr_scale
                pt = per_variable_max(want_tr.double() - truth_tr) / tr_scale
                row["traces_err"] = float(kt.max())
                ok = ok and bool((kt <= torch.clamp(2.0 * pt, min=tol)).all())
        if mode == "rhs":
            row["dynamical_rows_zero"] = bool((got[:5] == 0).all())
            ok = ok and row["dynamical_rows_zero"]
        masses = []
        stage = "cdt" in kw
        for r in range(5, y.shape[0]):
            g_int, g_abs = advection_mass(got, r, wsg, kw.get("x"), y, kw.get("a", 0.0), kw.get("b", 1.0), stage)
            w_int, w_abs = advection_mass(want, r, wsg, kw.get("x"), y, kw.get("a", 0.0), kw.get("b", 1.0), stage)
            rounding = 4.0 * torch.finfo(dtype).eps * float((wsg * want[r].double()).abs().sum())
            m = {"err": abs(g_int - w_int) / w_abs, "tol": tol + rounding / w_abs, "own": abs(g_int) / g_abs}
            masses.append(m)
            ok = ok and m["err"] <= m["tol"]
            if not stage:  # the RHS's own integral: zero to round-off
                m["own_tol"] = 1e-12 if f64 else 1e-5
                ok = ok and m["own"] <= m["own_tol"]
        row["tracer_mass"] = masses
        row["ok"] = bool(ok and torch.isfinite(got).all().item())
        results.append(row)
    return results


def euler3d_advection_work(con, ntracer: int, stage: bool = False, use_x: bool = False, traces: bool = False):
    """(bytes, operations) of one call of the advection operator, each input
    read once and each output written once, counting what the function
    depends on: in RHS mode rho, the three momenta and the tracers of q
    (rho*theta is not read), in stage mode every row of q (and of x); the
    out rows; rho, the two horizontal momenta and the tracers of the halo;
    sqrt(g) and 1/sqrt(g) (one panel) and the interface sqrt(g); the
    emitted traces. Operations (an add, multiply, divide, log or exp is
    one, an fma two), each interface computed once: a node's three
    velocities, sqrt(g)-weighted fluxes, divergence (3 s fmas a tracer) and
    corrections (6 products and their sum); an interior interface point's
    two traces (rho through s logs, s fmas and an exp; the normal momentum
    and each tracer s fmas), its speeds and each tracer's flux (the ground
    and the lid need none); the stage combination; the traces."""
    nh, nk, s = con.nel_h, con.nel_v, con.s
    s2, s3 = s * s, s**3
    nv = 5 + ntracer
    n_elem, item = con.npanel * nk * nh * nh, torch.finfo(con.dtype).bits // 8
    node_words = n_elem * s3
    words = node_words * ((nv if stage else 4 + ntracer) + nv + (nv if use_x else 0))
    words += 2 * (con.fields.numel() // con.fields.shape[0])  # sqrt(g), 1/sqrt(g)
    words += sum(f.numel() // f.shape[0] for f in (con.itf_x, con.itf_y, con.itf_z))  # interface sqrt(g)
    edge = 4 * con.npanel * nk * nh * s2
    words += (3 + ntracer) * edge + (nv * edge if traces else 0)
    points = con.npanel * (2 * nk * nh * (nh + 1) + (nk - 1) * nh * nh) * s2  # interfaces with a flux
    ops = node_words * (9 + ntracer * (3 + 6 * s + 13))
    ops += points * (2 * ((3 * s + 1) + 2 * s + 2 * s * ntracer) + 8 + 7 * ntracer)
    ops += node_words * nv * ((2 if stage else 0) + (2 if use_x else 0))
    if traces:
        ops += edge * (nv * 2 * s + 2 * (s + 1))
    return words * item, ops


def advection_kernel_resources(dtype, s: int, ntracer: int) -> dict:
    """{"interface", "volume": {registers, local_bytes, smem_bytes,
    blocks_per_sm, threads}}: what the runtime reports of the advection
    kernel's two passes at one dtype, s and tracer count (on the card;
    builds the library)."""
    import ctypes

    from .build import load_library

    lib = load_library("euler3d_advection")
    out = {}
    for kernel, name in enumerate(("interface", "volume")):
        info = (ctypes.c_int * 5)()
        rc = lib.euler3d_advection_resources(1 if dtype == torch.float64 else 0, s, ntracer, kernel,
                                             ctypes.cast(info, ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"euler3d_advection_resources failed: CUDA error {rc}")
        out[name] = dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm", "threads"), info))
    return out


# ---------------------------------------------------------------------------
# The Jacobian action of the tracer advection (DCMIP 11 and 12)
#
# ``compare_euler3d_advection_tangent``: the prep and apply kernels against
# their plain versions on ``advection_inputs``' state y in a direction v of
# 1e-3 of each row's max times N(0,1) (rows 0-4 too), in two modes:
# ``tangent`` (y as it is) and ``tangent_ties`` (the momenta of every
# element of the first half of the columns of each panel zeroed, so that the
# interfaces between them have zero normal speed on both sides: the tie of
# max(|vL|, |vR|) at 0). J.v's rows are scaled by the larger of their max
# and the tracer's J.v term scale (``advection_tangent_term_scale``); rows
# 0-4 must be exactly 0. float64: J.v within 1e-12 of the plain pair's; the
# prep's buffer within 1e-12 of each row's max (c_L and c_R, the tie
# weights, apart: the share of entries that differ, reported); the
# apply on the kernel's buffer within 1e-12 of its plain version's. float32:
# against the plain float64 pair on the same (float32-rounded) inputs,
# within 1e-5 or twice the plain float32 pair's distance from it (J.v, and
# the prep's buffer row by row). Each tracer's mass integral of the
# kernels' J.v against the plain pair's (as ``compare_advection`` holds the
# RHS's), and of their J.(0, 0, 0, 0, 0, dT), the kind of direction the
# path's Krylov loop applies, over its absolute integral: zero to 1e-12
# (float64; 1e-5 float32). J.v itself carries tracer mass in a direction
# that moves the momenta: at a panel-edge point whose normal speed is
# exactly 0 on both sides, jax.jvp's d|x| = +dx (the rule the port keeps)
# gives the two panels, whose normals point opposite ways there, two
# flux derivatives. In the ``tangent`` mode also J.(0, dT) against the
# advection kernel's RHS at (rho, m, rho*theta, dT) (the operator is linear
# in the tracers at fixed rho and m), within the operator tolerance of that
# RHS's row scale.

ADVECTION_TANGENT_MODES = ("tangent", "tangent_ties")


def advection_direction(q: torch.Tensor, seed: int = 7) -> torch.Tensor:
    """A direction of 1e-3 of each row's max of ``q`` times N(0,1) (numpy,
    seeded), every row set."""
    rng = np.random.default_rng(seed)
    scale = per_variable_max(q).double().cpu().numpy().reshape(-1, *([1] * (q.dim() - 1)))
    return torch.as_tensor(1e-3 * scale * rng.standard_normal(tuple(q.shape)), dtype=q.dtype, device=q.device)


def zero_momenta_columns(q: torch.Tensor) -> torch.Tensor:
    """q with the momenta of the first half of the element columns (ex; at
    least one) of every panel and level set to 0."""
    out = q.clone()
    out[1:4, :, :, :, : max(1, q.shape[4] // 2)] = 0.0
    return out


def _ratio(x: float, scale: float) -> float:
    """x / scale, with 0 / 0 = 0 (a zero field carries no mass)."""
    return abs(x) / scale if scale > 0 else (0.0 if x == 0 else float("inf"))


def advection_tangent_term_scale(q: torch.Tensor, v: torch.Tensor, con) -> torch.Tensor:
    """Per-row scale of J(q).v: for each tracer row the max of its interior
    flux-derivative divergence ``inv_sqrtG * div(sqrt(g) (u_d dT_k + (T_k /
    rho)(dm_d - u_d d rho)))``; 0 for rows 0-4."""
    q, v = q.double(), v.double()
    sqrtg, invsg = con.fields[0].double(), con.fields[1].double()
    rho = q[0]
    flux = []
    for d in range(3):
        u = q[1 + d] / rho
        flux.append(sqrtg * (u * v[5:] + (q[5:] / rho) * (v[1 + d] - u * v[0])))
    scale = torch.zeros(q.shape[0], dtype=torch.float64, device=q.device)
    scale[5:] = per_variable_max(invsg * (torch.cat(flux, dim=-1) @ con.dd.double()))
    return scale


def _advection_prep_rows(coef, con) -> dict:
    """{name: row} of an advection tangent buffer: the node rows and each
    family's interface rows (face_z holds none with one level)."""
    node, faces = e3op.advection_tangent_parts(coef, con)
    nt = coef.ntracer
    names = list(e3op.ADVECTION_TANGENT_NODE_ROWS) + [f"phi{n}" for n in range(nt)]
    rows = {name: node[r] for r, name in enumerate(names)}
    face_names = list(e3op.ADVECTION_TANGENT_FACE_ROWS) + [f"T{n}_{side}" for side in "LR" for n in range(nt)]
    for fam, face in zip("xyz", faces):
        if face.numel():
            rows.update({f"{fam}.{name}": face[r] for r, name in enumerate(face_names)})
    return rows


ADVECTION_TIE_ROWS = ("c_L", "c_R")


def compare_euler3d_advection_tangent(nel_h: int, nel_v: int, s: int, ntracer: int, dtype, device="cuda",
                                      seed: int = 0):
    """The advection tangent's prep and apply kernels against their plain
    versions on ``advection_inputs`` (``compare_advection_tangent``)."""
    con, topology, ops, _, y = advection_inputs(nel_h, nel_v, s, ntracer, dtype, device, seed)
    con64 = con if dtype == torch.float64 else euler3d_constants(nel_h, nel_v, s, ADVECTION_CASES[ntracer],
                                                                 torch.float64, device)
    return compare_advection_tangent(con, con64, topology, ops, y, advection_direction(y))


def compare_advection_tangent(con, con64, topology, ops, q, v):
    """The advection tangent's kernels against their plain versions at the
    state ``q`` in the direction ``v`` (``con``'s dtype and device;
    ``con64`` the float64 constants of the float32 truth), in the modes of
    ``ADVECTION_TANGENT_MODES``; one dict a mode with the scaled error
    ``err`` (worst row), its tolerance ``tol`` and ``ok`` (tolerances
    above)."""
    dtype, device = con.dtype, con.device
    f64 = dtype == torch.float64
    tol = E3_TOLERANCE[dtype]
    own_tol = 1e-12 if f64 else 1e-5
    wsg = mass_weights(ops, con)
    results = []
    for mode in ADVECTION_TANGENT_MODES:
        y = q if mode == "tangent" else zero_momenta_columns(q)
        halo_q, halo_v = tangent_halos(y, v, con, topology)
        coef = e3op.euler3d_advection_tangent_prep(y, halo_q, con)
        got = e3op.euler3d_advection_tangent_apply(v, halo_v, coef, con)
        want_coef = e3op.euler3d_advection_tangent_prep_plain(y, halo_q, con)
        want = e3op.euler3d_advection_tangent_apply_plain(v, halo_v, want_coef, con)
        apply_plain = e3op.euler3d_advection_tangent_apply_plain(v, halo_v, coef, con)
        if device.type != "cpu":
            torch.cuda.synchronize()
        term = advection_tangent_term_scale(y, v, con64)
        scale = torch.maximum(per_variable_max(want).double(), term)
        scale = torch.where(scale > 0, scale, torch.ones_like(scale))  # rows 0-4: exactly 0
        err = lambda a, b: per_variable_max(a.double() - b.double()) / scale
        got_rows, want_rows = _advection_prep_rows(coef, con), _advection_prep_rows(want_coef, con)
        row_err = lambda g, w: float((g.double() - w.double()).abs().max() / w.double().abs().max().clamp_min(1e-300))
        tie_rows = [k for k in got_rows if k.split(".")[-1] in ADVECTION_TIE_ROWS]
        flips = sum(int((got_rows[k] != want_rows[k]).sum()) for k in tie_rows)
        ties = sum(want_rows[k].numel() for k in tie_rows)
        values = {k: r for k, r in got_rows.items() if k not in tie_rows}
        row = {"nel_h": con.nel_h, "nel_v": con.nel_v, "s": con.s, "ntracer": q.shape[0] - 5,
               "dtype": str(dtype).replace("torch.", ""), "mode": mode, "max_abs_err": float((got - want).abs().max()),
               "scale": "max(output_max, term)", "dynamical_rows_zero": bool((got[:5] == 0).all()),
               "tie_flips": flips / ties, "apply_err": float((err(got, apply_plain)).max()),
               "prep_max_abs_err": max(float((values[k] - want_rows[k]).abs().max()) for k in values)}
        ok = row["dynamical_rows_zero"] and row["apply_err"] <= (tol if f64 else E3_TANGENT_TOLERANCE[dtype])
        if f64:
            row["row_err"] = [float(e) for e in err(got, want)]
            row["err"] = max(row["row_err"])
            row["prep_err"] = max(row_err(values[k], want_rows[k]) for k in values)
            ok = ok and row["err"] <= tol and row["prep_err"] <= tol
        else:
            y64, v64 = y.double(), v.double()
            h64 = tangent_halos(y64, v64, con64, topology)
            truth_coef = e3op.euler3d_advection_tangent_prep_plain(y64, h64[0], con64)
            truth = e3op.euler3d_advection_tangent_apply_plain(v64, h64[1], truth_coef, con64)
            kernel_err, plain_err = err(got, truth), err(want, truth)
            limit = torch.clamp(2.0 * plain_err, min=tol)
            truth_rows = _advection_prep_rows(truth_coef, con64)
            prep = {k: [row_err(values[k], truth_rows[k]), row_err(want_rows[k], truth_rows[k])] for k in values}
            row.update(row_err=[float(e) for e in kernel_err], plain_row_err=[float(e) for e in plain_err],
                       err=float((kernel_err / limit).max()) * tol, kernel_vs_plain=float(err(got, want).max()),
                       prep_err=max(k for k, _ in prep.values()),
                       prep_rows_over=[k for k, (kern, plain) in prep.items() if not kern <= max(tol, 2.0 * plain)])
            ok = ok and bool((kernel_err <= limit).all()) and not row["prep_rows_over"]
        row["tol"] = tol
        # Each tracer's mass of J.v against the plain pair's, and the mass of
        # J.(0, dT), the path's kind of direction, against zero.
        v_t = torch.cat([torch.zeros_like(v[:5]), v[5:]]).contiguous()
        jv_t = e3op.euler3d_advection_tangent_apply(v_t, tangent_halos(y, v_t, con, topology)[1], coef, con)
        masses = []
        for r in range(5, q.shape[0]):
            g_int, _ = advection_mass(got, r, wsg)
            w_int, w_abs = advection_mass(want, r, wsg)
            t_int, t_abs = advection_mass(jv_t, r, wsg)
            m = {"err": _ratio(g_int - w_int, w_abs), "tol": tol + (4.0 * torch.finfo(dtype).eps if w_abs > 0 else 0.0),
                 "own_dT": _ratio(t_int, t_abs), "own_tol": own_tol}
            masses.append(m)
            ok = ok and m["err"] <= m["tol"] and m["own_dT"] <= own_tol
        row["tracer_mass"] = masses
        if mode == "tangent":  # J.(0, dT) against the RHS kernel at (rho, m, rho*theta, dT)
            q_t = torch.cat([y[:5], v[5:]]).contiguous()
            rhs = e3op.euler3d_advection(q_t, e3op.halo_from_traces(e3op.edge_traces(q_t, con), topology), con)
            rhs_scale = torch.maximum(per_variable_max(rhs).double(), advection_term_scale(q_t.double(), con64))
            rhs_scale = torch.where(rhs_scale > 0, rhs_scale, torch.ones_like(rhs_scale))
            row["rhs_linearity_err"] = float((per_variable_max(jv_t.double() - rhs.double()) / rhs_scale).max())
            ok = ok and row["rhs_linearity_err"] <= tol
        row["ok"] = bool(ok and torch.isfinite(got).all().item())
        results.append(row)
    return results


def _advection_tangent_counts(con, ntracer: int):
    """(node words, edge words, interface points with a flux, all interface
    points) of one shape."""
    nh, nk, s = con.nel_h, con.nel_v, con.s
    s2 = s * s
    nodes = 6 * nk * nh * nh * s**3
    edge = 4 * 6 * nk * nh * s2
    points = e3op.advection_interface_points(con)
    return nodes, edge, points - 2 * 6 * nh * nh * s2, points


def _advection_metric_words(con) -> int:
    """sqrt(g) and 1/sqrt(g) (one panel) and the interface sqrt(g)."""
    return 2 * (con.fields.numel() // con.fields.shape[0]) + sum(
        f.numel() // f.shape[0] for f in (con.itf_x, con.itf_y, con.itf_z))


def euler3d_advection_tangent_work(con, ntracer: int):
    """(bytes, operations) of the Jacobian action J(q).v of the advection
    operator as one function of q, v and their halos (the bound of the
    pair; each kernel's own floor is ``euler3d_advection_tangent_prep_work``
    and ``_apply_work``), counted as ``euler3d_advection_work`` counts: rho,
    the momenta and the tracers of q and of v read once, rho, the two
    horizontal momenta and the tracers of each halo, the metric it needs,
    J.v written once (every row). Operations (an add, multiply, divide, log
    or exp one, an fma two): a node's velocities and mixing ratios, the
    three d(m_d) - u_d d rho, each tracer's three flux derivatives (4
    each), divergence (6 s) and corrections (13); an interior interface
    point's primal traces of both sides (rho 3 s + 1, the normal momentum 2
    s, each tracer 2 s) and direction traces (d rho 3 s + 1, 2 s, 2 s a
    tracer), its speeds and their derivatives (the eigenvalue's tie rule
    included: 17) and each tracer's flux derivative (15); the ground and
    the lid need none."""
    nodes, edge, flux_points, _ = _advection_tangent_counts(con, ntracer)
    item = torch.finfo(con.dtype).bits // 8
    words = nodes * (2 * (4 + ntracer) + 5 + ntracer) + 2 * (3 + ntracer) * edge + _advection_metric_words(con)
    s = con.s
    ops = nodes * (3 + ntracer + 6 + ntracer * (12 + 6 * s + 13))
    ops += flux_points * (2 * ((3 * s + 1) + 2 * s + 2 * s * ntracer) * 2 + 17 + 15 * ntracer)
    return words * item, ops


def euler3d_advection_tangent_prep_work(con, ntracer: int):
    """(bytes, operations) of one prep, counted as ``euler3d_advection_work``
    counts: rho, the momenta and the tracers of q and rho, the two
    horizontal momenta and the tracers of its halo read once, the
    coefficient buffer (``ops.euler3d_operator.advection_tangent_layout``,
    which holds no entry at the ground and the lid) written once.
    Operations: a node's 4 + nt divisions; each interface point off the
    ground and the lid: its two primal traces (rho 3 s + 1, the normal
    momentum 2 s, each tracer 2 s), its two speeds, their magnitudes, the
    eigenvalue and the tie weights (9)."""
    nodes, edge, flux_points, _ = _advection_tangent_counts(con, ntracer)
    item = torch.finfo(con.dtype).bits // 8
    words = nodes * (4 + ntracer) + (3 + ntracer) * edge + e3op.advection_tangent_layout(con, ntracer)["size"]
    s = con.s
    ops = nodes * (4 + ntracer) + flux_points * (2 * ((3 * s + 1) + 2 * s + 2 * s * ntracer) + 9)
    return words * item, ops


def euler3d_advection_tangent_apply_work(con, ntracer: int):
    """(bytes, operations) of one apply, counted as
    ``euler3d_advection_work`` counts: rho, the momenta and the tracers of
    v and the halo rows of v the apply reads, the coefficient buffer and
    the metric read once, J.v written once. The apply's own floor, beside
    the function's (``euler3d_advection_tangent_work``): the buffer is its
    price for doing no transcendental and no division at the nodes.
    Operations: a node's three d(m_d) - u_d d rho (6), each tracer's three
    flux derivatives (4 each), divergence (6 s) and corrections (13); an
    interior interface point's two direction traces (d rho 3 s + 1, the
    normal momentum 2 s, each tracer 2 s), the speeds' derivatives (9: two
    of them divisions), the sqrt(g) products (6) and each tracer's flux
    derivative (15)."""
    nodes, edge, flux_points, _ = _advection_tangent_counts(con, ntracer)
    item = torch.finfo(con.dtype).bits // 8
    words = nodes * (4 + ntracer + 5 + ntracer) + (3 + ntracer) * edge + _advection_metric_words(con)
    words += e3op.advection_tangent_layout(con, ntracer)["size"]
    s = con.s
    ops = nodes * (6 + ntracer * (12 + 6 * s + 13))
    ops += flux_points * (2 * ((3 * s + 1) + 2 * s + 2 * s * ntracer) + 15 + 15 * ntracer)
    return words * item, ops


def advection_tangent_kernel_resources(dtype, s: int, ntracer: int) -> dict:
    """{"prep_node", "prep_interface", "apply_interface", "apply_volume":
    {registers, local_bytes, smem_bytes, blocks_per_sm, threads}}: what the
    runtime reports of the advection tangent's four kernels at one dtype, s
    and tracer count (on the card; builds the library)."""
    import ctypes

    from .build import load_library

    lib = load_library("euler3d_advection_tangent")
    out = {}
    for kernel, name in enumerate(("prep_node", "prep_interface", "apply_interface", "apply_volume")):
        info = (ctypes.c_int * 5)()
        rc = lib.euler3d_advection_tangent_resources(1 if dtype == torch.float64 else 0, s, ntracer, kernel,
                                                     ctypes.cast(info, ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"euler3d_advection_tangent_resources failed: CUDA error {rc}")
        out[name] = dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm", "threads"), info))
    return out


# ---------------------------------------------------------------------------
# The 2D Cartesian Euler operators (DFR and FV) and their Jacobian actions.
#
# Inputs (``euler_cartesian_inputs``): a case's initial state with seeded
# noise, 1e-3 relative on every variable plus winds of 2 m/s (u) and 1 m/s
# (w) N(0,1) so no AUSM interface sits at its tie, and a direction of 1e-3
# of each variable's max N(0,1); the unperturbed initial state (at rest:
# every AUSM interface at m = 0, every rusanov and upwind speed at 0) is the
# tie mode of the tangents. Tolerances: float64 1e-13 of each row's scale
# (RHS and stage: the larger of the plain output's max and |cdt| (1 in RHS
# mode) times the row's term scale, ``euler_cartesian_term_scale``: rho*w's
# RHS is the pressure gradient less gravity), 1e-12 of each row's max of
# the plain J.v for the tangents; float32 1e-5 of the same scales, or twice
# the plain float32 version's distance from the float64 truth on the same
# float32-rounded inputs. Every RHS also holds mass: the Gauss-Legendre
# weighted integrals of its rho and rho*theta rows are zero to 1e-14 (f64;
# 1e-5 f32) of the integral of their absolute values.

EC_TOLERANCE = {torch.float64: 1e-13, torch.float32: 1e-5}
EC_TANGENT_TOLERANCE = {torch.float64: 1e-12, torch.float32: 1e-5}
EC_MASS_TOLERANCE = {torch.float64: 1e-14, torch.float32: 1e-5}
EC_DT = 0.02
# The domain of each Cartesian case: the reference's bubble labs (1-3) and
# the symmetric half of Straka et al. (1993)'s density current (4).
CARTESIAN_DOMAINS = {1: ((0.0, 1000.0), (0.0, 1000.0)), 2: ((0.0, 1000.0), (0.0, 1500.0)),
                     3: ((0.0, 1000.0), (0.0, 1000.0)), 4: ((0.0, 25600.0), (0.0, 6400.0))}
CARTESIAN_THETA = {1: 303.15, 2: 303.15, 3: 303.15, 4: 300.0}


def euler_cartesian_setup(nel_x: int, nel_z: int, s: int, case: int = 2):
    """(geometry, DFR operators, initial state) of a Cartesian case."""
    from ..geometry import make_cartesian_2d
    from ..testcases import initialize_cartesian2d

    (x0, x1), (z0, z1) = CARTESIAN_DOMAINS[case]
    geom = make_cartesian_2d((x0, x1), (z0, z1), nel_x, nel_z, s)
    return geom, make_dfr_operators(s), initialize_cartesian2d(geom, case, CARTESIAN_THETA[case])


def perturbed_cartesian(q0: np.ndarray, rng) -> np.ndarray:
    """``q0`` with 1e-3 relative noise and seeded winds (u 2 m/s, w 1 m/s N(0,1))."""
    y = q0 * (1.0 + 1e-3 * rng.standard_normal(q0.shape))
    y[1] = y[1] + 2.0 * rng.standard_normal(y[1].shape) * y[0]
    y[2] = y[2] + 1.0 * rng.standard_normal(y[2].shape) * y[0]
    return y


def cartesian_direction(y: np.ndarray, rng) -> np.ndarray:
    """A direction of 1e-3 of each variable's max times N(0,1)."""
    scale = np.abs(y).reshape(y.shape[0], -1).max(axis=1).reshape((-1,) + (1,) * (y.ndim - 1))
    return 1e-3 * scale * rng.standard_normal(y.shape)


def euler_cartesian_inputs(nel_x: int, nel_z: int, s: int, dtype, device, case: int = 2, seed: int = 0):
    """(ops, float64 constants, constants, x, y, v, q0) on ``device``: the
    stage's a-term x, the perturbed state y, the direction v and the
    initial state q0 (at rest), in ``dtype``."""
    from ..ops import euler_cartesian_operator as ecop

    geom, ops, q0 = euler_cartesian_setup(nel_x, nel_z, s, case)
    rng = np.random.default_rng(seed)
    y = perturbed_cartesian(q0, rng)
    x = q0 * (1.0 + 1e-3 * rng.standard_normal(q0.shape))
    v = cartesian_direction(y, rng)
    con = ecop.build_constants(geom, ops, dtype=dtype, device=device)
    con64 = con if dtype == torch.float64 else ecop.build_constants(geom, ops, device=device)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return ops, con64, con, t(x), t(y), t(v), t(q0)


def euler_cartesian_term_scale(q: torch.Tensor, con) -> torch.Tensor:
    """Per row, the larger of the max of the x and z flux divergence terms
    (rho*w: and of the gravity term), float64."""
    from ..ops import euler_cartesian_operator as ecop

    q = q.double()
    ss = con.s * con.s
    dd = con.dd.double()
    fx, fz = ecop.pointwise_fluxes(q)
    term = torch.maximum(per_variable_max(fx @ dd[:ss]), per_variable_max(fz @ dd[ss:]))
    term[2] = torch.maximum(term[2], (q[0] * GRAVITY).abs().max())
    return term


def cartesian_mass(out: torch.Tensor, ops) -> list:
    """Per row rho (0) and rho*theta (3) of a DFR RHS (4, ..., s^2) with its
    operators, or of an FV one (``ops`` None: equal cells): the
    Gauss-Legendre weighted integral over the integral of the absolute
    values, float64."""
    w = torch.ones((), dtype=torch.float64, device=out.device)
    if ops is not None:
        w = torch.as_tensor(np.outer(ops.weights, ops.weights).reshape(-1), dtype=torch.float64, device=out.device)
    rows = []
    for r in (0, 3):
        a = out[r].double()
        total = float((w * a.abs()).sum())
        rows.append(abs(float((w * a).sum())) / total if total > 0 else 0.0)
    return rows


def _f32_hold(got, want, truth, scale, tol):
    """(scaled error, ok) of a float32 kernel output against the float64
    truth: within ``tol`` of ``scale`` or twice the plain float32 output's
    distance, per row."""
    err = lambda a: per_variable_max(a.double() - truth) / scale
    kernel_err, plain_err = err(got), err(want)
    limit = torch.clamp(2.0 * plain_err, min=tol)
    return float((kernel_err / limit).max()) * tol, bool((kernel_err <= limit).all())


def compare_cartesian(con, con64, ops, x, y, v, q0):
    """The DFR kernel and its tangent against their plain versions on
    states of ``con``'s dtype and device (``con64``: the float64 constants
    of the float32 truth): RHS, stage, stage + x, J.v at y and J.v at q0 (at
    rest: the ties). One dict per mode with the scaled error ``err`` (worst
    row), ``tol``, ``max_abs_err``, the RHS's mass (``mass``: rho, rho*theta)
    and ``ok``."""
    from ..ops import euler_cartesian_operator as ecop

    dtype, device = con.dtype, con.device
    f64 = dtype == torch.float64
    term = euler_cartesian_term_scale(y, con64)
    modes = {"rhs": dict(), "stage": dict(a=0.0, b=1.0, cdt=EC_DT), "stage_x": dict(x=x, a=0.75, b=0.25, cdt=0.25 * EC_DT)}
    results = []
    base = {"nel_x": con.nel_x, "nel_z": con.nel_z, "s": con.s, "dtype": str(dtype).replace("torch.", "")}
    for mode, kw in modes.items():
        got = ecop.euler_cartesian(y, con, **kw)
        want = ecop.euler_cartesian_plain(y, con, **kw)
        if device.type != "cpu":
            torch.cuda.synchronize()
        scale = torch.maximum(per_variable_max(want).double(), abs(kw.get("cdt", 1.0)) * term)
        tol = EC_TOLERANCE[dtype]
        row = dict(base, mode=mode, max_abs_err=float((got - want).abs().max()), tol=tol)
        if f64:
            row["err"] = _scaled(got.double() - want.double(), scale)
            ok = row["err"] <= tol
        else:
            kw64 = dict(kw, x=x.double()) if "x" in kw else kw
            truth = ecop.euler_cartesian_plain(y.double(), con64, **kw64)
            row["err"], ok = _f32_hold(got, want, truth, scale, tol)
            row["kernel_vs_plain"] = _scaled(got.double() - want.double(), scale)
        if mode == "rhs":
            row["mass"] = cartesian_mass(got, ops)
            ok = ok and max(row["mass"]) <= EC_MASS_TOLERANCE[dtype]
        row["ok"] = bool(ok and torch.isfinite(got).all().item())
        results.append(row)
    for mode, q in (("tangent", y), ("tangent_rest", q0)):
        got = ecop.euler_cartesian_tangent(q, v, con)
        want = ecop.euler_cartesian_tangent_plain(q, v, con)
        if device.type != "cpu":
            torch.cuda.synchronize()
        tol = EC_TANGENT_TOLERANCE[dtype]
        row = dict(base, mode=mode, max_abs_err=float((got - want).abs().max()), tol=tol)
        if f64:
            row["err"] = _scaled(got - want, per_variable_max(want))
            ok = row["err"] <= tol
        else:
            truth = ecop.euler_cartesian_tangent_plain(q.double(), v.double(), con64)
            row["err"], ok = _f32_hold(got, want, truth, per_variable_max(truth), tol)
        row["ok"] = bool(ok and torch.isfinite(got).all().item())
        results.append(row)
    return results


def compare_euler_cartesian(nel_x: int, nel_z: int, s: int, dtype, device="cuda", case: int = 2, seed: int = 0):
    """``compare_cartesian`` on ``euler_cartesian_inputs``."""
    ops, con64, con, x, y, v, q0 = euler_cartesian_inputs(nel_x, nel_z, s, dtype, device, case, seed)
    rows = compare_cartesian(con, con64, ops, x, y, v, q0)
    for r in rows:
        r["case"] = case
    return rows


def euler_cartesian_fv_inputs(ncell_x: int, ncell_z: int, flux: str, dtype, device, case: int = 2, seed: int = 0):
    """(float64 constants, constants, y, v, q0) of the FV operator on a
    case's s = 1 grid, as ``euler_cartesian_inputs``."""
    from ..ops import euler_cartesian_operator as ecop

    geom, _, q0 = euler_cartesian_setup(ncell_x, ncell_z, 1, case)
    q0 = q0[..., 0]
    rng = np.random.default_rng(seed)
    y = perturbed_cartesian(q0, rng)
    v = cartesian_direction(y, rng)
    con = ecop.build_fv_constants(geom, flux, dtype=dtype, device=device)
    con64 = con if dtype == torch.float64 else ecop.build_fv_constants(geom, flux, device=device)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return con64, con, t(y), t(v), t(q0)


def compare_cartesian_fv(con, con64, y, v, q0):
    """The FV kernel and its tangent against their plain versions: RHS and
    J.v at y and at q0 (at rest), one dict per mode as ``compare_cartesian``
    (the RHS's scale: the larger of the output's max and the row's term
    scale, the max of |F_x|/dx and |F_z|/dz of its pointwise fluxes, and for
    rho*w of gravity)."""
    from ..ops import euler_cartesian_operator as ecop

    dtype, device = con.dtype, con.device
    f64 = dtype == torch.float64
    base = {"ncell_x": con.ncell_x, "ncell_z": con.ncell_z, "flux": con.flux,
            "dtype": str(dtype).replace("torch.", "")}
    results = []
    got = ecop.euler_cartesian_fv(y, con)
    want = ecop.euler_cartesian_fv_plain(y, con)
    if device.type != "cpu":
        torch.cuda.synchronize()
    y64 = y.double()
    fx, fz = ecop.pointwise_fluxes(y64)
    term = torch.maximum(per_variable_max(fx) / con.dx, per_variable_max(fz) / con.dz)
    term[2] = torch.maximum(term[2], (y64[0] * GRAVITY).abs().max())
    term = torch.maximum(per_variable_max(want).double(), term)
    tol = EC_TOLERANCE[dtype]
    row = dict(base, mode="rhs", max_abs_err=float((got - want).abs().max()), tol=tol)
    if f64:
        row["err"] = _scaled(got.double() - want.double(), term)
        ok = row["err"] <= tol
    else:
        truth = ecop.euler_cartesian_fv_plain(y64, con64)
        row["err"], ok = _f32_hold(got, want, truth, term, tol)
    row["mass"] = cartesian_mass(got, None)
    ok = ok and max(row["mass"]) <= EC_MASS_TOLERANCE[dtype]
    row["ok"] = bool(ok and torch.isfinite(got).all().item())
    results.append(row)
    for mode, q in (("tangent", y), ("tangent_rest", q0)):
        got = ecop.euler_cartesian_fv_tangent(q, v, con)
        want = ecop.euler_cartesian_fv_tangent_plain(q, v, con)
        if device.type != "cpu":
            torch.cuda.synchronize()
        tol = EC_TANGENT_TOLERANCE[dtype]
        row = dict(base, mode=mode, max_abs_err=float((got - want).abs().max()), tol=tol)
        if f64:
            row["err"] = _scaled(got - want, per_variable_max(want))
            ok = row["err"] <= tol
        else:
            truth = ecop.euler_cartesian_fv_tangent_plain(q.double(), v.double(), con64)
            row["err"], ok = _f32_hold(got, want, truth, per_variable_max(truth), tol)
        row["ok"] = bool(ok and torch.isfinite(got).all().item())
        results.append(row)
    return results


def compare_euler_cartesian_fv(ncell_x: int, ncell_z: int, flux: str, dtype, device="cuda", case: int = 2,
                               seed: int = 0):
    """``compare_cartesian_fv`` on ``euler_cartesian_fv_inputs``."""
    con64, con, y, v, q0 = euler_cartesian_fv_inputs(ncell_x, ncell_z, flux, dtype, device, case, seed)
    return compare_cartesian_fv(con, con64, y, v, q0)


def euler_cartesian_work(con, stage: bool = False, use_x: bool = False, tangent: bool = False):
    """(bytes, operations) of one call of the DFR operator (``tangent``: of
    its Jacobian action), each input read once and each output written
    once: q (and v, and x) and the output, 4 rows of every node; the 1D
    factors are negligible. Operations (an add, multiply, divide, log, exp
    or sqrt is one, an fma two), each interface computed once: a node's
    pointwise fluxes (16), divergence (2 s fmas a row and direction) and
    corrections (4 fmas a row), gravity (2); an interior interface point's
    two traces (s fmas a row and side) and AUSM flux (45); a wall point's
    trace and pressure; the stage combination. The tangent's operations are
    counted as three times the RHS's (a dual product is a product and an
    fma on the tangent)."""
    s, nx, nz = con.s, con.nel_x, con.nel_z
    nodes = nx * nz * s * s
    item = torch.finfo(con.dtype).bits // 8
    words = nodes * 4 * (2 + (1 if use_x else 0) + (1 if tangent else 0))
    interior = (nz * (nx - 1) + (nz - 1) * nx) * s
    walls = 2 * (nx + nz) * s
    ops = nodes * (16 + 4 * 2 * 2 * s + 4 * 4 * 2 + 2)
    ops += interior * (2 * 4 * 2 * s + 45) + walls * (4 * 2 * s + 5)
    if stage:
        ops += nodes * 4 * (3 + (2 if use_x else 0))
    if tangent:
        ops *= 3
    return words * item, ops


def euler_cartesian_fv_work(con, tangent: bool = False):
    """(bytes, operations) of one call of the FV operator (``tangent``: its
    Jacobian action): q (and v) read once and the output written once, 4
    rows a cell; operations: a cell's pressure (5), each interior
    interface's flux once (45), a wall's none beyond the pressure, a cell's
    flux differences (4 rows, 5 each) and gravity (2); three times the RHS's
    for the tangent."""
    nx, nz = con.ncell_x, con.ncell_z
    cells = nx * nz
    item = torch.finfo(con.dtype).bits // 8
    words = cells * 4 * (2 + (1 if tangent else 0))
    ops = cells * (5 + 4 * 5 + 2) + (nz * (nx - 1) + (nz - 1) * nx) * 45
    return words * item, ops * (3 if tangent else 1)


def euler_cartesian_kernel_resources(dtype, s: int, flux: str = "ausm") -> dict:
    """{"operator", "tangent", "fv", "fv_tangent": {registers, local_bytes,
    smem_bytes, blocks_per_sm, threads}}: what the runtime reports of the
    four Cartesian kernels at one dtype, s and FV flux (on the card; builds
    the library)."""
    import ctypes

    from ..ops.euler_cartesian_operator import FV_FLUXES
    from .build import load_library

    lib = load_library("euler_cartesian")
    out = {}
    for kernel, name in enumerate(("operator", "tangent", "fv", "fv_tangent")):
        info = (ctypes.c_int * 5)()
        rc = lib.euler_cartesian_resources(1 if dtype == torch.float64 else 0,
                                           s if kernel < 2 else FV_FLUXES.index(flux), kernel,
                                           ctypes.cast(info, ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"euler_cartesian_resources failed: CUDA error {rc}")
        out[name] = dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm", "threads"), info))
    return out
