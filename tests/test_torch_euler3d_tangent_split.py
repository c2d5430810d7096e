"""The split Jacobian action of the 3D Euler operator: the prep
(``euler3d_tangent_prep``, once per linearisation point, writing the
coefficient buffer) and the linear apply (``euler3d_tangent_apply``, once
per direction), run on the CPU through their plain versions, which use the
kernels' layout (``tangent_layout``), with the halos ``Euler3DRHS.jtv_prep``
and its glue give them (on the card ``jtv_prep`` launches the prep and
``jtv_apply`` the apply; on the CPU they run the plain tangent).

Inputs as the JAX package's test_tangent_kernel_matches_jvp makes them
(tests/test_pallas_euler3d.py:238-244), from a numpy seed: q = q0 + dq with
dq = 1e-4 q0 N(0,1), v = 1e-3 max|q0| N(0,1) per variable. The acoustic
wave of case 77 (the rotating planet) starts at rest: there dq adds a wind
of 0.1 m/s N(0,1) to the momenta, so that no normal speed is 0 (where
km3_fused's sign(0) = 0 and jax.jvp's +1 part), and the direction's w gets
a scale of its own. Each case runs in absolute form and in the
perturbation form around q0. Errors are per variable, scaled by the
reference's max.

* prep + apply against ``torch.func.jvp`` of the plain operator
  (``euler3d_tangent_plain``, ``euler3d_tangent_pert_plain``): 1e-12;
* prep + apply (``euler3d_tangent``) against ``jax.jvp`` of the JAX
  package's XLA RHS (its ``delta`` in perturbation form) and against
  ``km3_fused``'s tangent mode in interpret mode (the ``interior="pallas"``
  factory's ``jtv``): 1e-11, the bound of test_torch_euler3d_tangent.py and
  test_torch_euler3d_pert.py;
* at rest (w = 0 on every z face) with a w component in the direction, where
  d|vn| = +dvn at vn = 0 decides the answer: against jax.jvp, 1e-11;
* J.v conserves mass: |int sqrt(g) (J.v)_rho| < 1e-12 of int sqrt(g) |(J.v)_rho|;
* the apply is linear in v: apply(a v + b w) within 1e-13 of a apply(v) + b
  apply(w);
* the buffer holds what ``tangent_layout`` names, and the CPU path counts
  plain calls, no launch;
* the float32 checks of ``kernels/check.py`` hold each row of the prep's
  buffer: one row off by 1e-4 of its max fails them, and names the row.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wxfactory_tpu.models.euler_cubesphere import make_rhs_euler_cubesphere as j_make_rhs
from wxfactory_tpu.testcases.dcmip import acoustic_wave, dcmip_gravity_wave
from wxfactory_tpu_torch import interop
from wxfactory_tpu_torch.kernels.check import TANGENT_LINEARITY, compare_euler3d_pert, compare_euler3d_tangent
from wxfactory_tpu_torch.ops import euler3d_operator as e3op
from wxfactory_tpu_torch.output import global_mass_3d

torch.set_num_threads(1)

CASES = [(4, 2, 3, 31), (3, 2, 2, 31), (4, 2, 3, 77)]
CASE_IDS = ["4x2x3", "3x2x2", "rotating-4x2x3"]
FORMS = ["absolute", "perturbation"]


@functools.lru_cache(maxsize=None)
def _case(nel_h, nel_v, s, case):
    from conftest import cs3d_setup

    scale, rotating = (125.0, False) if case == 31 else (1.0, True)
    geom, ops, topo, metric = cs3d_setup(nel_h, nel_v, s, 10000.0, scale=scale, rotating=rotating)
    q0 = (dcmip_gravity_wave if case == 31 else acoustic_wave)(geom)
    rng = np.random.default_rng(7)
    dq = 1e-4 * q0 * rng.standard_normal(q0.shape)
    v = rng.standard_normal(q0.shape) * np.abs(q0).reshape(5, -1).max(axis=1).reshape(5, 1, 1, 1, 1, 1) * 1e-3
    if case == 77:
        dq[1:4] += 0.1 * q0[0] * np.random.default_rng(10).standard_normal(q0[1:4].shape)
        v[3] = np.random.default_rng(8).standard_normal(q0[3].shape) * 1e-3 * np.abs(q0[0]).max()
    return geom, ops, topo, metric, q0, dq, v


@functools.lru_cache(maxsize=None)
def _jax_references(nel_h, nel_v, s, case):
    """(jax.jvp of the XLA RHS at q0 + dq, jax.jvp of its perturbation form's
    delta at dq, km3_fused's tangent mode in interpret mode), all in v."""
    geom, ops, topo, metric, q0, dq, v = _case(nel_h, nel_v, s, case)
    rhs = j_make_rhs(geom, ops, metric, topo, dtype=jnp.float64, interior="xla")
    rp = j_make_rhs(geom, ops, metric, topo, dtype=jnp.float64, interior="xla", perturbation_base=q0)
    jvp = lambda f, a: np.asarray(jax.jit(lambda x, y: jax.jvp(f, (x,), (y,))[1])(jnp.asarray(a), jnp.asarray(v)))
    rp_k = j_make_rhs(geom, ops, metric, topo, dtype=jnp.float64, interior="pallas", perturbation_base=q0)
    assert hasattr(rp_k, "jtv")  # the km3_fused tangent route
    km3 = np.asarray(rp_k.jtv(jnp.asarray(q0 + dq), jnp.asarray(v)))
    return {"absolute": jvp(rhs, q0 + dq), "perturbation": jvp(rp.delta, dq), "km3_fused": km3}


def _scaled_err(got, want):
    scale = np.abs(want).reshape(5, -1).max(axis=1).reshape(5, 1, 1, 1, 1, 1)
    return float(np.abs((got - want) / scale).max())


def _rhs(geom, ops, metric, q0, form):
    return interop.euler3d_rhs(geom, ops, metric, perturbation_base=q0 if form == "perturbation" else None)


def _split(rhs, q, v, prep=None):
    """prep + apply at q in the direction v, with the halos of ``rhs``."""
    q_in, qa, traces, halo_q, _ = prep or rhs.jtv_prep(interop.to_tensor(q))
    vt = interop.to_tensor(v) if isinstance(v, np.ndarray) else v
    halo_v = rhs.halo(e3op.edge_traces_tangent(qa, vt, rhs.con, traces))
    return e3op.euler3d_tangent(q_in, vt, halo_q, halo_v, rhs.con, pert=rhs.pert)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("nel_h,nel_v,s,case", CASES, ids=CASE_IDS)
def test_split_plain_matches_jvp_plain(nel_h, nel_v, s, case, form):
    geom, ops, topo, metric, q0, dq, v = _case(nel_h, nel_v, s, case)
    rhs = _rhs(geom, ops, metric, q0, form)
    prep = rhs.jtv_prep(interop.to_tensor(q0 + dq))
    q_in, qa, traces, halo_q, _ = prep
    vt = interop.to_tensor(v)
    halo_v = rhs.halo(e3op.edge_traces_tangent(qa, vt, rhs.con, traces))
    got = e3op.euler3d_tangent_apply_plain(vt, halo_v, e3op.euler3d_tangent_prep_plain(q_in, halo_q, rhs.con, rhs.pert),
                                           rhs.con)
    want = rhs.jtv_apply(prep, vt)  # on the CPU: the plain tangent, torch.func.jvp of the plain operator
    if form == "perturbation":
        torch.testing.assert_close(want, e3op.euler3d_tangent_pert_plain(q_in, vt, halo_q, halo_v, rhs.con, rhs.pert),
                                   rtol=0, atol=0)
    assert _scaled_err(got.numpy(), want.numpy()) < 1e-12


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("nel_h,nel_v,s,case", CASES, ids=CASE_IDS)
def test_split_matches_jax_jvp(nel_h, nel_v, s, case, form):
    geom, ops, topo, metric, q0, dq, v = _case(nel_h, nel_v, s, case)
    want = _jax_references(nel_h, nel_v, s, case)[form]
    assert _scaled_err(_split(_rhs(geom, ops, metric, q0, form), q0 + dq, v).numpy(), want) < 1e-11


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("nel_h,nel_v,s,case", CASES, ids=CASE_IDS)
def test_split_matches_km3_fused_tangent_interpret(nel_h, nel_v, s, case, form):
    geom, ops, topo, metric, q0, dq, v = _case(nel_h, nel_v, s, case)
    want = _jax_references(nel_h, nel_v, s, case)["km3_fused"]
    assert _scaled_err(_split(_rhs(geom, ops, metric, q0, form), q0 + dq, v).numpy(), want) < 1e-11


@pytest.mark.parametrize("form", FORMS)
def test_split_at_rest_takes_jax_derivative_of_abs(form):
    """At rest (w = 0 on every z face; dq leaves rho*w at 0) with a w
    component in the direction: the prep's normal speeds are 0 there and
    the apply takes d|w| = +dw, as jax.jvp does."""
    geom, ops, topo, metric, q0, dq, v = _case(4, 2, 3, 31)
    assert not np.any(q0[3] + dq[3])
    v = v.copy()
    v[3] = np.random.default_rng(9).standard_normal(q0[3].shape) * 1e-3 * np.abs(q0[0]).max()
    rhs = j_make_rhs(geom, ops, metric, topo, dtype=jnp.float64, interior="xla")
    want = np.asarray(jax.jit(lambda a, b: jax.jvp(rhs, (a,), (b,))[1])(jnp.asarray(q0 + dq), jnp.asarray(v)))
    assert _scaled_err(_split(_rhs(geom, ops, metric, q0, form), q0 + dq, v).numpy(), want) < 1e-11


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("nel_h,nel_v,s,case", CASES, ids=CASE_IDS)
def test_jv_conserves_mass(nel_h, nel_v, s, case, form):
    geom, ops, topo, metric, q0, dq, v = _case(nel_h, nel_v, s, case)
    jv = _split(_rhs(geom, ops, metric, q0, form), q0 + dq, v).numpy()
    assert abs(global_mass_3d(jv, ops, metric)) < 1e-12 * global_mass_3d(np.abs(jv), ops, metric)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("nel_h,nel_v,s,case", CASES, ids=CASE_IDS)
def test_apply_is_linear_in_v(nel_h, nel_v, s, case, form):
    geom, ops, topo, metric, q0, dq, v = _case(nel_h, nel_v, s, case)
    rhs = _rhs(geom, ops, metric, q0, form)
    q_in, qa, traces, halo_q, _ = rhs.jtv_prep(interop.to_tensor(q0 + dq))
    coef = e3op.euler3d_tangent_prep(q_in, halo_q, rhs.con, pert=rhs.pert)
    apply = lambda x: e3op.euler3d_tangent_apply(x, rhs.halo(e3op.edge_traces_tangent(qa, x, rhs.con, traces)), coef,
                                                 rhs.con)
    a, b = TANGENT_LINEARITY
    v1 = interop.to_tensor(v)
    v2 = interop.to_tensor(np.random.default_rng(3).standard_normal(v.shape) * np.abs(v).max(axis=(1, 2, 3, 4, 5),
                                                                                              keepdims=True))
    got = apply(a * v1 + b * v2).numpy()
    want = (a * apply(v1) + b * apply(v2)).numpy()
    assert _scaled_err(got, want) < 1e-13


def test_buffer_holds_the_named_rows():
    """Node rows: 1/rho, 1/(rho theta), u, theta and p at every node; face
    rows: the left and right traces of every x interface are the east face
    of the element to the west and the west face of the one to the east
    (the halo at the panel edge), with the pressure ratios and the
    selector weight of a Rusanov flux."""
    geom, ops, topo, metric, q0, dq, v = _case(3, 2, 2, 31)
    rhs = _rhs(geom, ops, metric, q0, "absolute")
    q = interop.to_tensor(q0 + dq)
    _, _, traces, halo, _ = rhs.jtv_prep(q)
    coef = e3op.euler3d_tangent_prep(q, halo, rhs.con)
    con = rhs.con
    layout = e3op.tangent_layout(con)
    assert coef.values.shape == (layout["size"],) and not coef.pert
    node, (fx, fy, fz) = e3op._tangent_parts(coef.values, con)
    rows = dict(zip(e3op.TANGENT_NODE_ROWS, node.movedim(-2, 0)))
    torch.testing.assert_close(rows["inv_rho"], 1.0 / q[0], rtol=1e-15, atol=0)
    torch.testing.assert_close(rows["u2"], q[2] / q[0], rtol=1e-15, atol=0)
    torch.testing.assert_close(rows["theta"], q[4] / q[0], rtol=1e-15, atol=0)
    torch.testing.assert_close(rows["p"], e3op.pressure(q[4]), rtol=1e-15, atol=0)
    face = dict(zip(e3op.TANGENT_FACE_ROWS, fx))
    ss = con.s**2
    itf = e3op._exp_rows(e3op._log_rows(q) @ con.ee)  # (5, 6, nk, ny, nx, 6 s^2): W E S N D U
    west, east = itf[..., :ss], itf[..., ss : 2 * ss]
    for i, name in enumerate(("rho", "rho_u1", "rho_u2", "rho_w", "rho_theta")):
        torch.testing.assert_close(face[f"{name}_L"][:, :, :, 1:], east[i], rtol=1e-14, atol=0)
        torch.testing.assert_close(face[f"{name}_R"][:, :, :, :-1], west[i], rtol=1e-14, atol=0)
        torch.testing.assert_close(face[f"{name}_L"][:, :, :, 0], halo[i, 2], rtol=0, atol=0)
    torch.testing.assert_close(face["p_ratio_L"] * face["p_ratio_R"], torch.ones_like(face["eig"]), rtol=1e-15, atol=0)
    assert set(torch.unique(face["weight_L"]).tolist()) <= {0.0, 0.5, 1.0}


def test_cpu_path_counts_plain_calls_and_no_launch():
    """On the CPU the prep and apply wrappers run their plain versions
    (counted in ``plain_calls`` and ``plain_tangent_calls``) and launch
    nothing; ``jtv_prep`` makes no prep there; the apply checks its inputs."""
    geom, ops, topo, metric, q0, dq, v = _case(3, 2, 2, 31)
    rhs = _rhs(geom, ops, metric, q0, "perturbation")
    counts = lambda: (e3op.tangent_prep_launches, e3op.tangent_launches, e3op.pert_tangent_launches,
                      e3op.plain_calls, e3op.plain_tangent_calls)
    q_in, qa, traces, halo_q, coef = rhs.jtv_prep(interop.to_tensor(q0 + dq))
    assert coef is None
    vt = interop.to_tensor(v)
    halo_v = rhs.halo(e3op.edge_traces_tangent(qa, vt, rhs.con, traces))
    before = counts()
    coef = e3op.euler3d_tangent_prep(q_in, halo_q, rhs.con, pert=rhs.pert)
    assert coef.pert
    e3op.euler3d_tangent_apply(vt, halo_v, coef, rhs.con)
    e3op.euler3d_tangent_apply(vt, halo_v, coef, rhs.con)
    assert counts() == before[:3] + (before[3] + 1, before[4] + 2)
    with pytest.raises(ValueError):
        e3op.euler3d_tangent_apply(vt.float(), halo_v, coef, rhs.con)
    with pytest.raises(ValueError):
        e3op.euler3d_tangent_apply(vt, halo_v, e3op.TangentCoefficients(coef.values[1:], True), rhs.con)


@pytest.mark.parametrize("form", FORMS)
def test_float32_prep_check_holds_each_row(monkeypatch, form):
    """On the CPU the prep is its plain version, so every row passes; a prep
    whose x-interface sound speed c_L is 1e-4 of its max off (what the J.v
    check alone might not see) fails the check, which names that row."""
    def compare():
        if form == "absolute":
            return compare_euler3d_tangent(3, 2, 2, torch.float32, device="cpu")
        return next(r for r in compare_euler3d_pert(3, 2, 2, torch.float32, device="cpu") if r["mode"] == "pert_tangent")

    row = compare()
    assert row["ok"] and row["prep_rows_over"] == [], row
    assert len(row["prep_rows"]) == len(e3op.TANGENT_NODE_ROWS) + 3 * (len(e3op.TANGENT_FACE_ROWS) - 1)
    plain_prep = e3op.euler3d_tangent_prep

    def off_prep(q, halo_q, con, pert=None):
        coef = plain_prep(q, halo_q, con, pert)
        values = coef.values.clone()
        fx = e3op._tangent_parts(values, con)[1][0]
        c_l = fx[e3op.TANGENT_FACE_ROWS.index("c_L")]
        c_l += 1e-4 * c_l.abs().max()
        return e3op.TangentCoefficients(values, coef.pert)

    monkeypatch.setattr(e3op, "euler3d_tangent_prep", off_prep)
    row = compare()
    assert not row["ok"] and row["prep_rows_over"] == ["x.c_L"], row["prep_rows_over"]
