"""The split Jacobian action of the shallow-water operator: the prep
(``sw_tangent_prep``, once per linearisation point, writing the coefficient
buffer) and the linear apply (``sw_tangent_apply``, once per direction), run
on the CPU through their plain versions (``sw_tangent_prep_plain``,
``sw_tangent_apply_plain``), which use the kernels' layout
(``sw_tangent_layout``). On the card ``ShallowWaterRHS.jtv_prep`` launches the
prep and ``jtv_apply`` the apply; on the CPU they run the plain tangent.

Inputs from a numpy seed, as tests/test_torch_sw_tangent.py makes them:
Williamson case 6 (or 2) plus 1e-3 of each variable's max of noise, a
direction of 1e-3 of each variable's max. Errors are per variable, scaled by
the reference's max.

* prep + apply against ``torch.func.jvp`` of the plain operator
  (``sw_tangent_plain``) and against ``jax.jvp`` of the JAX package's XLA RHS
  (``make_rhs_shallow_water(..., interior="xla")``), float64, s = 2..8:
  1e-12;
* at rest, where every interface's split Mach number is exactly 0 (the tie,
  half of dM to each split term as jax.jvp gives it): against jax.jvp,
  1e-12;
* the apply is linear in v (1e-13 of scale on one buffer), and J.v's mass
  (the weighted integral of its h row) equals the plain tangent's to
  round-off of the absolute integral;
* the float32 companion's rule (the absolute float32 operator's J.v at q32,
  ``jax.jvp(rhs32.xla, ...)``): the float32 split within 1e-4 of the JAX
  float32 J.v's max, both within 1e-4 of the float64 J.v;
* the buffer holds what ``sw_tangent_layout`` names: node rows h, hu1/h,
  hu2/h read back at single nodes; face rows at single face points through
  the apply kernel's indexing (``sw_tangent_face_index``), the element's own
  trace on its side, the neighbour's face reading the same entry, the halo
  at a panel edge;
* the CPU wrappers count plain calls and no launch, ``jtv_prep``/``jtv_apply``
  on the CPU keep the plain tangent, and a closure counts one linearisation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wxfactory_tpu.geometry import make_cubed_sphere_2d, make_metric_2d
from wxfactory_tpu.models import make_rhs_shallow_water as j_make_rhs
from wxfactory_tpu.ops.dfr import make_dfr_operators
from wxfactory_tpu.testcases import williamson_case2, williamson_case6
from wxfactory_tpu_torch import interop
from wxfactory_tpu_torch.common.constants import GRAVITY
from wxfactory_tpu_torch.kernels import check
from wxfactory_tpu_torch.ops import sw_operator as swop
from wxfactory_tpu_torch.solvers import matvec

torch.set_num_threads(1)


def _setup(nel, s, case=6):
    geom = make_cubed_sphere_2d(nel, s)
    ops = make_dfr_operators(s)
    metric = make_metric_2d(geom)
    q0 = np.asarray(williamson_case6(geom) if case == 6 else williamson_case2(geom))
    return geom, ops, metric, q0


def _scale(a):
    return np.abs(a).reshape(3, -1).max(axis=1).reshape(3, 1, 1, 1, 1)


def _err(got, want):
    return float(np.abs((got - want) / _scale(want)).max())


def _inputs(q0, seed=7, rest=False):
    rng = np.random.default_rng(seed)
    scale = 1e-3 * _scale(q0)
    q = q0 + scale * rng.standard_normal(q0.shape)
    if rest:
        q = np.concatenate([q0[:1], np.zeros_like(q0[1:])])
    return q, scale * rng.standard_normal(q0.shape), scale * rng.standard_normal(q0.shape)


def _jax_jvp(rhs, q, v):
    return np.asarray(jax.jvp(rhs, (jnp.asarray(q),), (jnp.asarray(v),))[1])


def _split(q, v, rhs):
    coef = swop.sw_tangent_prep_plain(q, rhs.con, rhs.topology)
    return swop.sw_tangent_apply_plain(coef, v, rhs.con, rhs.topology)


SHAPES = [(3, 2, 6), (4, 3, 6), (3, 4, 2), (3, 5, 6), (2, 6, 6), (2, 7, 2), (2, 8, 6)]


@pytest.mark.parametrize("nel,s,case", SHAPES, ids=[f"{n}x{s}-case{c}" for n, s, c in SHAPES])
def test_split_matches_plain_tangent_and_jax_jvp(nel, s, case):
    geom, ops, metric, q0 = _setup(nel, s, case)
    q, v, _ = _inputs(q0)
    rhs = interop.shallow_water_rhs(geom, ops, metric)
    qt, vt = interop.to_tensor(q), interop.to_tensor(v)
    got = _split(qt, vt, rhs).numpy()
    assert _err(got, swop.sw_tangent_plain(qt, vt, rhs.con, rhs.topology).numpy()) < 1e-12
    want = _jax_jvp(j_make_rhs(geom, ops, metric, dtype=jnp.float64, interior="xla"), q, v)
    assert _err(got, want) < 1e-12


@pytest.mark.parametrize("nel,s", [(3, 3), (2, 5)], ids=["3x3", "2x5"])
def test_split_at_rest_matches_jax_at_the_tie(nel, s):
    geom, ops, metric, q0 = _setup(nel, s)
    q, v, _ = _inputs(q0, rest=True)
    rhs = interop.shallow_water_rhs(geom, ops, metric)
    coef = swop.sw_tangent_prep_plain(interop.to_tensor(q), rhs.con, rhs.topology)
    _, face_x, face_y = swop._tangent_parts(coef, rhs.con)
    m_row = swop.SW_TANGENT_FACE_ROWS.index("M")
    assert bool((face_x[m_row] == 0).all()) and bool((face_y[m_row] == 0).all())
    got = swop.sw_tangent_apply_plain(coef, interop.to_tensor(v), rhs.con, rhs.topology).numpy()
    want = _jax_jvp(j_make_rhs(geom, ops, metric, dtype=jnp.float64, interior="xla"), q, v)
    assert _err(got, want) < 1e-12


@pytest.mark.parametrize("nel,s", [(3, 3), (2, 6)], ids=["3x3", "2x6"])
def test_apply_is_linear_and_conserves_mass_as_the_plain_tangent(nel, s):
    geom, ops, metric, q0 = _setup(nel, s)
    q, v, w = (interop.to_tensor(a) for a in _inputs(q0))
    rhs = interop.shallow_water_rhs(geom, ops, metric)
    coef = swop.sw_tangent_prep_plain(q, rhs.con, rhs.topology)
    apply = lambda x: swop.sw_tangent_apply_plain(coef, x, rhs.con, rhs.topology)
    a, b = check.TANGENT_LINEARITY
    lin = a * apply(v) + b * apply(w)
    assert _err(apply(a * v + b * w).numpy(), lin.numpy()) < 1e-13
    wsg = check.sw_mass_weights(ops, rhs.con)
    jv, want = apply(v), swop.sw_tangent_plain(q, v, rhs.con, rhs.topology)
    absolute = float((wsg * want[0]).abs().sum())
    assert abs(float((wsg * jv[0]).sum())) < 1e-13 * absolute
    assert abs(float((wsg * jv[0]).sum() - (wsg * want[0]).sum())) < 1e-13 * absolute


def test_f32_companion_split_is_the_absolute_operators_jvp():
    nel, s = 4, 3
    geom, ops, metric, q0 = _setup(nel, s)
    q, v, _ = _inputs(q0)
    q32, v32 = q.astype(np.float32), v.astype(np.float32)
    jrhs32 = j_make_rhs(geom, ops, metric, dtype=jnp.float32, interior="xla", perturbation_base=jnp.asarray(q0))
    want = _jax_jvp(jrhs32.xla, q32, v32).astype(np.float64)
    truth = _jax_jvp(j_make_rhs(geom, ops, metric, dtype=jnp.float64, interior="xla"), q32.astype(np.float64),
                     v32.astype(np.float64))
    sw32 = interop.shallow_water_rhs(geom, ops, metric, dtype=torch.float32, perturbation_base=q0)
    got = _split(torch.as_tensor(q32), torch.as_tensor(v32), sw32)
    assert got.dtype == torch.float32
    got = got.double().numpy()
    assert _err(got, want) < 1e-4
    assert _err(got, truth) < 1e-4 and _err(want, truth) < 1e-4


def test_buffer_holds_the_layouts_rows():
    nel, s = 3, 3
    geom, ops, metric, q0 = _setup(nel, s)
    q, _, _ = _inputs(q0)
    rhs = interop.shallow_water_rhs(geom, ops, metric)
    con, topology = rhs.con, rhs.topology
    qt = interop.to_tensor(q)
    coef = swop.sw_tangent_prep_plain(qt, con, topology)
    layout = swop.sw_tangent_layout(con)
    kf = len(swop.SW_TANGENT_FACE_ROWS)
    assert layout["size"] == coef.numel() == 3 * 6 * nel * nel * s * s + 2 * kf * 6 * nel * (nel + 1) * s
    flat = coef.numpy()
    rng = np.random.default_rng(0)

    # Node rows at single nodes: row r of node (p, ey, ex, j) at offset
    # r * 6 nel^2 s^2 + flat node index.
    nq = 6 * nel * nel * s * s
    for _ in range(8):
        p, ey, ex, j = rng.integers(6), rng.integers(nel), rng.integers(nel), rng.integers(s * s)
        node = ((p * nel + ey) * nel + ex) * s * s + j
        h, hu1, hu2 = q[:, p, ey, ex, j]
        assert [flat[node], flat[nq + node], flat[2 * nq + node]] == pytest.approx([h, hu1 / h, hu2 / h], rel=1e-15)

    # Face rows at single face points, through the apply kernel's indexing:
    # the element's own trace on its side (L for east/north faces, R for
    # west/south), the neighbour's face reading the same entry, the halo at
    # a panel edge.
    ee = con.ee.numpy()
    halo = swop.halo_from_traces(swop.edge_traces(qt, con), topology).numpy()
    nx = 6 * nel * (nel + 1) * s
    rows = lambda fam, idx: flat[layout[fam][0] + idx + nx * np.arange(kf)]
    trace = lambda p, ey, ex, side, k: q[:, p, ey, ex, :] @ ee[:, side * s + k]
    for side in range(4):
        for p, ey, ex, k in ((0, 0, 0, 0), (2, 1, 2, 1), (5, nel - 1, nel - 1, s - 1), (3, 2, 0, 2)):
            fam, idx = swop.sw_tangent_face_index(nel, s, side, p, ey, ex, k)
            c = rows(fam, idx)
            own_right = side in (0, 2)
            own = c[3:6] if own_right else c[0:3]
            np.testing.assert_allclose(own, trace(p, ey, ex, side, k), rtol=1e-14)
            nb = c[0:3] if own_right else c[3:6]
            at_edge = (ex == 0, ex == nel - 1, ey == 0, ey == nel - 1)[side]
            if at_edge:
                hside, along = ((2, ey), (3, ey), (0, ex), (1, ex))[side]
                np.testing.assert_allclose(nb, halo[:, hside, p, along, k], rtol=1e-14)
            else:
                nb_ey, nb_ex = (ey, ex - 1) if side == 0 else (ey, ex + 1) if side == 1 else \
                    (ey - 1, ex) if side == 2 else (ey + 1, ex)
                assert swop.sw_tangent_face_index(nel, s, side ^ 1, p, nb_ey, nb_ex, k) == (fam, idx)
                np.testing.assert_allclose(nb, trace(p, nb_ey, nb_ex, side ^ 1, k), rtol=1e-14)
            # The sound speeds, 1/(h a) and Mach numbers of the primal flux.
            mhd = (con.itf_x if side < 2 else con.itf_y)[1].numpy().reshape(-1)[idx % (nx // 6)]
            a_l, a_r = np.sqrt(GRAVITY * c[0] * mhd), np.sqrt(GRAVITY * c[3] * mhd)
            n = 1 if side < 2 else 2
            np.testing.assert_allclose(c[6:12], [a_l, a_r, 1 / (c[0] * a_l), 1 / (c[3] * a_r),
                                                 c[n] / (c[0] * a_l), c[3 + n] / (c[3] * a_r)], rtol=1e-14)
            np.testing.assert_allclose(c[12], 0.25 * ((c[10] + 1) ** 2 - (c[11] - 1) ** 2), rtol=1e-13, atol=1e-17)


def test_cpu_wrappers_count_plain_calls_and_no_launch():
    con, topology, states, v, _ = check.sw_tangent_inputs(3, 3, torch.float64, "cpu")
    q = states["case6"]
    counts = lambda: (swop.tangent_prep_launches, swop.tangent_apply_launches, swop.plain_calls,
                      swop.plain_tangent_calls)
    before = counts()
    coef = swop.sw_tangent_prep(q, con, topology)
    assert torch.equal(coef, swop.sw_tangent_prep_plain(q, con, topology))
    got = swop.sw_tangent_apply(coef, v, con, topology)
    assert torch.equal(got, swop.sw_tangent_apply_plain(coef, v, con, topology))
    assert counts() == (before[0], before[1], before[2] + 2, before[3] + 2)
    with pytest.raises(ValueError, match="coef shape"):
        swop.sw_tangent_apply(coef[:-1], v, con, topology)
    with pytest.raises(ValueError, match="topology"):
        swop.sw_tangent_prep(q, con, None)


def test_model_keeps_the_plain_tangent_on_the_cpu_and_counts_one_linearisation():
    nel, s = 3, 3
    geom, ops, metric, q0 = _setup(nel, s)
    q, v, _ = (interop.to_tensor(a) for a in _inputs(q0))
    rhs = interop.shallow_water_rhs(geom, ops, metric)
    assert rhs.jtv_prep(q) is q or torch.equal(rhs.jtv_prep(q), q)
    before = (matvec.linearisations, matvec.jacobian_actions, swop.plain_tangent_calls)
    mv = matvec.make_jvp_matvec(rhs, q, dt=2.0)
    out = [mv(v.reshape(-1)) for _ in range(3)]
    assert (matvec.linearisations, matvec.jacobian_actions, swop.plain_tangent_calls) == (
        before[0] + 1, before[1] + 3, before[2] + 3)
    want = 2.0 * swop.sw_tangent_plain(q, v, rhs.con, rhs.topology).reshape(-1)
    assert all(torch.equal(o, want) for o in out)
