"""The 2D Cartesian Euler model in the port against the JAX package, on the
CPU (float64 unless stated):

* ``make_cartesian_2d`` and the initial states of cases 1-4 bit for bit;
* the plain DFR RHS (``euler_cartesian_plain``) against the jitted JAX
  ``make_rhs_euler_cartesian`` at s = 2..5 on perturbed states of cases 2
  and 4 (1e-3 relative noise, winds of 2 and 1 m/s): within 1e-13 of each
  row's term scale (``kernels/check.py::euler_cartesian_term_scale``: the
  max of its x and z flux divergence terms, for rho*w also of gravity,
  since its RHS is the pressure gradient's residual against gravity), the
  stage form against a*x + b*y + cdt*RHS(y), float32 against the float64
  truth within twice the JAX float32 RHS's distance (or 1e-5 of scale);
* the hydrostatic state steady (the JAX package's
  tests/test_euler_cartesian.py::test_hydrostatic_state_is_steady bounds);
* the plain FV RHS against ``make_rhs_euler_cartesian_fv`` for each flux,
  within 1e-13 of each row's term scale, and the multigrid's FV level (ausm,
  the s = 1 view) on the density current's grid;
* both tangents (``torch.func.jvp`` of the plain RHS) against ``jax.jvp``
  of the JAX RHS within 1e-12 of each row's max, on the perturbed states
  and at rest, where every AUSM interface sits at m = 0 and every FV speed
  at 0 (maximum(0, m), minimum(0, m), rusanov's |v| and maximum, upwind's
  where(vsum > 0) at their ties);
* mass: the Gauss-Legendre weighted integrals of rho and rho*theta in each
  RHS zero to 1e-14 of their absolute integrals;
* the interop carry-over of the JAX state (no relayout) and the wrappers'
  refusals; the kernels' checks of ``kernels/check.py`` on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from wxfactory_tpu.geometry.cartesian import make_cartesian_2d as j_make_cartesian_2d
from wxfactory_tpu.models import make_rhs_euler_cartesian as j_make_rhs
from wxfactory_tpu.models.euler_cartesian_fv import make_rhs_euler_cartesian_fv as j_make_fv
from wxfactory_tpu.ops import make_dfr_operators as j_make_ops
from wxfactory_tpu.testcases import initialize_cartesian2d as j_initialize
from wxfactory_tpu_torch import interop
from wxfactory_tpu_torch.geometry import make_cartesian_2d
from wxfactory_tpu_torch.kernels import check
from wxfactory_tpu_torch.models import EulerCartesianFVRHS, EulerCartesianRHS
from wxfactory_tpu_torch.ops import euler_cartesian_operator as ecop
from wxfactory_tpu_torch.ops import make_dfr_operators
from wxfactory_tpu_torch.testcases import initialize_cartesian2d

DOMAINS = check.CARTESIAN_DOMAINS


def _geoms(case, nx, nz, s):
    (x0, x1), (z0, z1) = DOMAINS[case]
    return j_make_cartesian_2d((x0, x1), (z0, z1), nx, nz, s), make_cartesian_2d((x0, x1), (z0, z1), nx, nz, s)


def _state(case, nx, nz, s, seed=0):
    jgeom, geom = _geoms(case, nx, nz, s)
    q0 = initialize_cartesian2d(geom, case, check.CARTESIAN_THETA[case])
    rng = np.random.default_rng(seed)
    return jgeom, geom, q0, check.perturbed_cartesian(q0, rng), rng


def _scaled(got, want, scale):
    scale = np.asarray(scale).reshape((-1,) + (1,) * (np.ndim(want) - 1))
    return float((np.abs(np.asarray(got) - np.asarray(want)) / scale).max())


def _rows_max(a):
    a = np.asarray(a)
    return np.abs(a).reshape(a.shape[0], -1).max(axis=1)


@pytest.mark.parametrize("case", [1, 2, 3, 4])
def test_geometry_and_initial_states_bit_for_bit(case):
    jgeom, geom = _geoms(case, 5, 7, 3)
    for name in ("X1", "X3", "solution_points"):
        np.testing.assert_array_equal(getattr(geom, name), np.asarray(getattr(jgeom, name)))
    assert (geom.delta_x1, geom.delta_x3, geom.grid_shape) == (jgeom.delta_x1, jgeom.delta_x3, jgeom.grid_shape)
    theta = check.CARTESIAN_THETA[case]
    np.testing.assert_array_equal(initialize_cartesian2d(geom, case, theta, 200.0),
                                  np.asarray(j_initialize(jgeom, case, theta, 200.0)))
    np.testing.assert_array_equal(geom.to_single_block(geom.X1), jgeom.to_single_block(np.asarray(jgeom.X1)))


@pytest.mark.parametrize("s,case", [(2, 2), (3, 4), (4, 2), (4, 4), (5, 2)])
def test_rhs_matches_jax(s, case):
    jgeom, geom, _, y, rng = _state(case, 4, 3, s)
    want = np.asarray(jax.jit(j_make_rhs(jgeom, j_make_ops(s)))(jnp.asarray(y)))
    rhs = interop.euler_cartesian_rhs(geom, make_dfr_operators(s))
    qt = interop.to_tensor(y)
    got = rhs(qt).numpy()
    term = check.euler_cartesian_term_scale(qt, rhs.con).numpy()
    assert _scaled(got, want, term) < 1e-13
    assert max(check.cartesian_mass(torch.as_tensor(got), make_dfr_operators(s))) < 1e-14
    # The stage form: a*x + b*y + cdt*RHS(y), with and without x.
    x = y * (1.0 + 1e-3 * rng.standard_normal(y.shape))
    xt = torch.as_tensor(x)
    for a, b, c in ((0.0, 1.0, 1.0), (0.75, 0.25, 0.25), (1.0 / 3.0, 2.0 / 3.0, 2.0 / 3.0)):
        cdt = c * check.EC_DT
        out, traces = rhs.stage(xt, qt, a, b, cdt)
        assert traces is None
        np.testing.assert_allclose(out.numpy(), a * x + b * y + cdt * got, rtol=0, atol=1e-12 * np.abs(y).max())


@pytest.mark.parametrize("s", [3, 4])
def test_rhs_float32_against_jax_float32(s):
    jgeom, geom, _, y, _ = _state(2, 4, 3, s)
    y32 = y.astype(np.float32)
    truth = np.asarray(jax.jit(j_make_rhs(jgeom, j_make_ops(s)))(jnp.asarray(y32.astype(np.float64))))
    jax32 = np.asarray(jax.jit(j_make_rhs(jgeom, j_make_ops(s), dtype=jnp.float32))(jnp.asarray(y32)))
    rhs = EulerCartesianRHS(geom, make_dfr_operators(s), dtype=torch.float32, device="cpu")
    got = rhs(torch.as_tensor(y32)).double().numpy()
    term = check.euler_cartesian_term_scale(torch.as_tensor(y), rhs.con).numpy()
    err = np.abs(got - truth).reshape(4, -1).max(axis=1) / term
    jerr = np.abs(jax32 - truth).reshape(4, -1).max(axis=1) / term
    assert np.all(err <= np.maximum(2.0 * jerr, 1e-5)), (err, jerr)


def test_hydrostatic_state_is_steady():
    # The JAX package's test_hydrostatic_state_is_steady: case 2's base
    # state without its bubble (8 x 12 elements, s = 4).
    from wxfactory_tpu_torch.common.constants import CPD, CVD, GRAVITY, P0, RD

    geom = make_cartesian_2d((0, 1000), (0, 1500), 8, 12, 4)
    theta = 303.15
    exner = 1.0 - GRAVITY / (CPD * theta) * geom.X3
    rho = P0 / (RD * theta) * exner ** (CVD / RD)
    qh = np.zeros((4,) + geom.X3.shape)
    qh[0], qh[3] = rho, rho * theta
    r = EulerCartesianRHS(geom, make_dfr_operators(4), device="cpu")(torch.as_tensor(qh))
    assert float(r[0].abs().max()) == 0.0
    assert float(r[3].abs().max()) == 0.0
    assert float(r[1].abs().max()) < 1e-8
    assert float(r[2].abs().max()) < 1e-7


def _fv_term_scale(q, geom):
    """Each row's FV term scale: the max of its |F_x|/dx and |F_z|/dz, for
    rho*w also of gravity."""
    fx, fz = ecop.pointwise_fluxes(torch.as_tensor(q))
    term = np.maximum(_rows_max(fx) / geom.delta_x1, _rows_max(fz) / geom.delta_x3)
    term[2] = max(term[2], float((q[0] * 9.80616).max()))
    return term


@pytest.mark.parametrize("flux", ["ausm", "rusanov", "upwind"])
def test_fv_rhs_and_tangent_match_jax(flux):
    jgeom, geom = _geoms(2, 8, 12, 1)
    q0 = initialize_cartesian2d(geom, 2)[..., 0]
    rng = np.random.default_rng(3)
    y = check.perturbed_cartesian(q0, rng)
    v = check.cartesian_direction(y, rng)
    jrhs = jax.jit(j_make_fv(jgeom, flux))
    rhs = EulerCartesianFVRHS(geom, flux, device="cpu")
    got = rhs(torch.as_tensor(y)).numpy()
    want = np.asarray(jrhs(jnp.asarray(y)))
    assert _scaled(got, want, _fv_term_scale(y, geom)) < 1e-13
    assert max(check.cartesian_mass(torch.as_tensor(got), None)) < 1e-14
    # The trailing axis of 1 (the multigrid levels' view) is taken and given back.
    np.testing.assert_array_equal(rhs(torch.as_tensor(y[..., None])).numpy()[..., 0], got)
    for q in (y, q0):  # perturbed, and at rest: every speed at its tie
        jv = np.asarray(jax.jvp(jrhs, (jnp.asarray(q),), (jnp.asarray(v),))[1])
        tv = rhs.jtv(torch.as_tensor(q), torch.as_tensor(v)).numpy()
        assert _scaled(tv, jv, _rows_max(jv)) < 1e-12


@pytest.mark.parametrize("s,case", [(2, 4), (3, 2), (4, 2)])
def test_tangent_matches_jax_jvp(s, case):
    jgeom, geom, q0, y, rng = _state(case, 4, 3, s, seed=5)
    v = check.cartesian_direction(y, rng)
    jrhs = j_make_rhs(jgeom, j_make_ops(s))
    jvp = jax.jit(lambda a, b: jax.jvp(jrhs, (a,), (b,))[1])
    rhs = EulerCartesianRHS(geom, make_dfr_operators(s), device="cpu")
    for q in (y, q0):  # perturbed, and at rest: every AUSM interface at m = 0
        jv = np.asarray(jvp(jnp.asarray(q), jnp.asarray(v)))
        tv = rhs.jtv(torch.as_tensor(q), torch.as_tensor(v)).numpy()
        assert _scaled(tv, jv, _rows_max(jv)) < 1e-12


def test_tie_rules_match_jax():
    """The elementwise rules at the ties: the plain tangents' forms of
    maximum(0, m), minimum(0, m), |v| and maximum(a, b) against jax.jvp at
    and around each tie."""
    x = np.array([-1.0, 0.0, 1.0])
    t = np.array([1.0, 2.0, 3.0])
    xt, tt = torch.as_tensor(x), torch.as_tensor(t)
    pairs = [(ecop._max0, lambda m: jnp.maximum(0.0, m)), (ecop._min0, lambda m: jnp.minimum(0.0, m)),
             (ecop._abs_jax, jnp.abs)]
    for mine, theirs in pairs:
        np.testing.assert_array_equal(torch.func.jvp(mine, (xt,), (tt,))[1].numpy(),
                                      np.asarray(jax.jvp(theirs, (jnp.asarray(x),), (jnp.asarray(t),))[1]))
    got = torch.func.jvp(torch.maximum, (xt, torch.zeros(3, dtype=torch.float64)), (tt, 2 * tt))[1].numpy()
    want = np.asarray(jax.jvp(jnp.maximum, (jnp.asarray(x), jnp.zeros(3)), (jnp.asarray(t), 2 * jnp.asarray(t)))[1])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s", [2, 4])
def test_kernel_checks_on_cpu(s):
    """kernels/check.py's comparisons (what chip_smoke holds the kernels to)
    run on the CPU, where the wrappers take the plain versions: every mode
    agrees and holds mass."""
    rows = check.compare_euler_cartesian(4, 3, s, torch.float64, device="cpu", case=4)
    rows += check.compare_euler_cartesian_fv(6, 4, "rusanov", torch.float64, device="cpu")
    assert all(r["ok"] and r["err"] == 0.0 for r in rows), rows
    nbytes, ops = check.euler_cartesian_work(ecop.build_constants(*_geoms(2, 4, 3, s)[1:], make_dfr_operators(s)))
    assert nbytes == 4 * 3 * s * s * 4 * 2 * 8 and ops > 0


def test_interop_round_trip_and_refusals():
    jgeom, geom, q0, y, _ = _state(2, 3, 2, 3)
    qt = interop.to_tensor(jnp.asarray(y))
    assert tuple(qt.shape) == (4, 2, 3, 9)
    np.testing.assert_array_equal(interop.to_numpy(qt), y)
    rhs = EulerCartesianRHS(geom, make_dfr_operators(3), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        rhs(qt[..., :4].contiguous())
    with pytest.raises(ValueError, match="float32"):
        rhs(qt.float())
    with pytest.raises(ValueError, match="unknown FV flux"):
        EulerCartesianFVRHS(geom, "roe", device="cpu")
    # A DFR order the kernels do not take raises on the card, not on the CPU.
    con7 = ecop.build_constants(make_cartesian_2d((0, 1000), (0, 1500), 2, 2, 7), make_dfr_operators(7))
    with pytest.raises(ValueError, match="s = 2..6"):
        ecop._check_solpts(con7, "euler_cartesian")


def test_fv_level_matches_jax_on_the_density_current():
    """The FV model as the multigrid builds its coarse level (ausm, the
    levels' s = 1 view with a trailing axis of 1) on the cold density
    current's grid: the RHS and J.v against the JAX FV RHS and jax.jvp of
    it, on the initial state (a cold pool at rest, every speed at its tie)
    and a perturbed one."""
    jgeom, geom = _geoms(4, 16, 4, 1)
    q0 = initialize_cartesian2d(geom, 4, 300.0)[..., 0]
    rng = np.random.default_rng(11)
    y = check.perturbed_cartesian(q0, rng)
    v = check.cartesian_direction(y, rng)
    jrhs = jax.jit(j_make_fv(jgeom, "ausm"))
    rhs = EulerCartesianFVRHS(geom, "ausm", device="cpu")
    term = _fv_term_scale(y, geom)  # the state at rest has no rho or rho*theta flux
    for q in (q0, y):
        got = rhs(torch.as_tensor(q[..., None])).numpy()[..., 0]
        want = np.asarray(jrhs(jnp.asarray(q)))
        assert _scaled(got, want, term) < 1e-13
        jv = np.asarray(jax.jvp(jrhs, (jnp.asarray(q),), (jnp.asarray(v),))[1])
        tv = rhs.jtv(torch.as_tensor(q[..., None]), torch.as_tensor(v[..., None])).numpy()[..., 0]
        assert _scaled(tv, jv, _rows_max(jv)) < 1e-12


def test_profile_classes_the_cartesian_kernels():
    """The profiler's per-class readout counts the Cartesian kernels as the
    operator's and its tangent's."""
    from wxfactory_tpu_torch.profile import kernel_class

    for name, cls in (("void euler_cartesian_operator_kernel<double, 4>(...)", "rhs_kernel"),
                      ("void euler_cartesian_fv_kernel<double, 0>(...)", "rhs_kernel"),
                      ("void euler_cartesian_tangent_kernel<double, 4>(...)", "tangent_kernel"),
                      ("void euler_cartesian_fv_tangent_kernel<float, 1>(...)", "tangent_kernel")):
        assert kernel_class(name) == cls
