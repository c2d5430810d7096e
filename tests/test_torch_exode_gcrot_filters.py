"""The port's EXODE and its embedded-RK engine (``solvers/exode.py``,
``solvers/erk.py``), GCROT (``solvers/gcrot.py``, and Ros2 with
``linear_solver = gcrot``), the exponential modal filter
(``ops/filters.py``) and the integrator/solver dispatch of ``Simulation``
against the JAX package, on the CPU:

* every tableau of ``erk.get_tableau`` equal to the JAX one bit for bit
  (the Feagin tables read from the port's own ``solvers/data_feagin.npz``,
  equal to the JAX package's file); ``erk_integrate`` with every method and
  every controller family on the dense problems of
  tests/test_solvers.py:425-500 (the logistic ODE, a stiff linear system, a
  rejected first step): the same accepted and failed steps and function
  evaluations, results within 1e-12 relative;
* ``exode`` on the dense problem of tests/test_solvers.py:505-516 (n = 80,
  three phi rows; rtol 1e-8, atol 1e-10) with BS3(2), DP5(4) and DP8(7),
  twice each (the second call from the step-size warm start): within 1e-12
  relative, the same evaluations and steps;
* ``gcrot`` on the systems of tests/test_solvers.py:519-578 (plain, small
  restart with recycling, Jacobi-preconditioned, from a close initial
  guess, zero right side): within 1e-12 relative of the JAX solution, the
  same matvecs, flag and residual history length (the port
  orthogonalizes with two batched classical Gram-Schmidt passes where the
  JAX loop projects one vector at a time: the same algorithm to rounding);
  one Ros2 + gcrot step on Williamson case 6 at nel = 2, s = 3, dt = 1800 s
  (the port's Jacobian action the tangent kernels' plain pair,
  ``kernels.check.PlainPairShallowWater``) with the JAX ``Ros2``'s
  iterations, within 1e-10 of scale;
* ``make_apply_filters`` on a case-6 state (nel = 2, s = 3) and a dcmip31
  state (2x2x2, s = 2): the filter matrices bit for bit, the filtered
  states within 1e-13 of scale; a shallow-water TVD-RK3 step with the
  filter through each ``Simulation`` within 1e-13; ``filter_apply`` alone builds no filter in
  either package;
* every ``time_integrator`` the JAX ``Simulation`` dispatches, every
  ``exponential_solver`` and ``linear_solver`` of the JAX schema: each
  constructs in both packages or raises the same exception type in both;
  ``kiops_ne`` (the schema lists it, neither ``solvers`` exports it) and
  Srerk + ``exode`` fail at the first step with the same exception type in
  both. The one difference: Srerk + ``kiops_jit``, which the JAX package
  constructs and then fails at its first step with a ``TypeError`` (its
  Srerk passes the node array as kiops_jit's matvec), the port refuses at
  construction with a ``ValueError`` that says why.
"""

import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wxfactory_tpu.integrators as JI
from wxfactory_tpu.config import Configuration as JConfiguration
from wxfactory_tpu.config.schema import EXP_SOLVERS, SCHEMA
from wxfactory_tpu.models import make_rhs_shallow_water as j_make_sw
from wxfactory_tpu.ops import filters as j_filters
from wxfactory_tpu.simulation import Simulation as JSimulation
from wxfactory_tpu.solvers import erk as j_erk
from wxfactory_tpu.solvers import exode as j_exode
from wxfactory_tpu.solvers import gcrot as j_gcrot
from wxfactory_tpu.testcases import williamson_case6
import wxfactory_tpu_torch.integrators as PI
from wxfactory_tpu_torch.kernels.check import PlainPairShallowWater
from wxfactory_tpu_torch.config import Configuration
from wxfactory_tpu_torch.ops import filters
from wxfactory_tpu_torch.simulation import Simulation
from wxfactory_tpu_torch.solvers import erk, exode, gcrot

torch.set_num_threads(1)

J_EXODE = importlib.import_module("wxfactory_tpu.solvers.exode")
P_EXODE = importlib.import_module("wxfactory_tpu_torch.solvers.exode")
METHODS = ["BS3(2)", "DP5(4)", "M4(3)", "KC3(2)", "EXLRK3(2)", "EXLRK4(3)", "DP8(7)", "F10(8)", "F14(12)"]
CONTROLLERS = ["deadbeat", "PI3040", "PI4020", "H211PI", "H110", "H211D", "H211B"]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _same_erk(jres, pres):
    assert (pres.status, pres.nfev, pres.num_steps, pres.failed_steps) == (
        jres.status, jres.nfev, jres.num_steps, jres.failed_steps)
    assert _rel(pres.y.numpy(), jres.y) < 1e-12
    assert pres.h_mean == pytest.approx(jres.h_mean, rel=1e-12)
    assert pres.error_estimation == pytest.approx(jres.error_estimation, rel=1e-9, abs=1e-300)


@pytest.mark.parametrize("method", METHODS)
def test_tableaux_and_logistic_ode_match_jax(method):
    want, got = j_erk.get_tableau(method), erk.get_tableau(method)
    for field in ("A", "B", "C", "E", "E3"):
        w, g = getattr(want, field), getattr(got, field)
        assert (w is None and g is None) or np.array_equal(w, g), field
    assert (got.order, got.error_estimator_order, got.fsal) == (want.order, want.error_estimator_order, want.fsal)
    assert erk.limiter(1.7) == j_erk.limiter(1.7)
    kw = dict(method=method, rtol=1e-9, atol=1e-11, first_step=0.1)
    jres = j_erk.erk_integrate(lambda t, y: y * (1 - y), 0.0, np.array([0.1]), 4.0, **kw)
    pres = erk.erk_integrate(lambda t, y: y * (1 - y), 0.0, torch.tensor([0.1], dtype=torch.float64), 4.0, **kw)
    _same_erk(jres, pres)


def test_feagin_data_is_the_jax_packages():
    import os

    want = np.load(os.path.join(os.path.dirname(j_erk.__file__), "data_feagin.npz"))
    got = np.load(os.path.join(os.path.dirname(erk.__file__), "data_feagin.npz"))
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("controller", CONTROLLERS + ["rejection"])
def test_controllers_match_jax(controller):
    if controller == "rejection":
        # A deliberately huge first step, rejected and recovered from.
        a, y0 = -50.0 * np.eye(4), np.ones(4)
        kw = dict(method="BS3(2)", rtol=1e-8, atol=1e-10, first_step=1.0)
    else:
        a, y0 = -np.diag(np.linspace(0.5, 30.0, 40)), np.ones(40)
        kw = dict(method="DP5(4)", controller=controller, rtol=1e-8, atol=1e-10, first_step=0.05)
    at = torch.as_tensor(a)
    jres = j_erk.erk_integrate(lambda t, y: a @ y, 0.0, y0, 1.0, **kw)
    pres = erk.erk_integrate(lambda t, y: at @ y, 0.0, torch.as_tensor(y0), 1.0, **kw)
    _same_erk(jres, pres)
    assert controller != "rejection" or pres.failed_steps > 0


@pytest.mark.parametrize("method", ["BS3(2)", "DP5(4)", "DP8(7)"])
def test_exode_matches_jax(method):
    n = 80
    rng = np.random.default_rng(5)
    a = -np.diag(np.linspace(0.2, 5.0, n))
    u = rng.standard_normal((3, n))
    at, ut = torch.as_tensor(a), torch.as_tensor(u)
    J_EXODE._state["first_step"] = P_EXODE._state["first_step"] = None
    for _ in range(2):  # the second call starts from the warm step size
        want, jstats = j_exode(1.0, lambda v: a @ v, u, method=method, rtol=1e-8, atol=1e-10)
        got, pstats = exode(1.0, lambda v: at @ v, ut, method=method, rtol=1e-8, atol=1e-10)
        assert got.shape == want.shape == (1, n)
        assert _rel(got.numpy(), want) < 1e-12
        assert pstats.as_tuple()[:4] == jstats.as_tuple()[:4]
        assert P_EXODE._state["first_step"] == pytest.approx(J_EXODE._state["first_step"], rel=1e-12)


def _system(n, seed, diag_shift=2.0):
    """tests/test_solvers.py:13-20."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) / np.sqrt(n) + diag_shift * np.eye(n)
    return a, rng.standard_normal(n)


@pytest.mark.parametrize("case", ["direct", "recycling", "preconditioned", "initial_guess", "zero_rhs"])
def test_gcrot_matches_jax(case):
    n, seed, shift, kw = {"direct": (150, 3, 2.0, dict(tol=1e-10)),
                          "recycling": (300, 5, 1.2, dict(tol=1e-8, restart=10)),
                          "preconditioned": (120, 7, 2.0, dict(tol=1e-9)),
                          "initial_guess": (80, 11, 2.0, dict(tol=1e-6)),
                          "zero_rhs": (30, 1, 2.0, {})}[case]
    a, b = _system(n, seed, shift)
    if case == "zero_rhs":
        b = np.zeros(n)
    at, bt = torch.as_tensor(a), torch.as_tensor(b)
    jkw, pkw = dict(kw), dict(kw)
    if case == "preconditioned":
        d = 1.0 / np.diag(a)
        dt_ = torch.as_tensor(d)
        jkw["preconditioner"], pkw["preconditioner"] = (lambda v: d * v), (lambda v: dt_ * v)
    if case == "initial_guess":
        x0 = np.linalg.solve(a, b) + 1e-8
        jkw["x0"], pkw["x0"] = x0, torch.as_tensor(x0)
    want = j_gcrot(lambda v: a @ v, b, **jkw)
    got = gcrot(lambda v: at @ v, bt, **pkw)
    assert got[3:5] == want[3:5]  # matvecs, flag
    assert len(got[5]) == len(want[5])
    if case == "zero_rhs":
        assert got[2] == want[2] == 0.0 and not got[0].any()
        return
    assert got[2] == pytest.approx(want[2], rel=1e-14)
    assert _rel(got[0].numpy(), want[0]) < 1e-12
    assert got[1] <= kw["tol"] * got[2] and want[1] <= kw["tol"] * want[2]


def _case6():
    from conftest import cs2d_setup

    geom, ops, _topo, metric = cs2d_setup(2, 3)
    return geom, ops, metric, np.asarray(williamson_case6(geom))


def test_ros2_gcrot_case6_matches_jax():
    geom, ops, metric, q0 = _case6()
    jinteg = JI.Ros2(j_make_sw(geom, ops, metric), tolerance=1e-7, gmres_restart=20, linear_solver="gcrot")
    pinteg = PI.Ros2(PlainPairShallowWater(geom, ops, metric, device="cpu"), tolerance=1e-7, gmres_restart=20,
                     linear_solver="gcrot")
    want = np.asarray(jinteg.step(jnp.asarray(q0), 1800.0))
    got = pinteg.step(torch.as_tensor(q0), 1800.0).numpy()
    assert pinteg.solver_info.total_num_it == jinteg.solver_info.total_num_it > 0
    assert pinteg.solver_info.converged and jinteg.solver_info.converged
    scale = np.abs(want).reshape(3, -1).max(axis=1).reshape(3, 1, 1, 1, 1)
    assert float(np.abs((got - want) / scale).max()) < 1e-10


SW_INI = """
[General]
equations = shallow_water
[System]
distribute = off
[Test_case]
case_number = 6
[Time_integration]
dt = {dt}
t_end = {dt}
time_integrator = {ti}
exponential_solver = {es}
linear_solver = {ls}
tolerance = 1e-7
[Spatial_discretization]
num_solpts = {s}
num_elements_horizontal = 2
{filters}
[Grid]
grid_type = cubed_sphere
[Output_options]
save_state_freq = 0
stat_freq = 0
output_dir = {out}
"""
E3_INI = """
[General]
equations = euler
[System]
distribute = off
[Test_case]
case_number = 31
[Time_integration]
dt = 2
t_end = 2
time_integrator = tvdrk3
[Spatial_discretization]
num_solpts = 2
num_elements_horizontal = 2
num_elements_vertical = 2
{filters}
[Grid]
grid_type = cubed_sphere
ztop = 10000
[Output_options]
save_state_freq = 0
output_dir = {out}
"""
EXPFILTER = "expfilter_apply = 1\nexpfilter_order = 8\nexpfilter_cutoff = 0.25\nexpfilter_strength = 36"


def _sims(text):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JSimulation(JConfiguration(text)), Simulation(Configuration(text), device="cpu")


@pytest.mark.parametrize("model", ["shallow_water", "euler"])
def test_expfilter_matches_jax(tmp_path, model):
    if model == "euler":
        text = E3_INI.format(filters=EXPFILTER, out=tmp_path)
        want_f, got_f = j_filters.make_expfilter_3d(2, 36.0, 8, 0.25), filters.make_expfilter_3d(2, 36.0, 8, 0.25)
    else:
        text = SW_INI.format(dt=300, ti="tvdrk3", es="pmex", ls="auto", s=3, filters=EXPFILTER, out=tmp_path)
        want_f, got_f = j_filters.make_expfilter_2d(3, 36.0, 8, 0.25), filters.make_expfilter_2d(3, 36.0, 8, 0.25)
    assert np.array_equal(got_f, want_f) and not np.allclose(got_f, np.eye(len(got_f)))
    jsim, sim = _sims(text)
    assert sim._chunk_len(0, 0.0) == 1  # a filter runs after every step: no chunks
    q0 = np.asarray(jsim.initial_q)
    nvar = q0.shape[0]
    # Seeded noise (1e-3 of each variable's max, of 1 for a variable at
    # rest): modes for the filter to damp.
    scale = np.abs(q0).reshape(nvar, -1).max(axis=1).reshape((nvar,) + (1,) * (q0.ndim - 1))
    scale = np.where(scale > 0, scale, 1.0)
    q = q0 + 1e-3 * scale * np.random.default_rng(3).standard_normal(q0.shape)
    want = np.asarray(jsim.apply_filters(jnp.asarray(q), 1.0))
    got = sim.apply_filters(torch.as_tensor(q), 1.0).numpy()
    assert float(np.abs((got - want) / scale).max()) < 1e-13
    assert float(np.abs((got - q) / scale).max()) > 1e-6  # the filter did act
    if model == "shallow_water":
        want, _ = jsim.step(jnp.asarray(q), 1, 0.0)
        got, _ = sim.step(torch.as_tensor(q), 1, 0.0)
        assert float(np.abs((got.numpy() - np.asarray(want)) / scale).max()) < 1e-13


def test_filter_apply_alone_has_no_effect(tmp_path):
    text = SW_INI.format(dt=300, ti="tvdrk3", es="pmex", ls="auto", s=2, filters="filter_apply = 1", out=tmp_path)
    jsim, sim = _sims(text)
    assert jsim.apply_filters is None and sim.apply_filters is None


INTEGRATORS = ["euler1", "tvdrk3", "epi2", "epi3", "epi6", "epi7", "epi_stiff3", "epi_stiff2", "srerk3", "srerk6",
               "srerk2", "ros2", "rosexp2", "sdirk", "imex2", "partrosexp2", "strang_epi2_ros2", "crank_nicolson",
               "bdf2", "backward_euler", "leapfrog"]
LINEAR_SOLVERS = next(f for f in SCHEMA if f.name == "linear_solver").choices


def _outcome(make):
    try:
        return make()
    except Exception as e:  # the exception type is what is compared
        return type(e)


def _both(tmp_path, **kw):
    fields = dict(dt=1800, ti="epi2", es="pmex", ls="auto", s=2, filters="", out=tmp_path)
    fields.update(kw)
    text = SW_INI.format(**fields)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (_outcome(lambda: JSimulation(JConfiguration(text))),
                _outcome(lambda: Simulation(Configuration(text), device="cpu")))


@pytest.mark.parametrize("kind", ["time_integrator", "exponential_solver", "linear_solver"])
def test_simulation_dispatch_matches_jax(tmp_path, kind):
    key, names = {"time_integrator": ("ti", INTEGRATORS), "exponential_solver": ("es", EXP_SOLVERS),
                  "linear_solver": ("ls", LINEAR_SOLVERS)}[kind]
    extra = {"ti": "ros2"} if kind == "linear_solver" else {}
    for name in names:
        jsim, sim = _both(tmp_path, **{key: name, **extra})
        outcome = lambda s: s if isinstance(s, type) else "constructs"
        assert outcome(sim) == outcome(jsim), (name, outcome(jsim), outcome(sim))
        if name == "kiops_ne":
            # Both construct and raise the JAX package's ValueError at the step.
            for s in (jsim, sim):
                with pytest.raises(ValueError, match="Unrecognized exponential solver"):
                    s.step(s.initial_q, 1, 0.0)


def test_srerk_solver_pairs(tmp_path):
    jsim, sim = _both(tmp_path, ti="srerk3", es="exode")
    for s in (jsim, sim):
        with pytest.raises(TypeError):
            s.step(s.initial_q, 1, 0.0)
    jsim, sim = _both(tmp_path, ti="srerk3", es="kiops_jit")
    assert not isinstance(jsim, type) and sim is ValueError
    with pytest.raises(TypeError):
        jsim.step(jsim.initial_q, 1, 0.0)
    with pytest.raises(ValueError, match="kiops_jit"):
        Simulation(Configuration(SW_INI.format(dt=1800, ti="srerk3", es="kiops_jit", ls="auto", s=2, filters="",
                                               out=tmp_path)), device="cpu")
