"""The port's SRERK (``integrators/srerk.py``) and the exponential solvers
that ``Epi`` gains with the low-synchronization family and EXODE, against
the JAX package on the CPU.

The same numpy states go through the JAX integrators (the XLA RHS,
``jax.jvp``) and the port's (the plain RHS, its Jacobian action the tangent
kernels' plain pair: ``kernels.check.PlainPair*``, the prep once a
linearisation point and the apply an action, as the card launches the
kernels), sharing the ``cs2d_setup`` / ``cs3d_setup`` caches without
mutating them:

* ``opt_nodes`` of orders 3-6 equal the JAX nodes;
* Srerk3 and Srerk6 with kiops and pmex on Williamson case 6 at nel = 2,
  s = 3, dt = 1800 s, one step: the same Krylov
  iterations, substeps and rejections, states within 1e-10 of each
  variable's max; one linearisation a step (``matvec.linearisations``)
  and a Jacobian action per Krylov matvec and remainder;
* Srerk3 + pmex on dcmip31 at 2x2x2, s = 2, dt = 30 s, one step, and EPI2 +
  ``icwy_1s`` there;
* EPI3 (``Epi(order=3)``: the Epi2 bootstrap step, then an EPI3 step with
  its history residual) with every exponential solver the port gains
  (``pmex_1s``, ``pmex_ne1s``, the ``cwy``/``icwy`` variants, ``dcgs2``,
  ``kiops_nest``, ``exode``) on case 6: equal statistics, 1e-10 of scale.
  One integrator of each package serves every solver name (the name and
  the warm starts reset between runs), so the JAX jvp compiles once;
* the pairs the JAX package cannot step fail as there: ``kiops_ne`` raises
  its ``ValueError`` at the step, Srerk + ``exode`` a ``TypeError`` (exode
  takes no ``tol``); Srerk + ``kiops_jit``, which the JAX Srerk calls with
  the node array as the matvec (a ``TypeError`` at its first step), is
  refused by the port at construction with a ``ValueError`` that says why.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wxfactory_tpu.integrators as JI
from wxfactory_tpu.models import make_rhs_euler_cubesphere
from wxfactory_tpu.models import make_rhs_shallow_water as j_make_sw
from wxfactory_tpu.testcases import dcmip_gravity_wave, williamson_case6
import wxfactory_tpu_torch.integrators as PI
from wxfactory_tpu_torch.kernels.check import PlainPairEuler3D, PlainPairShallowWater
from wxfactory_tpu_torch.solvers import matvec

torch.set_num_threads(1)

SW_DT, E3_DT, TOL = 1800.0, 30.0, 1e-7
NEW_SOLVERS = ["pmex_1s", "pmex_ne1s", "cwy_1s", "cwy_ne", "cwy_ne1s", "icwy_1s", "icwy_ne", "icwy_ne1s",
               "icwy_neiop", "dcgs2", "kiops_nest", "exode"]
# Each package's EXODE keeps a step-size warm start across calls.
J_EXODE = importlib.import_module("wxfactory_tpu.solvers.exode")
P_EXODE = importlib.import_module("wxfactory_tpu_torch.solvers.exode")


def _sw():
    from conftest import cs2d_setup

    geom, ops, _topo, metric = cs2d_setup(2, 3)
    return geom, ops, metric, np.asarray(williamson_case6(geom))


def _e3():
    from conftest import cs3d_setup

    geom, ops, topo, metric = cs3d_setup(2, 2, 2)
    return geom, ops, topo, metric, np.asarray(dcmip_gravity_wave(geom))


def _scaled_err(got, want):
    nvar = want.shape[0]
    scale = np.abs(want).reshape(nvar, -1).max(axis=1).reshape((nvar,) + (1,) * (want.ndim - 1))
    return float(np.abs((got - want) / scale).max())


def _info(integ):
    info = integ.solver_info or integ.init_method.solver_info  # a bootstrap step reports its Epi2's
    return info.total_num_it, info.num_substeps, info.num_rejected


def _steps(integ, q, dt, nsteps, to_state):
    stats = []
    for _ in range(nsteps):
        q = integ.step(q, dt)
        stats.append(_info(integ))
    return to_state(q), stats


def _reset(integ, solver):
    """A fresh run of ``integ`` with another exponential solver."""
    for i in (integ, getattr(integ, "init_method", None)):
        if i is not None:
            i.exponential_solver, i.krylov_size, i.solver_info = solver, 1, None
    if hasattr(integ, "previous_q"):
        integ.previous_q.clear()
        integ.previous_rhs.clear()
        integ.dt = 0.0
    J_EXODE._state["first_step"] = P_EXODE._state["first_step"] = None


def _pair(model, cls, **kw):
    if model == "sw":
        geom, ops, metric, q0 = _sw()
        jrhs, prhs = j_make_sw(geom, ops, metric), PlainPairShallowWater(geom, ops, metric, device="cpu")
    else:
        geom, ops, topo, metric, q0 = _e3()
        jrhs, prhs = make_rhs_euler_cubesphere(geom, ops, metric, topo), PlainPairEuler3D(geom, ops, metric, device="cpu")
    return getattr(JI, cls)(jrhs, **kw), getattr(PI, cls)(prhs, **kw), q0


@pytest.fixture(scope="module")
def srerk_pairs():
    return {order: _pair("sw", "Srerk", order=order, tolerance=TOL) for order in (3, 6)}


@pytest.fixture(scope="module")
def epi3_pair():
    return _pair("sw", "Epi", order=3, tolerance=TOL)


def _compare(jinteg, pinteg, q0, dt, nsteps, solver):
    _reset(jinteg, solver)
    want, want_stats = _steps(jinteg, jnp.asarray(q0), dt, nsteps, np.asarray)
    _reset(pinteg, solver)
    lin, actions = matvec.linearisations, matvec.jacobian_actions
    got, got_stats = _steps(pinteg, torch.as_tensor(q0), dt, nsteps, lambda t: t.numpy())
    assert got_stats == want_stats
    assert _scaled_err(got, want) < 1e-10
    return matvec.linearisations - lin, matvec.jacobian_actions - actions, got_stats


def test_opt_nodes_match_jax():
    for order in (3, 4, 5, 6):
        want, got = JI.opt_nodes(order), PI.opt_nodes(order)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("order", [3, 6])
@pytest.mark.parametrize("solver", ["kiops", "pmex"])
def test_srerk_case6_matches_jax(srerk_pairs, order, solver):
    jinteg, pinteg, q0 = srerk_pairs[order]
    lin, actions, stats = _compare(jinteg, pinteg, q0, SW_DT, 1, solver)
    # One linearisation a step serves the phi matvecs and the remainders:
    # at least a Jacobian action per Krylov iteration, plus one a remainder.
    assert lin == 1
    remainders = sum(len(c) for c in pinteg.c[:-1])
    assert actions >= stats[0][0] + remainders


def test_srerk3_pmex_dcmip31_matches_jax():
    jinteg, pinteg, q0 = _pair("e3", "Srerk", order=3, exponential_solver="pmex", tolerance=TOL)
    lin, _, _ = _compare(jinteg, pinteg, q0, E3_DT, 1, "pmex")
    assert lin == 1


def test_epi2_icwy_1s_dcmip31_matches_jax():
    jinteg, pinteg, q0 = _pair("e3", "Epi", order=2, exponential_solver="icwy_1s", tolerance=TOL)
    _compare(jinteg, pinteg, q0, E3_DT, 1, "icwy_1s")


@pytest.mark.parametrize("solver", NEW_SOLVERS)
def test_epi3_new_solvers_match_jax(epi3_pair, solver):
    jinteg, pinteg, q0 = epi3_pair
    lin, _, _ = _compare(jinteg, pinteg, q0, SW_DT, 2, solver)
    assert lin == 2  # the bootstrap Epi2 step's and the EPI3 step's


def test_unsteppable_pairs_fail_as_in_jax(epi3_pair, srerk_pairs):
    _, _, q0 = epi3_pair
    for integ, q in ((epi3_pair[0], jnp.asarray(q0)), (epi3_pair[1], torch.as_tensor(q0))):
        _reset(integ, "kiops_ne")
        with pytest.raises(ValueError, match="Unrecognized exponential solver kiops_ne"):
            integ.step(q, SW_DT)
    for integ, q in ((srerk_pairs[3][0], jnp.asarray(q0)), (srerk_pairs[3][1], torch.as_tensor(q0))):
        _reset(integ, "exode")
        with pytest.raises(TypeError, match="tol"):
            integ.step(q, SW_DT)
    geom, ops, metric, _ = _sw()
    with pytest.raises(TypeError):
        JI.Srerk(j_make_sw(geom, ops, metric), 3, exponential_solver="kiops_jit").step(jnp.asarray(q0), SW_DT)
    with pytest.raises(ValueError, match="kiops_jit"):
        PI.Srerk(PlainPairShallowWater(geom, ops, metric, device="cpu"), 3, exponential_solver="kiops_jit")
