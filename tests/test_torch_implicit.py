"""The port's implicit, hybrid and splitting integrators
(``integrators/implicit.py``, ``hybrid.py``, ``splitting.py``) and their
Newton-Krylov solver (``solvers/nonlin.py``) against the JAX package on the
CPU.

The same numpy states go through the JAX integrators (the XLA RHS,
``jax.jvp`` of the residual) and the port's (the plain RHS; the residual's
Jacobian action ``v/dt - c J_f(x).v`` from ``matvec.make_jvp_matvec``, J_f
the tangent kernels' plain pair, ``kernels.check.PlainPair*``: one prep a
Newton iteration and one apply an FGMRES matvec, as the card launches the
kernels), sharing the ``cs2d_setup`` / ``cs3d_setup`` caches without
mutating them:

* Williamson case 6 at nel = 2, s = 3, dt = 1800 s (the JAX package's
  Newton converges there in 3-4 iterations a step, SDIRK 8): one step of
  BackwardEuler, CrankNicolson, SdirkLstable and RosExp2, two of Bdf2 (its
  start-up step and a BDF2 step); dcmip31 at 2x2x2, s = 2, dt = 30 s: one
  BackwardEuler step (CrankNicolson's Newton path is the same code). Equal Newton (RosExp2: Krylov + FGMRES) iteration
  counts, states within 1e-10 of each variable's max, one linearisation a
  Newton iteration;
* Imex2 and PartRosExp2 on a user split of case 6 (the RHS halved between
  the explicit and the implicit part, as ``Simulation`` has no split RHS in
  either package): equal counts, 1e-10;
* Lie, Strang and OS22 splitting of two EPI2 integrators on the half RHS
  (tests/test_integrators.py:300-320), one step each: 1e-10;
* ``newton_krylov`` on the card needs a Jacobian-action factory: without
  one, a tensor off the CPU raises (``torch.func.jvp`` cannot pass through
  a kernel), and on the CPU the ``torch.func.jvp`` fallback solves a small
  nonlinear system as the JAX one does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wxfactory_tpu.integrators as JI
from wxfactory_tpu.models import make_rhs_euler_cubesphere
from wxfactory_tpu.models import make_rhs_shallow_water as j_make_sw
from wxfactory_tpu.solvers import newton_krylov as j_newton_krylov
from wxfactory_tpu.testcases import dcmip_gravity_wave, williamson_case6
import wxfactory_tpu_torch.integrators as PI
from wxfactory_tpu_torch.kernels.check import PlainPairEuler3D, PlainPairShallowWater
from wxfactory_tpu_torch.solvers import matvec, newton_krylov

torch.set_num_threads(1)

SW_DT, E3_DT, TOL = 1800.0, 30.0, 1e-7


def _sw():
    from conftest import cs2d_setup

    geom, ops, _topo, metric = cs2d_setup(2, 3)
    return (j_make_sw(geom, ops, metric), PlainPairShallowWater(geom, ops, metric, device="cpu"),
            np.asarray(williamson_case6(geom)))


def _e3():
    from conftest import cs3d_setup

    geom, ops, topo, metric = cs3d_setup(2, 2, 2)
    return (make_rhs_euler_cubesphere(geom, ops, metric, topo), PlainPairEuler3D(geom, ops, metric, device="cpu"),
            np.asarray(dcmip_gravity_wave(geom)))


def _scaled_err(got, want):
    nvar = want.shape[0]
    scale = np.abs(want).reshape(nvar, -1).max(axis=1).reshape((nvar,) + (1,) * (want.ndim - 1))
    return float(np.abs((got - want) / scale).max())


def _run(jinteg, pinteg, q0, dt, nsteps):
    q, want_it = jnp.asarray(q0), []
    for _ in range(nsteps):
        q = jinteg.step(q, dt)
        want_it.append(jinteg.solver_info.total_num_it)
    want = np.asarray(q)
    lin = matvec.linearisations
    qt, got_it = torch.as_tensor(q0), []
    for _ in range(nsteps):
        qt = pinteg.step(qt, dt)
        got_it.append(pinteg.solver_info.total_num_it)
    assert got_it == want_it
    assert _scaled_err(qt.numpy(), want) < 1e-10
    return got_it, matvec.linearisations - lin


@pytest.mark.parametrize("name,nsteps", [("BackwardEuler", 1), ("CrankNicolson", 1), ("Bdf2", 2),
                                         ("SdirkLstable", 1)])
def test_implicit_case6_matches_jax(name, nsteps):
    jrhs, prhs, q0 = _sw()
    its, lin = _run(getattr(JI, name)(jrhs, tolerance=TOL), getattr(PI, name)(prhs, tolerance=TOL), q0, SW_DT,
                    nsteps)
    # One linearisation a Newton iteration that solves: the last iteration of
    # each solve only checks its residual.
    solves = 2 if name == "SdirkLstable" else nsteps
    assert lin == sum(its) - solves


def test_rosexp2_case6_matches_jax():
    jrhs, prhs, q0 = _sw()
    _, lin = _run(JI.RosExp2(jrhs, jrhs, tolerance=TOL, restart=20), PI.RosExp2(prhs, prhs, tolerance=TOL, restart=20),
                  q0, SW_DT, 1)
    assert lin == 1  # the full and the implicit part share one linearisation


def test_backward_euler_dcmip31_matches_jax():
    jrhs, prhs, q0 = _e3()
    its, lin = _run(JI.BackwardEuler(jrhs, tolerance=TOL), PI.BackwardEuler(prhs, tolerance=TOL), q0, E3_DT, 1)
    assert lin == its[0] - 1


class _Half:
    """Half the port's RHS, with half its Jacobian action (a user split)."""

    def __init__(self, rhs):
        self.rhs = rhs

    def __call__(self, q):
        return 0.5 * self.rhs(q)

    def jtv_prep(self, q):
        return self.rhs.jtv_prep(q)

    def jtv_apply(self, prep, v):
        return 0.5 * self.rhs.jtv_apply(prep, v)


@pytest.mark.parametrize("name", ["Imex2", "PartRosExp2"])
def test_partitioned_hybrids_match_jax(name):
    jrhs, prhs, q0 = _sw()
    jhalf, phalf = (lambda q: 0.5 * jrhs(q)), _Half(prhs)
    args = (jhalf, jhalf) if name == "Imex2" else (jrhs, jhalf)
    pargs = (phalf, phalf) if name == "Imex2" else (prhs, phalf)
    _run(getattr(JI, name)(*args, tolerance=TOL), getattr(PI, name)(*pargs, tolerance=TOL), q0, SW_DT, 1)


@pytest.fixture(scope="module")
def half_epi2():
    """Two EPI2 integrators on the half RHS in each package (one pair for
    every splitting: the JAX jvp compiles once; the Krylov-size warm
    starts follow the same sequence in both packages)."""
    jrhs, prhs, q0 = _sw()
    jepi = [JI.Epi(lambda q: 0.5 * jrhs(q), 2, tolerance=TOL) for _ in range(2)]
    return jepi, [PI.Epi(_Half(prhs), 2, tolerance=TOL) for _ in range(2)], q0


@pytest.mark.parametrize("name", ["LieSplitting", "StrangSplitting", "OS22Splitting"])
def test_splitting_matches_jax(name, half_epi2):
    (j1, j2), (p1, p2), q0 = half_epi2
    extra = (0.8,) if name == "OS22Splitting" else ()
    want = np.asarray(getattr(JI, name)(j1, j2, *extra).step(jnp.asarray(q0), SW_DT))
    got = getattr(PI, name)(p1, p2, *extra).step(torch.as_tensor(q0), SW_DT).numpy()
    assert _scaled_err(got, want) < 1e-10


def test_newton_krylov_jacobian_rules():
    """A small nonlinear system, F(x) = A x + x^3/10 - b: the port's CPU
    fallback (torch.func.jvp) and an explicit factory give the JAX
    solver's iterations and root; a CUDA-like tensor without a factory is
    refused before any work."""
    rng = np.random.default_rng(5)
    n = 40
    a = np.eye(n) * 3.0 + rng.standard_normal((n, n)) / np.sqrt(n)
    b = rng.standard_normal(n)
    x0 = np.zeros(n)
    want, want_it, _ = j_newton_krylov(lambda x: jnp.asarray(a) @ x + x**3 / 10 - jnp.asarray(b), x0, f_tol=1e-12)
    at, bt = torch.as_tensor(a), torch.as_tensor(b)
    F = lambda x: at @ x + x**3 / 10 - bt
    got, got_it, res = newton_krylov(F, torch.as_tensor(x0), f_tol=1e-12)
    assert got_it == want_it and res[-1][0] <= 1e-12
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-13)
    jac = lambda x: (lambda v: at @ v + 0.3 * x**2 * v)
    got2, it2, _ = newton_krylov(F, torch.as_tensor(x0), jac=jac, f_tol=1e-12)
    assert it2 == want_it
    np.testing.assert_allclose(got2.numpy(), np.asarray(want), rtol=0, atol=1e-13)
    meta = torch.zeros(n, dtype=torch.float64, device="meta")
    with pytest.raises(NotImplementedError, match="jac"):
        newton_krylov(F, meta)
