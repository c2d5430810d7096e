"""The port's Krylov pieces (``wxfactory_tpu_torch.solvers``) against the
JAX package's, float64 on the CPU.

* ``kiops`` on a dense 60x60 matrix from a seed (a symmetric part with
  spectrum in [-50, 0] plus a skew part), against the JAX ``kiops`` on the
  same numpy inputs: identical statistics (Krylov steps, substeps,
  rejections, matrix exponentials, last Krylov size) and ``w`` within 1e-12
  of the larger of its max and the input's (the Krylov sum is formed at the
  input's scale). The adaptivity is integer-valued, so any change of the
  controller shows as a different count.
* ``global_norm``/``global_dotprod``/``global_inf_norm`` against the JAX
  ones (1e-14 relative).
* The Jacobian-action closures: ``make_jvp_matvec`` through the RHS's
  ``jtv_prep``/``jtv_apply``, and through ``torch.func.jvp`` of an RHS
  without them, against the JAX ``make_jvp_matvec`` on the XLA RHS (1e-11
  of scale, the tangent tests' bound); ``make_rat_matvec`` likewise;
  ``make_fd_matvec`` against the JAX one (1e-8 of scale: a finite
  difference at eps = 3.5e-4 amplifies the two RHSs' ~1e-13 round-off
  difference by 1/eps). Each closure counts its actions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wxfactory_tpu.models.euler_cubesphere import make_rhs_euler_cubesphere as j_make_rhs
from wxfactory_tpu.solvers import global_dotprod as j_dot
from wxfactory_tpu.solvers import global_inf_norm as j_inf
from wxfactory_tpu.solvers import global_norm as j_norm
from wxfactory_tpu.solvers import kiops as j_kiops
from wxfactory_tpu.solvers import make_fd_matvec as j_fd
from wxfactory_tpu.solvers import make_jvp_matvec as j_jvp
from wxfactory_tpu.solvers import make_rat_matvec as j_rat
from wxfactory_tpu.testcases.dcmip import dcmip_gravity_wave
from wxfactory_tpu_torch import interop
from wxfactory_tpu_torch import solvers
from wxfactory_tpu_torch.solvers import matvec as matvec_mod

torch.set_num_threads(1)


def _matrix(n=60, seed=0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = -50.0 * rng.random(n)
    skew = rng.standard_normal((n, n))
    return (q * lam) @ q.T + 2.0 * (skew - skew.T)


@pytest.mark.parametrize(
    "rows,tau_out,task1,tol",
    [(3, [0.5, 1.0], False, 1e-7), (1, [1.0], False, 1e-7), (4, [0.25, 0.5, 1.0], True, 1e-9)],
    ids=["3rows-2outputs", "1row", "4rows-3outputs-task1"],
)
def test_kiops_matches_jax(rows, tau_out, task1, tol):
    a = _matrix()
    u = np.random.default_rng(1).standard_normal((rows, a.shape[0]))
    want, jstats = j_kiops(tau_out, lambda v: a @ v, u, tol=tol, mmin=4, mmax=20, task1=task1)
    at = torch.as_tensor(a)
    matvecs = []

    def A(v):
        matvecs.append(1)
        return at @ v

    got, stats = solvers.kiops(tau_out, A, torch.as_tensor(u), tol=tol, mmin=4, mmax=20, task1=task1)
    assert stats.as_tuple()[:4] == jstats.as_tuple()[:4]  # substeps, rejected, krylov steps, expm
    assert stats.last_krylov_size == jstats.last_krylov_size
    assert len(matvecs) >= stats.krylov_steps and stats.krylov_steps > 0
    assert stats.error_estimate == pytest.approx(jstats.error_estimate, rel=1e-6)
    assert got.shape == want.shape and got.dtype == torch.float64
    # Relative to the larger of w's and u's max: w = beta * V^T F[:, 0] is
    # summed at the scale of the input (beta = |u|), and exp(tau A) damps
    # the 1-row case's output to ~1/30 of it.
    scale = max(np.abs(want).max(), np.abs(u).max())
    assert float(np.abs(got.numpy() - want).max()) < 1e-12 * scale


def test_global_ops_match_jax():
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal((5, 7, 9)), rng.standard_normal((5, 7, 9))
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    assert float(solvers.global_norm(ta)) == pytest.approx(float(j_norm(jnp.asarray(a))), rel=1e-14)
    assert float(solvers.global_dotprod(ta, tb)) == pytest.approx(float(j_dot(jnp.asarray(a), jnp.asarray(b))),
                                                                  rel=1e-13)
    assert float(solvers.global_inf_norm(ta)) == float(j_inf(jnp.asarray(a)))


@pytest.fixture(scope="module")
def dcmip31():
    """(geom, ops, topo, metric, q, v): a noisy dcmip31 state at 3x2x2 and a
    seeded direction."""
    from conftest import cs3d_setup

    geom, ops, topo, metric = cs3d_setup(3, 2, 2)
    q0 = dcmip_gravity_wave(geom)
    rng = np.random.default_rng(3)
    q = q0 * (1.0 + 1e-4 * rng.standard_normal(q0.shape))
    v = rng.standard_normal(q0.shape) * np.abs(q0).reshape(5, -1).max(axis=1).reshape(5, 1, 1, 1, 1, 1) * 1e-3
    v[3] = v[1]
    return geom, ops, topo, metric, q, v


def _err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("via", ["jtv", "torch.func.jvp"])
def test_jvp_matvec_matches_jax(dcmip31, via):
    geom, ops, topo, metric, q, v = dcmip31
    dt = 30.0
    want = np.asarray(j_jvp(j_make_rhs(geom, ops, metric, topo, interior="xla"), jnp.asarray(q), dt)(v.ravel()))
    rhs = interop.euler3d_rhs(geom, ops, metric)
    fn = rhs if via == "jtv" else (lambda x: rhs(x))  # a plain callable has no jtv_prep
    before = matvec_mod.jacobian_actions
    mv = solvers.make_jvp_matvec(fn, interop.to_tensor(q), dt)
    got = mv(interop.to_tensor(v).reshape(-1))
    assert matvec_mod.jacobian_actions == before + 1
    assert got.shape == (v.size,)
    assert _err(got.numpy(), want) < 1e-11


def test_rat_and_fd_matvecs_match_jax(dcmip31):
    geom, ops, topo, metric, q, v = dcmip31
    dt = 30.0
    jrhs = j_make_rhs(geom, ops, metric, topo, interior="xla")
    rhs = interop.euler3d_rhs(geom, ops, metric)
    qt, vt = interop.to_tensor(q), interop.to_tensor(v).reshape(-1)
    want = np.asarray(j_rat(jrhs, jnp.asarray(q), dt)(v.ravel()))
    assert _err(solvers.make_rat_matvec(rhs, qt, dt)(vt).numpy(), want) < 1e-11
    want = np.asarray(j_fd(jrhs, jnp.asarray(q), jrhs(jnp.asarray(q)), dt)(v.ravel()))
    assert _err(solvers.make_fd_matvec(rhs, qt, rhs(qt), dt)(vt).numpy(), want) < 1e-8
