"""FGMRES preconditioned by the port's ``precondition/`` (lu, ilu, p-mg,
fv-mg) on the Williamson case-5 rational system (I - dt/2 J) x = dt f(q),
dt = 3600 s, against the JAX package's ``fgmres`` with the JAX
preconditioners, on the CPU (the levels' and the system's Jacobian action
the plain tangent there).

* Each preconditioner at nel = 4, s = 3 (lu and ilu at nel = 2, s = 2):
  the same iteration count as the JAX solve, and a true residual within
  the tolerance (or within 1 % of the solver's own report when it stops
  early).
* The device-resident ``fgmres_jit`` with p-mg (kiops smoother) converges
  to the tolerance in at most a quarter of the plain iterations.
* The JAX package's acceleration gate (tests/test_framework.py:270-317) at
  its own shape, nel = 10, s = 3, FGMRES(100): p-mg with the kiops smoother
  takes at most a quarter of the plain iterations, its residual within
  1.05 of the plain one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wxfactory_tpu.geometry import make_cubed_sphere_2d as j_geom
from wxfactory_tpu.geometry import make_metric_2d as j_metric
from wxfactory_tpu.models import make_rhs_shallow_water as j_make_rhs
from wxfactory_tpu.ops.dfr import make_dfr_operators as j_ops
from wxfactory_tpu.precondition import Factorization as JFactorization
from wxfactory_tpu.precondition import Multigrid as JMultigrid
from wxfactory_tpu.solvers import fgmres as j_fgmres
from wxfactory_tpu.testcases import williamson_case5 as j_case5
from wxfactory_tpu_torch import interop
from wxfactory_tpu_torch.geometry import make_cubed_sphere_2d
from wxfactory_tpu_torch.precondition import Factorization, Multigrid
from wxfactory_tpu_torch.solvers import fgmres, fgmres_jit, make_rat_matvec

torch.set_num_threads(1)


def _case5_system(nel, s, dt=3600.0):
    """(port A, port b, JAX apply_A, JAX b, j geom, port geom, q0) of the
    case-5 rational system (I - dt/2 J) x = dt f(q0)."""
    jg, ops = j_geom(nel, s), j_ops(s)
    metric = j_metric(jg)
    q0, topo = j_case5(jg, ops)
    jrhs = j_make_rhs(jg, ops, metric, topo=topo, interior="xla")
    trhs = interop.shallow_water_rhs(jg, ops, metric, topo=topo)
    q = jnp.asarray(q0)
    jvp = jax.jit(lambda v: jax.jvp(jrhs, (q,), (v,))[1])
    j_apply = lambda v: np.asarray(jnp.asarray(v).reshape(q.shape) - 0.5 * dt * jvp(jnp.asarray(v).reshape(q.shape))).ravel()
    qt = torch.as_tensor(q0)
    A = make_rat_matvec(trhs, qt, dt)
    return (A, trhs(qt).reshape(-1) * dt, j_apply, np.asarray(jrhs(q)).ravel() * dt, jg,
            make_cubed_sphere_2d(nel, s), q0, trhs)


PRECONDITIONERS = [
    ("p-mg", dict(kind="p-mg", num_levels=2, num_pre_smoothe=1, num_post_smoothe=1, pseudo_cfl=720.0,
                  smoother="kiops")),
    ("p-mg-erk3", dict(kind="p-mg", num_levels=2, num_pre_smoothe=2, num_post_smoothe=2, pseudo_cfl=3.0,
                       smoother="erk3")),
    ("fv-mg", dict(kind="fv-mg", num_levels=3, num_pre_smoothe=1, num_post_smoothe=1, pseudo_cfl=720.0,
                   smoother="kiops")),
]


@pytest.mark.parametrize("name,kw", PRECONDITIONERS + [("lu", None), ("ilu", None)])
def test_fgmres_preconditioned_matches_jax(name, kw):
    nel, s = (4, 3) if kw is not None else (2, 2)  # the dense Jacobian of lu and ilu: 288 columns
    A, b, j_apply, jb, jg, tg, q0, trhs = _case5_system(nel, s)
    if kw is None:
        jm = JFactorization(j_make_rhs(jg, j_ops(s), j_metric(jg), topo=j_case5(jg, j_ops(s))[1], interior="xla"),
                            name)
        tm = Factorization(trhs, name)
    else:
        jm, tm = JMultigrid.for_geometry(jg, **kw), Multigrid.for_geometry(tg, device="cpu", **kw)
    jm.prepare(3600.0, jnp.asarray(q0))
    tm.prepare(3600.0, torch.as_tensor(q0))
    _, jr, jnb, jit, _, _ = j_fgmres(j_apply, jb, tol=1e-7, restart=30, maxiter=2, preconditioner=jm)
    x, r, nb, it, _, _ = fgmres(A, b, tol=1e-7, restart=30, maxiter=2, preconditioner=tm)
    assert it == jit, (it, jit)
    true = float(torch.linalg.vector_norm(b - A(x)) / torch.linalg.vector_norm(b))
    assert true <= max(1e-7, 1.01 * r / nb)


def test_fgmres_jit_with_pmg_converges():
    A, b, _, _, _, tg, q0, _ = _case5_system(4, 3)
    mg = Multigrid.for_geometry(tg, device="cpu", **PRECONDITIONERS[0][1])
    mg.prepare(3600.0, torch.as_tensor(q0))
    x, info = fgmres_jit(A, b, tol=1e-7, restart=30, max_outer=3, preconditioner=mg)
    _, _, _, plain_it, _, _ = fgmres(A, b, tol=1e-7, restart=30, maxiter=3)
    assert info.converged and info.num_iter * 4 <= plain_it, (info.num_iter, plain_it)
    assert float(torch.linalg.vector_norm(b - A(x)) / torch.linalg.vector_norm(b)) < 1.01e-7


def test_pmg_kiops_accelerates_canonical_case5():
    """tests/test_framework.py:270-317's gate at its shape (nel = 10, s = 3,
    dt = 3600 s, FGMRES(100)): with p-mg and the kiops smoother at most a
    quarter of the plain iterations, the residual within 1.05 of the plain
    one."""
    A, b, _, _, _, tg, q0, _ = _case5_system(10, 3)
    _, r_plain, _, it_plain, _, _ = fgmres(A, b, tol=1e-7, restart=100, maxiter=3)
    mg = Multigrid.for_geometry(tg, device="cpu", **PRECONDITIONERS[0][1])
    mg.prepare(3600.0, torch.as_tensor(q0))
    _, r_mg, _, it_mg, _, _ = fgmres(A, b, tol=1e-7, restart=100, maxiter=3, preconditioner=mg)
    assert r_mg <= r_plain * 1.05, (r_mg, r_plain)
    assert it_mg * 4 <= it_plain, (it_mg, it_plain)
