"""The port's PMEX (``wxfactory_tpu_torch/solvers/pmex.py``) against the JAX
package's (``wxfactory_tpu/solvers/pmex.py``) on seeded non-symmetric
numpy operators, float64, on the CPU.

* p = 1, 2, 3 phi rows (and a single row, which pmex pads), ``tau_out``
  of one time, of several (the phantom outputs of substeps that pass
  them) and past 1 (the controller's tau > 1 constants): the same Krylov
  iterations, substeps, rejections, matrix exponentials and last Krylov
  size; every output row within 1e-12 of the JAX one's max. The summed
  error estimate within 1e-2 relative: each substep's estimate is the
  product of the cycle's last norm and a corner of the exponential, and
  that norm comes from the estimate sqrt(g - sum of squares), which
  cancels, so the two packages' roundings of the Gram block (numpy's and
  torch's summation orders) move it by up to ~4e-3 relative on these
  operators while the outputs agree to 1e-15.
* Small bases at tight tolerances force rejections and the step-halving
  order estimate: equal integer statistics again, but the accepted substep
  sizes follow the error estimates' last digits, so the two outputs are
  held to the exact result (the exponential of the augmented matrix),
  the port's distance within twice the JAX one's. ``task1`` divides by
  the output times.
* One host read an iteration (the Gram block), counted in ``host_syncs``.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

from wxfactory_tpu.solvers.pmex import pmex as j_pmex
from wxfactory_tpu_torch.common import device
from wxfactory_tpu_torch.solvers import pmex

torch.set_num_threads(1)

N = 200


def _operator(seed, shift, spread=0.0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((N, N)) / np.sqrt(N) + shift * np.eye(N) - np.diag(np.linspace(0.0, spread, N))


def _exact(A, u, tau):
    """phi_0(tau A) u_0 + sum_k tau^k phi_k(tau A) u_k, from the exponential
    of the augmented matrix [[A, (u_p .. u_1)], [0, shift]]."""
    p = u.shape[0] - 1
    aug = np.zeros((N + p, N + p))
    aug[:N, :N] = A
    aug[:N, N:] = u[1:][::-1].T
    aug[N:-1, N + 1:] = np.eye(p - 1)
    start = np.concatenate([u[0], np.eye(p)[-1]])
    return (scipy.linalg.expm(tau * aug) @ start)[:N]


def _compare(A, u, tau_out, exact=False, **kw):
    """The port's pmex against the JAX one: equal integer statistics, the
    error estimate within 1e-2 relative, and the outputs within 1e-12 of
    the JAX one's max; or, with ``exact`` (a controller whose substep sizes
    follow the error estimate's last digits), both within the same
    distance of the exact result, up to twice the JAX one's."""
    want, jstats = j_pmex(tau_out, lambda v: A @ v, u, **kw)
    At = torch.as_tensor(A)
    got, stats = pmex(tau_out, lambda v: At @ v, torch.as_tensor(u), **kw)
    jt, t = jstats.as_tuple(), stats.as_tuple()
    assert t[:4] + t[5:] == jt[:4] + jt[5:], (t, jt)
    assert np.isclose(t[4], jt[4], rtol=1e-2, atol=0.0), (t[4], jt[4])
    got = got.numpy()
    assert got.shape == want.shape
    scale = np.abs(want).max(axis=1, keepdims=True)
    if exact:
        ref = _exact(A, u, tau_out[-1])
        err = lambda w: float(np.abs(w[-1] - ref).max() / np.abs(ref).max())
        assert err(got) <= 2.0 * err(want) + 1e-14, (err(got), err(want))
    else:
        assert float((np.abs(got - want) / scale).max()) < 1e-12
    return stats


@pytest.mark.parametrize("tau_out", [[1.0], [0.3, 0.7, 1.0], [2.5]], ids=["1", "phantoms", "2.5"])
@pytest.mark.parametrize("p", [1, 2, 3])
def test_pmex_matches_jax(p, tau_out):
    rng = np.random.default_rng(10 + p)
    u = rng.standard_normal((p + 1, N))
    _compare(_operator(3, -2.0), u, tau_out, tol=1e-7, m_init=1, mmin=16, mmax=64)


def test_pmex_single_row_and_task1():
    rng = np.random.default_rng(5)
    u = rng.standard_normal((1, N))
    _compare(_operator(4, -1.0, 5.0), u, [0.5, 1.0], tol=1e-8, m_init=10, mmin=10, mmax=32, task1=True)


@pytest.mark.parametrize("shift,spread,tol,mmax,tau", [(-1.0, 10.0, 1e-7, 16, 1.0), (-3.0, 0.0, 1e-10, 12, 3.0)],
                         ids=["spread", "tight"])
def test_pmex_rejections_match_jax(shift, spread, tol, mmax, tau):
    # A small basis at a tight tolerance: rejected substeps, the
    # step-halving order estimate and the Krylov-size estimate drive the
    # controller.
    rng = np.random.default_rng(9)
    u = rng.standard_normal((3, N))
    stats = _compare(_operator(3, shift, spread), u, [tau], exact=True, tol=tol, m_init=4, mmin=4, mmax=mmax)
    assert stats.rejected > 0 and stats.substeps > 1


def test_pmex_reads_the_host_once_an_iteration():
    rng = np.random.default_rng(8)
    A = torch.as_tensor(_operator(3, -2.0))
    u = torch.as_tensor(rng.standard_normal((3, N)))
    before = device.host_syncs
    _, stats = pmex([1.0], lambda v: A @ v, u, tol=1e-7, m_init=1, mmin=16, mmax=64)
    reads = device.host_syncs - before
    # The Gram block each iteration, the start vector's norm each substep
    # and the input's scale once (an explicit norm only where the estimate
    # cancels, which these inputs do not reach).
    assert reads == stats.krylov_steps + stats.substeps + stats.rejected + 1, (reads, stats)
