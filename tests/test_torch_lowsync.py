"""The port's low-synchronization Krylov phi solvers
(``wxfactory_tpu_torch/solvers/lowsync.py``) against the JAX package's
(``wxfactory_tpu/solvers/lowsync.py``) on dense seeded matrices, on the CPU:
every named variant, the same numpy inputs, the shapes of
tests/test_solvers.py:140-215 (n = 120, three phi rows, tol 1e-10, mmin 10,
mmax 64), two output times (the phantom-output path).

* On a symmetric problem (-diag(0.5..25) plus a symmetric seeded
  perturbation) every variant agrees with the JAX one to 1e-12 of the
  result's max, with equal Krylov steps, substeps, rejections and matrix
  exponentials, and the port's counted host reads equal the JAX engine's
  ``NUM_REDUCTIONS`` difference (and the port's own), within each
  variant's budget of tests/test_solvers.py:178-202.
* On tests/test_solvers.py's own non-normal problem the same holds for
  every variant but the two single-pass norm-estimate ones, ``cwy_ne`` and
  ``icwy_ne``: there the Pythagorean estimate's loss of orthogonality
  amplifies the last-bit differences between numpy's and torch's Gram
  products (the JAX engine itself, fed the same operator through torch's
  matmul, moves from 5 rejections to 4), so those two are held to the exact
  phi combination at the JAX test's 1e-8 and to the reduction budget.
* The Arnoldi loop reads the host only through counted reads: under a
  dispatch mode that records the ops that make the host wait for the card,
  none runs but the copies of ``common.device.to_device`` (pinned memory,
  no wait on the card), and each counted read is one reduction.
"""

import importlib

import numpy as np
import pytest
import scipy.linalg
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import wxfactory_tpu.solvers as J
import wxfactory_tpu.solvers.lowsync as JL
import wxfactory_tpu_torch.solvers as P
import wxfactory_tpu_torch.solvers.lowsync as PL
from wxfactory_tpu_torch.common import device

torch.set_num_threads(1)

VARIANTS = ["pmex_1s", "pmex_ne1s", "cwy_1s", "cwy_ne", "cwy_ne1s", "icwy_1s", "icwy_ne", "icwy_ne1s",
            "icwy_neiop", "dcgs2", "kiops_nest"]
# Reductions an iteration (tests/test_solvers.py:178-182); pmex's are not
# the lowsync engine's to count.
BUDGET = {"dcgs2": 2}
TAU_OUT = [0.3, 1.0]


def _problem(symmetric: bool):
    n = 120
    rng = np.random.default_rng(11)
    g = rng.standard_normal((n, n))
    a = -np.diag(np.linspace(0.5, 25.0, n)) + (0.05 * (g + g.T) if symmetric else 0.1 * g)
    u = rng.standard_normal((3, n))
    return a, u


def _phi_exact(a, tau, u):
    """w = sum_k phi_k(tau A) u_k from one augmented expm
    (tests/test_solvers.py:24-40)."""
    ppo, n = u.shape
    p = ppo - 1
    aug = np.zeros((n + p, n + p))
    aug[:n, :n] = tau * a
    aug[:n, n] = tau * u[-1]
    for k in range(1, p):
        aug[:n, n + k] = tau * u[p - k]
        aug[n + k - 1, n + k] = tau
    big = scipy.linalg.expm(aug)
    e = np.zeros(n + p)
    e[n + p - 1] = 1.0
    return big[:n, :] @ e + big[:n, :n] @ u[0]


def _run_both(name, a, u):
    before = JL.NUM_REDUCTIONS
    want, jstats = getattr(J, name)(TAU_OUT, lambda v: a @ v, u, tol=1e-10, mmin=10, mmax=64)
    jused = JL.NUM_REDUCTIONS - before
    at = torch.as_tensor(a)
    before, syncs = PL.NUM_REDUCTIONS, device.host_syncs
    got, pstats = getattr(P, name)(TAU_OUT, lambda v: at @ v, torch.as_tensor(u), tol=1e-10, mmin=10, mmax=64)
    return want, jstats, jused, got.numpy(), pstats, PL.NUM_REDUCTIONS - before, device.host_syncs - syncs


@pytest.mark.parametrize("symmetric", [True, False], ids=["symmetric", "test_solvers_problem"])
@pytest.mark.parametrize("name", VARIANTS)
def test_variant_matches_jax(name, symmetric):
    a, u = _problem(symmetric)
    want, jstats, jused, got, pstats, pused, syncs = _run_both(name, a, u)
    assert got.shape == want.shape == (len(TAU_OUT), a.shape[0])
    if name.startswith("pmex"):
        # pmex_1s = pmex_ne1s = pmex in both packages (one read an iteration
        # of its own; the lowsync engine counts none).
        assert jused == pused == 0
    else:
        assert pused == syncs  # every counted host read is one reduction
        budget = BUDGET.get(name, 1) * pstats.krylov_steps + 2 * pstats.num_expm + 2
        assert 0 < pused <= budget, (pused, budget)
    if not symmetric and name in ("cwy_ne", "icwy_ne"):
        exact = np.stack([_phi_exact(a, t, u) for t in TAU_OUT])
        assert np.abs(got - exact).max() / np.abs(exact).max() < 1e-8
        return
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-12
    assert pstats.as_tuple()[:4] == jstats.as_tuple()[:4]
    assert pstats.last_krylov_size == jstats.last_krylov_size
    if not name.startswith("pmex"):
        assert pused == jused


class _HostTraffic(TorchDispatchMode):
    """Records the dispatched operators that, on a CUDA tensor, make the
    host wait for the card (tests/test_torch_kiops_jit.py's list): a device
    value read on the host (``.item()``, ``bool()``) or a host value copied
    to the card by a blocking copy."""

    OPS = ("aten._local_scalar_dense", "aten.is_nonzero", "aten.item", "aten.nonzero", "aten.lift_fresh",
           "aten.scalar_tensor")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(self.OPS):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ["icwy_1s", "cwy_ne1s", "icwy_neiop", "dcgs2", "pmex_1s"])
def test_no_uncounted_host_reads(name, monkeypatch):
    """The whole call dispatches no operator that would make the host wait
    for the card but the counted reads (``tolist`` and the copy to numpy,
    which dispatch none of these) and the coefficients' copies to the card,
    every one of which goes through ``common.device.to_device`` (pinned
    memory on the card, no wait): one tensor made from host data a call."""
    # The package's ``pmex`` attribute is the function: the module by name.
    pmex_module = importlib.import_module("wxfactory_tpu_torch.solvers.pmex")
    copies = []
    for module in (PL, pmex_module):
        def counted(a, like, _to_device=module.to_device):
            copies.append(1)
            return _to_device(a, like)

        monkeypatch.setattr(module, "to_device", counted)
    a, u = _problem(True)
    at, ut = torch.as_tensor(a), torch.as_tensor(u)
    syncs = device.host_syncs
    with _HostTraffic() as traffic:
        _, stats = getattr(P, name)(TAU_OUT, lambda v: at @ v, ut, tol=1e-10, mmin=10, mmax=64)
    assert traffic.seen == ["aten.lift_fresh.default"] * len(copies)
    assert device.host_syncs - syncs >= stats.krylov_steps > 0
