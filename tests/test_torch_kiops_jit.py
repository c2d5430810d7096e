"""The port's device-resident KIOPS (``wxfactory_tpu_torch.solvers.kiops_jit``)
against the JAX package's ``kiops_jit`` on the same numpy matrices (the
cases of tests/test_solvers.py:223-300): identical Krylov iterations,
substeps, rejections and last Krylov size, results within 1e-12 of the JAX
result's max; with IOP-2, identical statistics to the port's own host
``kiops``; ``one_sync`` and ``full_ortho`` reproduce the exact phi
combination to 1e-8; a float32 basis (the mixed-precision operating point)
stays within float32 accuracy. The host reads one packed tensor per
control, counted in ``host_syncs``, and nothing else: no operator that
reads a device value on the host or copies a host value to the device is
dispatched in a call."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_solvers import _phi_exact
from torch.utils._python_dispatch import TorchDispatchMode

from wxfactory_tpu.solvers import kiops_jit as j_kiops_jit
from wxfactory_tpu_torch.common import device
from wxfactory_tpu_torch.solvers import kiops
from wxfactory_tpu_torch.solvers.kiops_jit import _expm_taylor, kiops_jit

torch.set_num_threads(1)


def _problem(seed, n, lo, hi, noise, rows):
    rng = np.random.default_rng(seed)
    a = -np.diag(np.linspace(lo, hi, n)) + noise * rng.standard_normal((n, n))
    return a, rng.standard_normal((rows, n))


def _both(a, u, **kw):
    aj, at = jnp.asarray(a), torch.as_tensor(a)
    w_j, st_j = jax.jit(lambda uu: j_kiops_jit(lambda v: aj @ v, uu, **kw))(jnp.asarray(u))
    w, st = kiops_jit(lambda v: at @ v, torch.as_tensor(u), **kw)
    want = tuple(int(x) for x in (st_j.krylov_steps, st_j.substeps, st_j.rejected, st_j.last_krylov_size))
    return np.asarray(w_j), want, w.numpy(), st


def _stats(st):
    return st.krylov_steps, st.substeps, st.rejected, st.last_krylov_size


@pytest.mark.parametrize("p", [0, 1, 3])
def test_matches_jax_kiops_jit_host_kiops_and_exact_phi(p):
    a, u = _problem(7, 120, 0.5, 30.0, 0.1, p + 1)
    w_j, want, w, st = _both(a, u, tol=1e-10, mmin=10, mmax=64)
    assert _stats(st) == want
    assert np.abs(w - w_j).max() / np.abs(w_j).max() < 1e-12
    w_host, st_host = kiops([1.0], lambda v: torch.as_tensor(a) @ v, torch.as_tensor(u), tol=1e-10, mmin=10,
                            mmax=64)
    assert _stats(st) == (st_host.krylov_steps, st_host.substeps, st_host.rejected, st_host.last_krylov_size)
    assert np.abs(w - w_host[0].numpy()).max() / np.abs(w).max() < 1e-12
    exact = _phi_exact(a, 1.0, u.copy())
    assert np.linalg.norm(w - exact) / np.linalg.norm(exact) < 1e-8


@pytest.mark.parametrize("one_sync", [False, True], ids=["two-sync", "one-sync"])
@pytest.mark.parametrize("full_ortho", [False, True], ids=["iop", "cgs2"])
def test_orthogonalisations_match_jax_and_exact_phi(full_ortho, one_sync):
    a, u = _problem(7, 120, 0.5, 30.0, 0.1, 3)
    w_j, want, w, st = _both(a, u, tol=1e-10, mmin=10, mmax=64, one_sync=one_sync, full_ortho=full_ortho)
    assert _stats(st) == want
    assert np.abs(w - w_j).max() / np.abs(w_j).max() < 1e-12
    exact = _phi_exact(a, 1.0, u.copy())
    assert np.linalg.norm(w - exact) / np.linalg.norm(exact) < 1e-8


def test_stiff_substepping_matches_jax_and_host():
    a, u = _problem(11, 100, 1.0, 400.0, 0.5, 2)
    w_j, want, w, st = _both(a, u, tol=1e-9, mmin=10, mmax=32)
    assert st.substeps > 1 and st.rejected > 0  # the adaptive path is exercised
    assert _stats(st) == want
    assert np.abs(w - w_j).max() / np.abs(w_j).max() < 1e-12
    _, st_host = kiops([1.0], lambda v: torch.as_tensor(a) @ v, torch.as_tensor(u), tol=1e-9, mmin=10, mmax=32)
    assert _stats(st) == (st_host.krylov_steps, st_host.substeps, st_host.rejected, st_host.last_krylov_size)


def test_one_host_read_per_control():
    a, u = _problem(11, 100, 1.0, 400.0, 0.5, 2)
    before = device.host_syncs
    _, st = kiops_jit(lambda v: torch.as_tensor(a) @ v, torch.as_tensor(u), tol=1e-9, mmin=10, mmax=32)
    assert st.controls == st.substeps + st.rejected == st.num_expm
    assert device.host_syncs - before == st.controls


class _HostTraffic(TorchDispatchMode):
    """Records the dispatched operators that, on a CUDA tensor, make the
    host wait for the card: a device value read on the host (``.item()``,
    ``bool()``, indexing with a 0-d tensor) or a host value copied to the
    card (a ``torch.tensor`` literal, a Python scalar wrapped as a tensor)."""

    OPS = ("aten._local_scalar_dense", "aten.is_nonzero", "aten.item", "aten.nonzero", "aten.lift_fresh",
           "aten.scalar_tensor")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(self.OPS):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", ["iop", "cgs2-one-sync", "float32-cgs2", "stiff", "happy"])
def test_no_host_traffic_but_the_control_reads(case):
    """The whole call, set-up and cycles, dispatches no operator that would
    make the host wait for the card; its one wait a control is the packed
    ``host_read`` (``tolist``, counted)."""
    kw = dict(tol=1e-9, mmin=10, mmax=32)
    if case == "happy":
        rng = np.random.default_rng(3)
        a = -np.diag(np.linspace(1.0, 5.0, 12)) + 0.05 * rng.standard_normal((12, 12))
        u = rng.standard_normal((2, 12))
        kw.update(mmin=20, m_init=20, full_ortho=True)
    else:
        a, u = _problem(11, 100, 1.0, 400.0, 0.5, 2) if case == "stiff" else _problem(7, 120, 0.5, 30.0, 0.1, 3)
        kw.update(full_ortho=case != "iop" and case != "stiff", one_sync=case == "cgs2-one-sync")
        if case == "float32-cgs2":
            kw.update(basis_dtype=torch.float32, tol=1e-7)
    at = torch.as_tensor(a, dtype=kw.get("basis_dtype", torch.float64))
    ut = torch.as_tensor(u)
    before = device.host_syncs
    with _HostTraffic() as traffic:
        _, st = kiops_jit(lambda v: at @ v, ut, **kw)
    assert traffic.seen == []
    assert device.host_syncs - before == st.controls > 0
    assert st.substeps > 1 if case == "stiff" else st.masked_iterations > 0 if case == "happy" else True


def test_happy_breakdown_masks_the_rest_of_the_cycle():
    """With full orthogonalisation the Krylov space of a 12-dimensional
    operator (13 with the augmented row) breaks down happily before the
    end of a cycle of 20: the remaining iterations are masked no-ops, and
    the result is the exact phi combination."""
    rng = np.random.default_rng(3)
    a = -np.diag(np.linspace(1.0, 5.0, 12)) + 0.05 * rng.standard_normal((12, 12))
    u = rng.standard_normal((2, 12))
    w_j, want, w, st = _both(a, u, tol=1e-10, mmin=20, mmax=32, m_init=20, full_ortho=True)
    assert _stats(st) == want
    assert st.masked_iterations > 0 and st.krylov_steps < 20
    exact = _phi_exact(a, 1.0, u.copy())
    assert np.linalg.norm(w - exact) / np.linalg.norm(exact) < 1e-8


def test_float32_basis_with_full_orthogonalisation():
    a, u = _problem(7, 120, 0.5, 30.0, 0.1, 2)
    at = torch.as_tensor(a, dtype=torch.float32)
    w, st = kiops_jit(lambda v: at @ v, torch.as_tensor(u), tol=1e-7, mmin=10, mmax=64, full_ortho=True,
                      basis_dtype=torch.float32)
    assert w.dtype == torch.float64
    exact = _phi_exact(a, 1.0, u.copy())
    assert np.linalg.norm(w.numpy() - exact) / np.linalg.norm(exact) < 1e-5


def test_expm_taylor_matches_scipy():
    import scipy.linalg

    rng = np.random.default_rng(5)
    for scale in (0.1, 3.0, 40.0):
        m = scale * rng.standard_normal((9, 9))
        got = _expm_taylor(torch.as_tensor(m)).numpy()
        want = scipy.linalg.expm(m)
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-12
