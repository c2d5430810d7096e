"""The port's FGMRES solvers (``solvers/fgmres.py``, host-orchestrated;
``solvers/fgmres_jit.py``, device-resident) against the JAX package's on
identical seeded numpy systems, and the float32 companion's Jacobian-action
rule (``solvers/matvec.py::companion_jacobian``).

* Host ``fgmres`` (1-sync lagged-normalisation Gram-Schmidt): identical
  ``num_iter`` and ``flag``, x within 1e-12 of |x|, one host read an
  iteration and one a restart.
* ``fgmres_jit`` (two-sync and ``one_sync``): identical ``num_iter``, x
  within 1e-12 of |x|; with a float32 inner operator on a float32 basis
  (``A32``) the same converged result to the tolerance; no operator that
  would make the host wait for a card is dispatched but the packed
  per-cycle reads; iterations after a cycle converged are masked and
  counted apart.
* The companion rule (the JAX ``Epi``/``Ros2``: integrators/epi.py:181-200,
  rosenbrock.py:104-117): ``jtv_prep``/``jtv_apply`` when the companion has
  them, else ``torch.func.jvp`` of its ``.xla``, else of itself; off the
  CPU a companion without ``jtv_prep`` raises; the shallow-water companion's
  is its own ``jtv_prep``/``jtv_apply``, the absolute float32 operator's
  J.v.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from wxfactory_tpu.solvers import fgmres as j_fgmres
from wxfactory_tpu.solvers.fgmres_jit import fgmres_jit as j_fgmres_jit
from wxfactory_tpu_torch import interop
from wxfactory_tpu_torch.common import device
from wxfactory_tpu_torch.solvers import matvec
from wxfactory_tpu_torch.solvers.fgmres import fgmres
from wxfactory_tpu_torch.solvers.fgmres_jit import fgmres_jit

torch.set_num_threads(1)


def _system(seed=0, n=160, spread=0.6):
    """A nonsymmetric, well-conditioned system and its right-hand side."""
    rng = np.random.default_rng(seed)
    a = np.diag(np.linspace(1.0, 4.0, n)) + spread * rng.standard_normal((n, n)) / np.sqrt(n)
    return a, rng.standard_normal(n), 0.1 * rng.standard_normal(n)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("restart,tol", [(10, 1e-10), (25, 1e-12), (8, 1e-6)], ids=["r10", "r25", "r8-loose"])
def test_host_fgmres_matches_jax(restart, tol):
    a, b, x0 = _system()
    want = j_fgmres(lambda v: a @ v, b, x0=x0, tol=tol, restart=restart, maxiter=50)
    at = torch.as_tensor(a)
    before = device.host_syncs
    x, norm_r, norm_b, num_iter, flag, residuals = fgmres(lambda v: at @ v, torch.as_tensor(b),
                                                          x0=torch.as_tensor(x0), tol=tol, restart=restart,
                                                          maxiter=50)
    assert (num_iter, flag) == (want[3], want[4]) and flag == 0
    assert _rel(x.numpy(), want[0]) < 1e-12
    assert norm_r < tol * norm_b and len(residuals) == len(want[5])
    # |b| and |r0|, then a Gram read an iteration and two more a cycle (its
    # first Gram product and the restart's |r| with the stagnation test).
    cycles = -(-num_iter // restart)
    assert device.host_syncs - before == 2 + num_iter + 2 * cycles


def _jax_jit(a, b, x0, a32=None, **kw):
    aj = jnp.asarray(a)
    A32 = None if a32 is None else (lambda v: jnp.asarray(a32) @ v)
    run = jax.jit(lambda bb, xx: j_fgmres_jit(lambda v: aj @ v, bb, x0=xx, A32=A32,
                                              basis_dtype=None if a32 is None else jnp.float32, **kw))
    x, info = run(jnp.asarray(b), jnp.asarray(x0))
    return np.asarray(x), int(info.num_iter), bool(info.converged)


@pytest.mark.parametrize("one_sync", [False, True], ids=["two-sync", "one-sync"])
@pytest.mark.parametrize("restart,tol", [(10, 1e-10), (30, 1e-12), (7, 1e-8)], ids=["r10", "r30", "r7"])
def test_fgmres_jit_matches_jax(restart, tol, one_sync):
    a, b, x0 = _system(1)
    kw = dict(tol=tol, restart=restart, max_outer=40, one_sync=one_sync)
    want, jiter, jconv = _jax_jit(a, b, x0, **kw)
    at = torch.as_tensor(a)
    x, info = fgmres_jit(lambda v: at @ v, torch.as_tensor(b), x0=torch.as_tensor(x0), **kw)
    assert info.num_iter == jiter and info.converged and jconv
    assert _rel(x.numpy(), want) < 1e-12
    assert info.cycles == -(-info.num_iter // restart) or info.masked_iterations > 0
    assert info.matvecs == 1 + info.cycles * (restart + 1)
    assert info.num_iter + info.masked_iterations == info.cycles * restart


def test_fgmres_jit_mixed_precision_matches_jax():
    """A32 on a float32 basis, the outer residuals in float64 with the
    exact operator: both converge to the float64 tolerance; the counts of
    float32 inner iterations agree within one restart cycle."""
    a, b, x0 = _system(2)
    a32 = a.astype(np.float32)
    kw = dict(tol=1e-10, restart=12, max_outer=40)
    want, jiter, jconv = _jax_jit(a, b, x0, a32=a32, **kw)
    at, at32 = torch.as_tensor(a), torch.as_tensor(a32)
    x, info = fgmres_jit(lambda v: at @ v, torch.as_tensor(b), x0=torch.as_tensor(x0), A32=lambda v: at32 @ v,
                         basis_dtype=torch.float32, **kw)
    assert info.converged and jconv
    assert abs(info.num_iter - jiter) <= 12, (info.num_iter, jiter)
    assert info.norm_r < 1e-10 * info.norm_b
    assert _rel(x.numpy(), want) < 1e-9


class _HostTraffic(TorchDispatchMode):
    """Records the dispatched operators that, on a CUDA tensor, make the
    host wait for the card (as tests/test_torch_kiops_jit.py)."""

    OPS = ("aten._local_scalar_dense", "aten.is_nonzero", "aten.item", "aten.nonzero", "aten.lift_fresh",
           "aten.scalar_tensor")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(self.OPS):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mixed", [False, True], ids=["float64", "float32-basis"])
def test_fgmres_jit_reads_the_host_once_a_cycle(mixed):
    a, b, x0 = _system(3)
    at, at32 = torch.as_tensor(a), torch.as_tensor(a.astype(np.float32))
    kw = dict(A32=lambda v: at32 @ v, basis_dtype=torch.float32) if mixed else {}
    bt, x0t = torch.as_tensor(b), torch.as_tensor(x0)
    before = device.host_syncs
    with _HostTraffic() as traffic:
        _, info = fgmres_jit(lambda v: at @ v, bt, x0=x0t, tol=1e-9, restart=10, max_outer=40, **kw)
    assert traffic.seen == []
    assert device.host_syncs - before == info.cycles + 1 and info.cycles > 1
    assert info.masked_iterations > 0


def test_fgmres_jit_happy_breakdown_masks_the_rest():
    """An operator with a 5-dimensional Krylov space: the cycle breaks down
    at iteration 5 (nrm == 0 to round-off) and the rest is masked."""
    n = 40
    a = np.eye(n)
    a[:5, :5] += np.diag([1.0, 2.0, 3.0, 4.0, 5.0])
    b = np.zeros(n)
    b[:5] = 1.0
    at = torch.as_tensor(a)
    x, info = fgmres_jit(lambda v: at @ v, torch.as_tensor(b), tol=1e-14, restart=12, max_outer=3)
    want, jiter, _ = _jax_jit(a, b, np.zeros(n), tol=1e-14, restart=12, max_outer=3)
    assert info.num_iter == jiter <= 6
    assert info.masked_iterations == info.cycles * 12 - info.num_iter
    assert _rel(x.numpy(), want) < 1e-12


# ---------------------------------------------------------------------------
# The float32 companion's Jacobian-action rule


class _Recorder:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, q):
        self.calls += 1
        return self.fn(q)


def test_companion_without_jtv_prep_differentiates_its_xla():
    q = torch.linspace(0.5, 2.0, 12, dtype=torch.float32)
    v = torch.linspace(-1.0, 1.0, 12, dtype=torch.float32)

    class Companion:
        xla = _Recorder(lambda x: x**3)  # the absolute operator of the companion's dtype

        def __call__(self, x):
            raise AssertionError("the companion itself must not be differentiated when it has .xla")

    comp = Companion()
    jac = matvec.companion_jacobian(comp, q)
    torch.testing.assert_close(jac(v), 3 * q**2 * v)
    assert Companion.xla.calls == 1
    # Without .xla the companion itself is differentiated.
    plain = _Recorder(lambda x: torch.sin(x))
    torch.testing.assert_close(matvec.companion_jacobian(plain, q)(v), torch.cos(q) * v)
    assert plain.calls == 1
    # A companion with jtv_prep/jtv_apply uses them.
    class Kernel:
        def jtv_prep(self, x):
            return ("prep", x)

        def jtv_apply(self, prep, w):
            return prep[1] * w

        def xla(self, x):
            raise AssertionError("jtv_prep comes first")

    torch.testing.assert_close(matvec.companion_jacobian(Kernel(), q)(v), q * v)
    # Off the CPU, torch.func.jvp cannot pass through a kernel: it raises.
    with pytest.raises(NotImplementedError, match="jtv_prep"):
        matvec.companion_jacobian(comp, torch.empty(12, device="meta"))


def test_shallow_water_companion_raises_naming_roadmap():
    from conftest import cs2d_setup
    from wxfactory_tpu.testcases.shallow_water import williamson_case6

    from wxfactory_tpu_torch.ops import sw_operator as swop

    # The SW companion has a Jacobian action now (its jtv_prep/jtv_apply, the
    # tangent kernel on a card): the rule takes it, and it is the absolute
    # float32 operator's J.v at q32, as the JAX package's jax.jvp of the
    # companion's .xla form is.
    geom, ops, topo, metric = cs2d_setup(3, 3)
    q0 = np.asarray(williamson_case6(geom))
    sw32 = interop.shallow_water_rhs(geom, ops, metric, dtype=torch.float32, perturbation_base=q0)
    q32 = torch.as_tensor(q0, dtype=torch.float32)
    v = torch.as_tensor(np.random.default_rng(2).standard_normal(q0.shape) * 1e-3 * np.abs(q0).max(),
                        dtype=torch.float32)
    want = swop.sw_tangent_plain(q32, v, sw32.con, sw32.topology)
    assert torch.equal(matvec.companion_jacobian(sw32, q32)(v), want)
    rat = matvec.make_rat_matvec(sw32, q32, 30.0)
    assert torch.equal(rat(v.reshape(-1)), v.reshape(-1) - 15.0 * want.reshape(-1))
