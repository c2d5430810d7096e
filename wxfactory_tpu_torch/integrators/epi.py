"""Exponential Propagation Iterative (EPI) integrators.

Counterpart of ``wxfactory_tpu/integrators/epi.py``: multistep exponential
integrators of orders 2-6 (``Epi``) and their stiffness-resilient variants
(``EpiStiff``, orders 3+), with the fixed A-coefficient tables, the Epi2
bootstrap of multistep history, the Krylov-size warm start and an optional
custom Jacobian action.

Two exponential solvers, one step:

* ``kiops`` (:334-478 there): the host-orchestrated KIOPS
  (``solvers/kiops.py``), one host sync per Krylov iteration;
* ``kiops_jit`` (the JAX package's ``_build_dev_step``, :140-236 there):
  the device-resident KIOPS (``solvers/kiops_jit.py``), one host sync per
  Krylov control. With a float32 companion ``rhs32`` (the perturbation-form
  ``Euler3DRHS(perturbation_base=q0)``, ``mixed_precision_krylov``) the
  Arnoldi matvec is the companion's Jacobian action in float32 (one launch
  of the kernel's perturbation tangent mode on a GPU), with full CGS2
  orthogonalisation and a float32 basis, while the RHS, the history
  residuals, H and the controller stay float64.

The JAX package's ``steps_device`` (one ``lax.scan`` a chunk) has no
counterpart: in eager PyTorch a chunk is the base class's loop over
``step``, and the Krylov-size warm start is a host integer in either form.

The Jacobian action is the RHS's own (``jtv_prep``/``jtv_apply``) or
``torch.func.jvp`` of a differentiable RHS (``solvers/matvec.py``); the
linearisation point's preparation runs once a step and serves the history
residuals too. ``pmex`` raises ``NotImplementedError`` naming its ROADMAP
item.
"""

import math
from collections import deque
from itertools import combinations
from typing import Callable, Optional

import numpy as np
import torch

from ..solvers import kiops
from ..solvers.kiops_jit import kiops_jit
from ..solvers.matvec import make_jvp_matvec
from .base import Integrator, SolverInfo

_NOT_PORTED = {
    "pmex": "pmex is not ported yet: it comes with the shallow-water EPI3 slice (ROADMAP queue 1, item 5)",
}
_PORTED = ("kiops", "kiops_jit")


def alpha_coeff(c) -> np.ndarray:
    """Coefficients of stiffness-resilient exponential methods from node
    values c (reference integrator.py:135-146)."""
    m = len(c)
    alpha = np.zeros((m, m))
    for i in range(m):
        c_no_i = [cc for (j, cc) in enumerate(c) if j != i]
        denom = c[i] ** 2 * math.prod([c[i] - cl for cl in c_no_i])
        for k in range(m):
            sp = sum(math.prod(v) for v in combinations(c_no_i, m - k - 1))
            alpha[k, i] = (-1) ** (m - k + 1) * math.factorial(k + 2) * sp / denom
    return alpha


# Fixed EPI multistep coefficient tables (Tokman et al.); rows = phi order - 2
_EPI_A = {
    2: np.zeros((0, 0)),
    3: np.array([[2 / 3]]),
    4: np.array([[-3 / 10, 3 / 40], [32 / 5, -11 / 10]]),
    5: np.array([[-4 / 5, 2 / 5, -4 / 45], [12, -9 / 2, 8 / 9], [3, 0, -1 / 3]]),
    6: np.array(
        [
            [-49 / 60, 351 / 560, -359 / 1260, 367 / 6720],
            [92 / 7, -99 / 14, 176 / 63, -1 / 2],
            [485 / 21, -151 / 14, 23 / 9, -31 / 168],
        ]
    ),
}


class Epi(Integrator):
    def __init__(
        self,
        rhs: Callable,
        order: int = 2,
        tolerance: float = 1e-7,
        exponential_solver: str = "kiops",
        krylov_size: int = 1,
        mmin: int = 16,
        mmax: int = 64,
        init_method: Optional[Integrator] = None,
        init_substeps: int = 1,
        jtv: Optional[Callable] = None,
        rhs32: Optional[Callable] = None,
        **kwargs,
    ) -> None:
        """`jtv(v, dt, q, rhs_q)` optionally supplies a custom Jacobian
        action dt * J(q).v on flat vectors (the reference's Epi_others,
        integrators/epi_for_others.py); the default is the RHS's own
        (``solvers.matvec.make_jvp_matvec``). ``rhs32``: the float32
        companion RHS of the mixed-precision device step (used with
        ``kiops_jit`` only)."""
        super().__init__(**kwargs)
        if exponential_solver not in _PORTED:
            raise NotImplementedError(
                _NOT_PORTED.get(exponential_solver, f"exponential solver {exponential_solver!r} is not ported "
                                "(the port runs kiops and kiops_jit)")
            )
        self.rhs = rhs
        self.rhs32 = rhs32
        self.jtv = jtv
        self.tol = tolerance
        self.exponential_solver = exponential_solver
        self.krylov_size = krylov_size
        self.mmin = mmin
        self.mmax = mmax

        if order not in _EPI_A:
            raise ValueError(f"Unsupported order {order} for EPI method")
        self.A = _EPI_A[order]
        k = self.A.shape[0] if order > 2 else 0
        self.n_prev = self.A.shape[1] if self.A.size else 0
        self.max_phi = k + 1
        self.previous_q: deque = deque()
        self.previous_rhs: deque = deque()
        self.dt = 0.0

        if init_method is not None or self.n_prev == 0:
            self.init_method = init_method
        else:
            # The bootstrap sub-integrator gets the same float32 companion.
            self.init_method = Epi(rhs, 2, tolerance, exponential_solver, krylov_size, mmin, mmax, rhs32=rhs32)
        self.init_substeps = init_substeps
        self._phi_offset = 2  # vec row of the first history residual

    def _solve_phi(self, matvec, vec, mixed: bool):
        """phi_0 of the vec rows by the exponential solver: ``kiops`` (host
        controls, IOP-2) or ``kiops_jit`` (device controls; with the float32
        companion's matvec, ``mixed``, full CGS2 over a float32 basis, since
        an inexact operator needs a fully orthogonal basis)."""
        # The reference caps the Krylov size at 64 (epi.py:325-336): the
        # incomplete (IOP-2) orthogonalization silently degrades for large m,
        # so tau-substepping with modest m is both faster and stable.
        kw = dict(tol=self.tol, m_init=self.krylov_size, mmin=self.mmin, mmax=self.mmax)
        extra = ""
        if self.exponential_solver == "kiops_jit":
            phiv, stats = kiops_jit(matvec, vec, tau_end=1.0, full_ortho=mixed,
                                    basis_dtype=torch.float32 if mixed else None, **kw)
            extra = f", {stats.controls} controls, {stats.masked_iterations} masked, {stats.matvecs} matvecs"
        else:
            phiv, stats = kiops([1.0], matvec, vec, **kw)
            phiv = phiv[0]
        self.krylov_size = max(1, math.floor(0.7 * stats.last_krylov_size + 0.3 * self.krylov_size))
        if self.verbose > 0:
            print(
                f"{self.exponential_solver} converged at iteration {stats.krylov_steps} "
                f"({stats.substeps} substeps, {stats.rejected} rejected) "
                f"local error {stats.error_estimate:.2e}, last Krylov size {stats.last_krylov_size}{extra}",
                flush=True,
            )
        self.solver_info = SolverInfo(total_num_it=stats.krylov_steps,
                                      num_substeps=stats.substeps,
                                      num_rejected=stats.rejected,
                                      error_estimate=stats.error_estimate)
        return phiv

    def __step__(self, q, dt: float):
        # Multistep history is only valid at constant dt.
        if self.dt and abs(self.dt - dt) > 1e-10:
            self.previous_q.clear()
            self.previous_rhs.clear()
        self.dt = dt

        if len(self.previous_q) < self.n_prev:
            # Bootstrap history with the (lower-order) init method.
            self.previous_q.appendleft(q)
            self.previous_rhs.appendleft(self.rhs(q))
            sub_dt = dt / self.init_substeps
            for _ in range(self.init_substeps):
                q = self.init_method.step(q, sub_dt)
            return q

        rhs_q = self.rhs(q)
        mixed = self.rhs32 is not None and self.jtv is None and self.exponential_solver == "kiops_jit"
        # One linearisation at q serves the history residuals and, without
        # the companion, every Krylov iteration; dt * (J.v) as the JAX
        # package's scaled jvp.
        jac = make_jvp_matvec(self.rhs, q) if (self.n_prev or (self.jtv is None and not mixed)) else None
        if self.jtv is not None:
            def matvec(v):
                return self.jtv(v, dt, q, rhs_q).reshape(-1)
        elif mixed:
            # The companion's J.v stays in float32 (kiops_jit hands it the
            # float32 basis vectors); dt is cast as the JAX step casts it
            # (epi.py:212 there).
            kry, dt32 = make_jvp_matvec(self.rhs32, q.to(torch.float32)), float(np.float32(dt))

            def matvec(v):
                return dt32 * kry(v)
        else:
            def matvec(v):
                return dt * jac(v)

        n = rhs_q.numel()
        vec = torch.zeros((self.max_phi + 1, n), dtype=torch.float64, device=q.device)
        vec[1, :] = rhs_q.reshape(-1)
        for i in range(self.n_prev):
            dq = self.previous_q[i] - q
            r = (self.previous_rhs[i] - rhs_q).reshape(-1) - jac(dq.reshape(-1))
            for k, alpha in enumerate(self.A[:, i], start=self._phi_offset):
                vec[k, :] += alpha * r

        phiv = self._solve_phi(matvec, vec, mixed)
        if self.n_prev > 0:
            self.previous_q.pop()
            self.previous_q.appendleft(q)
            self.previous_rhs.pop()
            self.previous_rhs.appendleft(rhs_q)
        return q + phiv.reshape(q.shape).to(q.dtype) * dt


class EpiStiff(Epi):
    """Stiffness-resilient EPI: alpha coefficients from the integer nodes
    -1, -2, ..., contributions starting at phi_3 (reference epi_stiff.py)."""

    def __init__(self, rhs: Callable, order: int = 3, **kwargs) -> None:
        if order < 3:
            raise ValueError("EpiStiff requires order >= 3")
        super().__init__(rhs, 2, **kwargs)  # base init; then override tables
        self.A = alpha_coeff([-i for i in range(-1, 1 - order, -1)])
        self.n_prev = self.A.shape[1]
        self.max_phi = order if order > 2 else 1
        self._phi_offset = 3  # EpiStiff residuals start at phi_3
        self.init_method = Epi(rhs, 2, self.tol, self.exponential_solver, self.krylov_size,
                               self.mmin, self.mmax, rhs32=self.rhs32)
