"""Exponential Propagation Iterative (EPI) integrators.

Counterpart of ``wxfactory_tpu/integrators/epi.py`` in its host-loop form
(:66-137, :334-478 there): multistep exponential integrators of orders 2-6
(``Epi``) and their stiffness-resilient variants (``EpiStiff``, orders 3+),
with the fixed A-coefficient tables, the Epi2 bootstrap of multistep
history, the Krylov-size warm start and an optional custom Jacobian action,
driven by KIOPS (``solvers/kiops.py``).

The Jacobian action is the RHS's own (``jtv_prep``/``jtv_apply``: one
launch of the tangent kernel per Krylov iteration on a GPU) or
``torch.func.jvp`` of a differentiable RHS (``solvers/matvec.py``); the
linearisation point's preparation runs once a step and serves the history
residuals too. ``exponential_solver`` other than ``kiops`` raises
``NotImplementedError`` naming its ROADMAP item (``kiops_jit``, the
device-resident step, with the float32 companion of
``mixed_precision_krylov``, is queue 1 item 7); ``steps_device`` is the
base class's loop of single steps, as in the JAX package with ``kiops``.
"""

import math
from collections import deque
from itertools import combinations
from typing import Callable, Optional

import numpy as np
import torch

from ..solvers import kiops
from ..solvers.matvec import make_jvp_matvec
from .base import Integrator, SolverInfo

_NOT_PORTED = {
    "pmex": "pmex is not ported yet: it comes with the shallow-water EPI3 slice (ROADMAP queue 1, item 5)",
    "kiops_jit": "kiops_jit (the device-resident KIOPS) is not ported yet (ROADMAP queue 1, item 7)",
}


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
        **kwargs,
    ) -> None:
        """`jtv(v, dt, q, rhs_q)` optionally supplies a custom Jacobian
        action dt * J(q).v on flat vectors (the reference's Epi_others,
        integrators/epi_for_others.py); the default is the RHS's own
        (``solvers.matvec.make_jvp_matvec``)."""
        super().__init__(**kwargs)
        if exponential_solver != "kiops":
            raise NotImplementedError(
                _NOT_PORTED.get(exponential_solver, f"exponential solver {exponential_solver!r} is not ported "
                                "(the port runs kiops)")
            )
        self.rhs = rhs
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
            self.init_method = Epi(rhs, 2, tolerance, exponential_solver, krylov_size, mmin, mmax)
        self.init_substeps = init_substeps
        self._phi_offset = 2  # vec row of the first history residual

    def _solve_phi(self, matvec, vec):
        # The reference caps the Krylov size at 64 (epi.py:325-336): the
        # incomplete (IOP-2) orthogonalization silently degrades for large m,
        # so tau-substepping with modest m is both faster and stable.
        phiv, stats = kiops([1.0], matvec, vec, tol=self.tol, m_init=self.krylov_size,
                            mmin=self.mmin, mmax=self.mmax)
        self.krylov_size = max(1, math.floor(0.7 * stats.last_krylov_size + 0.3 * self.krylov_size))
        if self.verbose > 0:
            print(
                f"{self.exponential_solver} converged at iteration {stats.krylov_steps} "
                f"({stats.substeps} substeps, {stats.rejected} rejected) "
                f"local error {stats.error_estimate:.2e}, last Krylov size {stats.last_krylov_size}",
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
        # One linearisation at q serves the history residuals and every
        # Krylov iteration; dt * (J.v) as the JAX package's scaled jvp.
        jac = make_jvp_matvec(self.rhs, q) if (self.jtv is None or self.n_prev) else None
        if self.jtv is not None:
            def matvec(v):
                return self.jtv(v, dt, q, rhs_q).reshape(-1)
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

        phiv = self._solve_phi(matvec, vec)

        if self.n_prev > 0:
            self.previous_q.pop()
            self.previous_q.appendleft(q)
            self.previous_rhs.pop()
            self.previous_rhs.appendleft(rhs_q)

        return q + phiv[0].reshape(q.shape).to(q.dtype) * dt


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
                               self.mmin, self.mmax)
