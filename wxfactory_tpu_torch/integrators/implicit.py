"""Fully implicit integrators: backward Euler, Crank-Nicolson, BDF2.

Counterpart of ``wxfactory_tpu/integrators/implicit.py`` (the reference's
integrators/backward_euler.py, crank_nicolson.py, bdf2.py): each step
solves a nonlinear system with the Jacobian-free Newton-Krylov solver
(``solvers/nonlin.py``: FGMRES inside, the iterate on the state's device).

Every residual has the form ``(x - base)/dt - c f(x) - r``, so its Jacobian
action is ``v/dt - c J_f(x).v`` with J_f the RHS's own linearisation
(``solvers.matvec.make_jvp_matvec``: one tangent prep per Newton iteration,
one tangent apply per FGMRES matvec on the card; ``jacobian_actions``
counts them). The preconditioner is passed where the JAX package passes
it: the main solves of the three, not BDF2's start-up substeps.
"""

from time import time
from typing import Callable

from ..solvers.matvec import make_jvp_matvec
from ..solvers.nonlin import newton_krylov
from .base import Integrator, SolverInfo


def implicit_jac(rhs: Callable, shape, dt: float, c: float) -> Callable:
    """The Newton Jacobian-action factory of ``(x - base)/dt - c f(x) - r``:
    ``x -> (v -> v/dt - c J_f(x).v)`` on flat tensors."""
    def jac(x):
        jv = make_jvp_matvec(rhs, x.reshape(shape))
        return lambda v: v / dt - c * jv(v)

    return jac


class BackwardEuler(Integrator):
    def __init__(self, rhs: Callable, tolerance: float = 1e-7, **kwargs) -> None:
        super().__init__(**kwargs)
        self.rhs = rhs
        self.tol = tolerance

    def __step__(self, q, dt: float):
        rhs = self.rhs

        def residual(q_plus):
            return (q_plus - q) / dt - rhs(q_plus)

        t0 = time()
        new_q, num_iter, residuals = newton_krylov(residual, q, jac=implicit_jac(rhs, q.shape, dt, 1.0),
                                                   f_tol=self.tol, fgmres_precond=self.preconditioner)
        self.solver_info = SolverInfo(total_num_it=num_iter, residuals=residuals)
        self.latest_time = time() - t0
        return new_q.reshape(q.shape)


class CrankNicolson(Integrator):
    def __init__(self, rhs: Callable, tolerance: float = 1e-7, **kwargs) -> None:
        super().__init__(**kwargs)
        self.rhs = rhs
        self.tol = tolerance

    def __step__(self, q, dt: float):
        rhs = self.rhs
        rhs_q = rhs(q)

        def residual(q_plus):
            return (q_plus - q) / dt - 0.5 * (rhs(q_plus) + rhs_q)

        t0 = time()
        new_q, num_iter, residuals = newton_krylov(residual, q, jac=implicit_jac(rhs, q.shape, dt, 0.5),
                                                   f_tol=self.tol, fgmres_restart=30,
                                                   fgmres_precond=self.preconditioner)
        self.solver_info = SolverInfo(total_num_it=num_iter, residuals=residuals)
        self.latest_time = time() - t0
        return new_q.reshape(q.shape)


class Bdf2(Integrator):
    """2nd-order backward differentiation formula, bootstrapped with
    trapezoidal backward-Euler substeps like the reference bdf2.py."""

    def __init__(self, rhs: Callable, tolerance: float = 1e-7, init_substeps: int = 1, **kwargs) -> None:
        super().__init__(**kwargs)
        self.rhs = rhs
        self.tol = tolerance
        self.init_substeps = init_substeps
        self.q_prev = None

    def __step__(self, q, dt: float):
        rhs = self.rhs
        if self.q_prev is None:
            new_q = q
            for _ in range(self.init_substeps):
                init_dt = dt / self.init_substeps
                q_base = new_q

                def residual(q_plus):
                    return (q_plus - q_base) / init_dt - 0.5 * rhs(q_plus)

                new_q, num_iter, residuals = newton_krylov(residual, q_base,
                                                           jac=implicit_jac(rhs, q.shape, init_dt, 0.5),
                                                           f_tol=self.tol)
        else:
            q_prev = self.q_prev

            def residual(q_plus):
                return (q_plus - 4.0 / 3.0 * q + 1.0 / 3.0 * q_prev) / dt - 2.0 / 3.0 * rhs(q_plus)

            new_q, num_iter, residuals = newton_krylov(residual, q, jac=implicit_jac(rhs, q.shape, dt, 2.0 / 3.0),
                                                       f_tol=self.tol, fgmres_precond=self.preconditioner)
        self.solver_info = SolverInfo(total_num_it=num_iter, residuals=residuals)
        self.q_prev = q
        return new_q.reshape(q.shape)
