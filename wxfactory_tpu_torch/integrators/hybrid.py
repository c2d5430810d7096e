"""Hybrid implicit-explicit and implicit-exponential integrators.

Counterpart of ``wxfactory_tpu/integrators/hybrid.py`` (the reference's
integrators/imex2.py, rosexp2.py, partrosexp2.py and sdirk.py): the
2nd-order IMEX midpoint, the Rosenbrock-exponential hybrids (exponential
propagation of the full/partitioned nonlinearity + a rational implicit
solve) and the L-stable 2-stage SDIRK.

Each takes the RHS callables of its split (full / implicit / explicit).
The JAX package takes exact jitted jvps of them; here every Jacobian action
is the RHS's own linearisation (``solvers.matvec.make_jvp_matvec``: on the
card one tangent prep per linearisation point and one tangent apply per
action). RosExp2 and PartRosExp2 linearise at q once a step; when the full
and the implicit RHS are one object (as ``Simulation`` builds RosExp2) the
two share one prep and one apply an action.
"""

from typing import Callable

import numpy as np
import torch

from ..solvers import fgmres, newton_krylov, pmex
from ..solvers.matvec import make_jvp_matvec
from .base import Integrator, SolverInfo
from .implicit import implicit_jac


class Imex2(Integrator):
    """2nd-order IMEX midpoint (reference imex2.py:10-27)."""

    def __init__(self, rhs_exp: Callable, rhs_imp: Callable, tolerance: float = 1e-7, **kwargs):
        super().__init__(**kwargs)
        self.rhs_exp = rhs_exp
        self.rhs_imp = rhs_imp
        self.tol = tolerance

    def __step__(self, q, dt: float):
        b = q + 0.5 * dt * self.rhs_exp(q)

        def g(v):
            return v - 0.5 * dt * self.rhs_imp(v) - b

        # g's Jacobian action: v - dt/2 J_imp(x).v
        y1, num_iter, _res = newton_krylov(g, q, jac=implicit_jac(self.rhs_imp, q.shape, 1.0, 0.5 * dt),
                                           f_tol=self.tol)
        self.solver_info = SolverInfo(total_num_it=num_iter)
        return q + dt * (self.rhs_imp(y1) + self.rhs_exp(y1))


class _RosExpBase(Integrator):
    """The shared linearisation and implicit solve of RosExp2 and
    PartRosExp2."""

    def __init__(self, rhs_full: Callable, rhs_imp: Callable, tolerance: float = 1e-7, restart: int = 20, **kwargs):
        super().__init__(**kwargs)
        self.rhs_full = rhs_full
        self.rhs_imp = rhs_imp
        self.tol = tolerance
        self.restart = restart

    def _jacobians(self, q, dt: float):
        """(j_exp, a_op) at q: ``v -> dt J_full.v - dt J_imp.v`` and
        ``v -> v - dt/2 J_imp.v`` on flat tensors."""
        j_full = make_jvp_matvec(self.rhs_full, q, dt)
        if self.rhs_full is self.rhs_imp:
            j_imp = j_full

            def j_exp(v):
                jv = j_full(v)
                return jv - jv
        else:
            j_imp = make_jvp_matvec(self.rhs_imp, q, dt)

            def j_exp(v):
                return j_full(v) - j_imp(v)

        def a_op(v):
            return v - 0.5 * j_imp(v)

        return j_exp, a_op

    def _solve(self, q, a_op, b, stats):
        q_flat = q.reshape(-1)
        x, norm_r, norm_b, num_iter, flag, residuals = fgmres(
            a_op, b, x0=q_flat.clone(), tol=self.tol, restart=self.restart
        )
        self.solver_info = SolverInfo(total_num_it=stats.krylov_steps + num_iter,
                                      converged=(flag == 0), residuals=residuals)
        return x.reshape(q.shape).to(q.dtype)


class RosExp2(_RosExpBase):
    """Exponential-then-implicit hybrid (reference rosexp2.py:12-77): phi
    propagation with J_full - J_imp, then a (I - dt/2 J_imp) solve."""

    def __step__(self, q, dt: float):
        f_full = self.rhs_full(q).reshape(-1)
        n = f_full.numel()
        j_exp, a_op = self._jacobians(q, dt)

        vec = torch.zeros((2, n), dtype=torch.float64, device=q.device)
        vec[1, :] = f_full
        phiv, stats = pmex([1.0], j_exp, vec, tol=self.tol)

        b = a_op(q.reshape(-1)) + phiv[0] * dt
        return self._solve(q, a_op, b, stats)


class PartRosExp2(_RosExpBase):
    """Implicit-then-exponential partitioned hybrid (reference
    partrosexp2.py:13-90): vec rows [f_imp/2, f_exp], same implicit solve."""

    def __step__(self, q, dt: float):
        f_full = self.rhs_full(q)
        f_imp = self.rhs_imp(q)
        f_imp_flat = f_imp.reshape(-1)
        f_exp_flat = (f_full - f_imp).reshape(-1)
        n = f_imp_flat.numel()
        j_exp, a_op = self._jacobians(q, dt)

        vec = torch.zeros((2, n), dtype=torch.float64, device=q.device)
        vec[0, :] = 0.5 * f_imp_flat
        vec[1, :] = f_exp_flat
        phiv, stats = pmex([1.0], j_exp, vec, tol=self.tol)

        b = a_op(q.reshape(-1)) + (phiv[0] + 0.5 * f_imp_flat) * dt
        return self._solve(q, a_op, b, stats)


class SdirkLstable(Integrator):
    """L-stable 2-stage SDIRK with gamma = 1 + 1/sqrt(2)
    (reference sdirk.py:14-60), stages solved by Newton-Krylov."""

    def __init__(self, rhs: Callable, tolerance: float = 1e-7, **kwargs):
        super().__init__(**kwargs)
        self.rhs = rhs
        self.tol = tolerance
        self.gamma = 1.0 + 1.0 / np.sqrt(2.0)

    def __step__(self, q, dt: float):
        g = self.gamma
        jac = implicit_jac(self.rhs, q.shape, dt, g)

        def sys1(y):
            return (y - q) / dt - g * self.rhs(y)

        y1, it1, _r1 = newton_krylov(sys1, q, jac=jac, f_tol=self.tol)
        f1 = self.rhs(y1)

        def sys2(y):
            return (y - q) / dt - (1.0 - 2.0 * g) * f1 - g * self.rhs(y)

        y2, it2, _r2 = newton_krylov(sys2, q, jac=jac, f_tol=self.tol)
        self.solver_info = SolverInfo(total_num_it=it1 + it2)
        return q + dt * 0.5 * (self.rhs(y1) + self.rhs(y2))
