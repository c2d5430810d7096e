"""Stiffness-resilient exponential Runge-Kutta (SRERK) integrators.

Counterpart of ``wxfactory_tpu/integrators/srerk.py`` (the reference's
integrators/srerk.py): stage nodes from the minimal-error-term polynomial
roots (``opt_nodes``), per-stage nonlinear-remainder projections with alpha
coefficients, and the adaptive Krylov phi solvers underneath.

Every Jacobian action of a step, in the phi matvec and in the remainders
R(z_i) = f(z_i) - f(q) - J(z_i - q), is taken at q: the step prepares it
once (``solvers.matvec.make_jvp_matvec``: one tangent prep a step, one
tangent apply per action on the card), and every RHS call is one launch of
the operator kernel. The stage states and the remainders stay on the
state's device.

The exponential solver follows the JAX rule: ``kiops``, ``pmex`` /
``pmex_ne``, or any solver the ``solvers`` package exports, called with
Srerk's host-solver signature ``solver(tau_out, A, u, tol=, m_init=, mmin=,
mmax=)``. The device-resident ``kiops_jit`` has another signature
(``kiops_jit(A, u, tau_end, ...)``, one output time): the JAX Srerk hands
it the node array as its matvec and fails with a TypeError at the first
step, so the port refuses the pair at construction.
"""

import math
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import solvers as _solvers
from ..common.device import to_device
from ..solvers import kiops, pmex
from ..solvers.matvec import make_jvp_matvec
from .base import Integrator, SolverInfo
from .epi import alpha_coeff


def opt_nodes(order: int) -> List[np.ndarray]:
    """Projection nodes with minimal error terms (reference srerk.py:29-46)."""
    if order < 3:
        raise ValueError("SRERK order must be at least 3")

    def coeff(p, q):
        return (-1) ** (p + q) * math.factorial(p + q + 2) / (
            math.factorial(q) * math.factorial(q + 2) * math.factorial(p - q)
        )

    nodes = []
    for o in list(range(2, order - 2, 2)) + [order - 2]:
        poly = np.polynomial.Polynomial([coeff(o, q) for q in range(o + 1)])
        nodes.append(np.real_if_close(poly.roots()))
    nodes.append(np.ones(1))
    return nodes


class Srerk(Integrator):
    def __init__(
        self,
        rhs: Callable,
        order: int = 3,
        nodes: Optional[List] = None,
        tolerance: float = 1e-7,
        exponential_solver: str = "kiops",
        krylov_size: int = 1,
        mmin: int = 16,
        mmax: int = 64,
        jtv: Optional[Callable] = None,
        **kwargs,
    ) -> None:
        """With `nodes` given, uses them directly and ignores `order`.
        `jtv(v, dt, q, rhs_q)` optionally supplies a custom Jacobian action
        dt * J(q).v on flat vectors for the phi matvec (the reference's
        Srerk_others); the remainders keep the RHS's own."""
        super().__init__(**kwargs)
        if exponential_solver == "kiops_jit":
            raise ValueError(
                "srerk with exponential_solver = kiops_jit: kiops_jit(A, u, tau_end) evaluates one output time "
                "and Srerk needs every node of a projection (solver(tau_out, A, u)); the JAX package's Srerk "
                "passes it the nodes as its matvec and fails at the first step. Use kiops, pmex or a "
                "low-synchronization solver")
        self.rhs = rhs
        self.jtv = jtv
        self.tol = tolerance
        self.exponential_solver = exponential_solver
        self.krylov_size = krylov_size
        self.mmin = mmin
        self.mmax = mmax

        self.c = nodes if nodes else opt_nodes(order)
        self.n_proj = len(self.c)
        self.alpha = [alpha_coeff(self.c[i]) for i in range(self.n_proj - 1)]

    def _solve_phi(self, tau_out, matvec, vec):
        name = self.exponential_solver
        if name == "kiops":
            solver = kiops
        elif name in ("pmex", "pmex_ne"):
            solver = pmex
        elif hasattr(_solvers, name):
            solver = getattr(_solvers, name)
        else:
            raise ValueError(f"Unrecognized exponential solver {self.exponential_solver}")
        z, stats = solver(tau_out, matvec, vec, tol=self.tol, m_init=self.krylov_size,
                          mmin=self.mmin, mmax=self.mmax)
        self.krylov_size = max(1, math.floor(0.7 * stats.last_krylov_size + 0.3 * self.krylov_size))
        if self.solver_info is None:
            self.solver_info = SolverInfo()
        self.solver_info.total_num_it += stats.krylov_steps
        self.solver_info.num_substeps += stats.substeps
        self.solver_info.num_rejected += stats.rejected
        return z

    def __step__(self, q, dt: float):
        rhs_q = self.rhs(q)
        f_flat = rhs_q.reshape(-1).to(torch.float64)
        n = f_flat.numel()
        # One linearisation at q serves the phi matvec and every remainder.
        jac = make_jvp_matvec(self.rhs, q)

        if self.jtv is not None:
            def matvec(v):
                return self.jtv(v, dt, q, rhs_q).reshape(-1)
        else:
            def matvec(v):
                return dt * jac(v)

        vec = torch.zeros((2, n), dtype=torch.float64, device=q.device)
        vec[1, :] = f_flat
        z = self._solve_phi(self.c[0], matvec, vec)

        for i_proj in range(1, self.n_proj):
            # Stage states at the previous projection's nodes.
            stages = [q + dt * z[i].reshape(q.shape).to(q.dtype) for i in range(z.shape[0])]

            # Nonlinear remainders R(z_i) = f(z_i) - f(q) - J (z_i - q).
            rz = torch.empty((len(stages), n), dtype=torch.float64, device=q.device)
            for i, zi in enumerate(stages):
                j_dz = jac((zi - q).reshape(-1))
                rz[i, :] = (self.rhs(zi) - rhs_q).reshape(-1) - j_dz

            vec = torch.zeros((len(stages) + 3, n), dtype=torch.float64, device=q.device)
            vec[1, :] = f_flat
            vec[3:, :] = to_device(self.alpha[i_proj - 1], rz) @ rz
            z = self._solve_phi(self.c[i_proj], matvec, vec)

        return q + dt * z[-1].reshape(q.shape).to(q.dtype)
