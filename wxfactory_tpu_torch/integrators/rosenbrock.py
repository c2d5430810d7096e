"""Ros2: the second-order Rosenbrock integrator.

Counterpart of ``wxfactory_tpu/integrators/rosenbrock.py`` (reference
integrators/ros2.py): a step solves

    (I - dt/2 J) q_new = (I - dt/2 J) q + dt f(q),   x0 = q,

by FGMRES, with the exact Jacobian action J(q).v of the RHS
(``solvers.matvec.make_rat_matvec``: one launch of the tangent kernel a
matvec on the card, the plain tangent on the CPU; the linearisation
point's preparation once a step). Two solvers:

* ``fgmres``: the host-orchestrated 1-sync FGMRES (``solvers/fgmres.py``,
  one host read an iteration);
* ``fgmres_jit`` / ``fgmres_jit_1s`` (and ``auto`` without a
  preconditioner): the device-resident FGMRES (``solvers/fgmres_jit.py``,
  one host read a restart cycle). With a float32 companion ``rhs32``
  (``mixed_precision_krylov``) its inner Arnoldi runs the companion's
  rational matvec ``v - float32(dt/2) J32.v`` on a float32 basis, J32 by the
  JAX package's rule (``solvers.matvec.companion_jacobian``: the 3D
  companion's perturbation tangent kernel, its ``jtv_prep`` once a step),
  while every outer residual keeps the exact float64 operator.

``steps_device(q, dt, n)`` runs n device-solver steps back to back (no host
read between them beyond the cycles' own) and sums their statistics, as
the JAX package's one ``lax.scan`` does (the preconditioner prepared at
each step's state).

``gcrot`` (``solvers/gcrot.py``, the recycled-subspace GCROT(m,k) with m =
``gmres_restart``) takes the host path in place of ``fgmres``, with the
same budget and preconditioner (:218-231 there).

With a preconditioner (``precondition/``: lu, ilu, p-mg, fv-mg; prepared at
q once a step by ``Integrator.step``) the JAX package's rule holds
(integrators/rosenbrock.py:156-159 and :214-216 there): ``auto`` takes the
host ``fgmres``, whose budget is then 400 // restart cycles, and an
explicit ``fgmres_jit`` takes the preconditioner into its flexible form.
"""

from time import time
from typing import Callable, Optional

import torch

from ..solvers.fgmres import fgmres
from ..solvers.fgmres_jit import FgmresJitInfo, fgmres_jit
from ..solvers.gcrot import gcrot
from ..solvers.matvec import companion_jacobian, make_rat_matvec
from .base import Integrator, SolverInfo

_SOLVERS = ("auto", "fgmres", "fgmres_jit", "fgmres_jit_1s", "gcrot")


class Ros2(Integrator):
    def __init__(
        self,
        rhs: Callable,
        tolerance: float = 1e-7,
        gmres_restart: int = 30,
        linear_solver: str = "auto",
        rhs32: Optional[Callable] = None,
        **kwargs,
    ) -> None:
        """``linear_solver``: "fgmres" or "gcrot" (host), "fgmres_jit" or
        "fgmres_jit_1s" (device-resident; the latter with the one-product
        norm estimate), "auto" (fgmres_jit, or fgmres with a
        preconditioner). ``rhs32``: the float32 companion of the device
        solver's inner Arnoldi."""
        super().__init__(**kwargs)
        if linear_solver not in _SOLVERS:
            raise ValueError(f"unknown linear_solver {linear_solver!r} (one of {', '.join(_SOLVERS)})")
        self.rhs = rhs
        self.rhs32 = rhs32
        self.tol = tolerance
        self.gmres_restart = gmres_restart
        self.linear_solver = linear_solver
        # FGMRES iterations a step may take without a preconditioner (the
        # JAX package's budget); a run that only needs to show stagnation
        # may lower it.
        self.max_iterations = 20000

    def _use_jit_solver(self) -> bool:
        return self.linear_solver in ("fgmres_jit", "fgmres_jit_1s") or (
            self.linear_solver == "auto" and self.preconditioner is None)

    def _solve_device(self, q, dt: float):
        """One step by the device-resident FGMRES: the new state and the
        solver's information."""
        A = make_rat_matvec(self.rhs, q, dt)
        A32, basis_dtype = None, None
        if self.rhs32 is not None:
            q32 = q.to(torch.float32)
            A32 = make_rat_matvec(self.rhs32, q32, dt, jac=companion_jacobian(self.rhs32, q32))
            basis_dtype = torch.float32
        qv = q.reshape(-1)
        b = A(qv) + self.rhs(q).reshape(-1) * dt
        x, info = fgmres_jit(A, b, x0=qv, tol=self.tol, restart=self.gmres_restart,
                             max_outer=max(1, self.max_iterations // self.gmres_restart),
                             preconditioner=self.preconditioner,
                             one_sync=self.linear_solver == "fgmres_jit_1s", A32=A32, basis_dtype=basis_dtype)
        return x.reshape(q.shape), info

    def _report(self, infos) -> None:
        converged = all(i.converged for i in infos)
        self.solver_info = SolverInfo(total_num_it=sum(i.num_iter for i in infos), converged=converged)
        self.failure_flag = 0 if converged else -1

    @staticmethod
    def _extra(infos) -> str:
        return (f", {sum(i.cycles for i in infos)} cycles, {sum(i.masked_iterations for i in infos)} masked, "
                f"{sum(i.matvecs for i in infos)} matvecs")

    def steps_device(self, q, dt: float, nsteps: int):
        """``nsteps`` Ros2 steps with the device solver back to back, their
        statistics summed into ``solver_info`` (the host solver: repeated
        single steps)."""
        if not self._use_jit_solver():
            return Integrator.steps_device(self, q, dt, nsteps)
        t0 = time()
        infos = []
        for _ in range(nsteps):
            if self.preconditioner is not None:
                self.preconditioner.prepare(dt, q)
            q, info = self._solve_device(q, dt)
            infos.append(info)
        self.latest_time = time() - t0
        self._report(infos)
        self.sim_time += dt * nsteps
        self.num_completed_steps += nsteps
        if self.verbose > 0:
            last: FgmresJitInfo = infos[-1]
            print(f"FGMRES(jit) chunk of {nsteps}: {self.solver_info.total_num_it} total iterations, "
                  f"last relative residual {last.norm_r / last.norm_b:.2e}{self._extra(infos)}", flush=True)
        return q

    def __step__(self, q, dt: float):
        if self._use_jit_solver():
            q_new, info = self._solve_device(q, dt)
            self._report([info])
            if self.verbose > 0:
                print(f"FGMRES(jit) {'convergence' if info.converged else 'stagnation'} "
                      f"at iteration {info.num_iter}, relative residual "
                      f"{info.norm_r / info.norm_b:.2e}{self._extra([info])}", flush=True)
            return q_new

        A = make_rat_matvec(self.rhs, q, dt)
        q_flat = q.reshape(-1)
        b = A(q_flat) + self.rhs(q).reshape(-1) * dt
        maxiter = (400 if self.preconditioner is not None else self.max_iterations) // self.gmres_restart
        solve = gcrot if self.linear_solver == "gcrot" else fgmres
        t0 = time()
        q_new, norm_r, norm_b, num_iter, flag, residuals = solve(
            A, b, x0=q_flat, tol=self.tol, restart=self.gmres_restart, maxiter=maxiter,
            preconditioner=self.preconditioner, verbose=self.verbose,
        )
        t1 = time()
        self.solver_info = SolverInfo(total_num_it=num_iter, converged=(flag == 0), residuals=residuals)
        self.failure_flag = flag
        if self.verbose > 0:
            kind = "convergence" if flag == 0 else "stagnation"
            print(f"{solve.__name__} {kind} at iteration {num_iter} in {t1-t0:4.3f} s, "
                  f"relative residual {norm_r/norm_b:.2e}", flush=True)
        return q_new.reshape(q.shape)
