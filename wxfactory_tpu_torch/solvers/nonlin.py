"""Jacobian-free Newton-Krylov nonlinear solver.

Counterpart of ``wxfactory_tpu/solvers/nonlin.py`` (the reference's
solvers/nonlin.py:12-218: scipy-style newton_krylov with an FGMRES inner
solve, the Armijo line search and the Eisenstat-Walker forcing term).

The JAX package linearises F with ``jax.jvp``. A kernel launched through
ctypes has no derivative (``solvers/matvec.py``), so here the caller passes
a Jacobian-action factory ``jac(x) -> (v -> J_F(x).v)`` on flat tensors,
which the integrators build from the RHS's own linearisation
(``matvec.make_jvp_matvec``: one tangent prep per Newton iteration, one
tangent apply per FGMRES matvec on the card). Without ``jac``,
``torch.func.jvp`` of F serves on the CPU only; on the card a missing
``jac`` raises.

The iterate and F stay on the state's device; the inner solve is the
port's ``solvers/fgmres.py``; the norms the controls need come to the host
in counted reads (one for |F|_2, |F|_inf and |x|_inf together, one for
|dx|_inf, one per line-search evaluation), and the Armijo search
(scipy's ``scalar_search_armijo``) runs on host floats as in the JAX
package.
"""

from time import time
from typing import Callable, Optional

import numpy as np
import torch
from scipy.optimize._linesearch import scalar_search_armijo

from ..common.device import host_read
from .fgmres import fgmres


def _jvp_factory(F: Callable) -> Callable:
    """``x -> (v -> J_F(x).v)`` by ``torch.func.jvp`` (the CPU fallback)."""
    def jac(x):
        x_frozen = x.clone()
        return lambda v: torch.func.jvp(F, (x_frozen,), (v,))[1]

    return jac


def _norms(x: torch.Tensor, fx: torch.Tensor):
    """(|F|_2, |F|_inf, |x|_inf) in one host read."""
    return host_read(torch.stack([torch.linalg.vector_norm(fx), fx.abs().max(), x.abs().max()]))


def newton_krylov(
    F: Callable,
    x0: torch.Tensor,
    jac: Optional[Callable] = None,
    f_tol: Optional[float] = None,
    f_rtol: float = np.inf,
    x_tol: float = np.inf,
    x_rtol: float = np.inf,
    fgmres_restart: int = 30,
    fgmres_maxiter: int = 1,
    fgmres_precond: Optional[Callable] = None,
    line_search: Optional[str] = "armijo",
    maxiter: Optional[int] = None,
    verbose: bool = False,
):
    """Solve F(x) = 0 for a state-shaped ``x0``. ``F`` maps a state-shaped
    tensor to one; ``jac(x)``, for a flat ``x``, returns ``v -> J_F(x).v``
    on flat tensors. Returns (x, num_iterations, residual_history)."""
    t_start = time()
    shape = x0.shape
    if jac is None:
        if x0.device.type != "cpu":
            raise NotImplementedError(
                f"newton_krylov on {x0.device} needs a Jacobian-action factory jac(x): torch.func.jvp cannot "
                "pass through a kernel")
        jac = _jvp_factory(lambda z: F(z.reshape(shape)).reshape(-1))

    if f_tol is None:
        f_tol = float(np.finfo(np.float64).eps ** (1.0 / 3.0))
    if maxiter is None:
        maxiter = 100 * (int(np.prod(shape)) + 1)

    def fx_fun(x_in):
        return F(x_in.reshape(shape)).reshape(-1)

    x = x0.reshape(-1).to(torch.float64)
    fx = fx_fun(x)
    fx_norm, f_inf, x_inf = _norms(x, fx)

    # Eisenstat-Walker forcing parameters
    gamma, eta_max, eta_threshold = 0.9, 0.9999, 0.1
    eta = 1e-3

    residuals = []
    f0_norm = None
    dx_inf = np.inf
    iteration = 0

    for _ in range(maxiter):
        iteration += 1
        residuals.append((f_inf, time() - t_start, 0.0))
        if f0_norm is None:
            f0_norm = f_inf

        if f_inf == 0.0 or (
            f_inf <= f_tol and f_inf / f_rtol <= f0_norm and dx_inf <= x_tol and dx_inf / x_rtol <= x_inf
        ):
            break

        # Inexact Newton: solve J dx = -F to the forcing tolerance.
        tol = min(eta, eta * fx_norm)
        sol, *_ = fgmres(jac(x), fx, tol=tol, restart=fgmres_restart, maxiter=fgmres_maxiter,
                         preconditioner=fgmres_precond)
        dx = -sol
        dx_inf = host_read(dx.abs().max())

        if line_search == "armijo":
            x, fx = _armijo_step(fx_fun, x, fx, dx)
        else:
            x = x + dx
            fx = fx_fun(x)
        fx_norm_new, f_inf, x_inf = _norms(x, fx)

        # Eisenstat-Walker update of the forcing term
        eta_a = gamma * fx_norm_new**2 / fx_norm**2 if fx_norm > 0 else eta_max
        if gamma * eta**2 < eta_threshold:
            eta = min(eta_max, eta_a)
        else:
            eta = min(eta_max, max(eta_a, gamma * eta**2))
        fx_norm = fx_norm_new

        if verbose:
            print(f"newton_krylov {iteration:3d}: |F|_inf = {f_inf:.3e}", flush=True)
    else:
        print("newton_krylov: maximum iterations reached", flush=True)

    return x.reshape(shape), iteration, residuals


def _armijo_step(fx_fun, x, fx, dx):
    """Armijo backtracking on phi(s) = |F(x + s*dx)|^2; (x_new, F(x_new))."""
    cache = {}

    def phi(s):
        if s in cache:
            return cache[s]
        val = fx_fun(x + s * dx)
        norm2 = host_read(val @ val)
        cache[s] = norm2
        cache[(s, "v")] = val
        return norm2

    phi0 = host_read(fx @ fx)
    s, _ = scalar_search_armijo(phi, phi0, -phi0, amin=1e-2)
    if s is None:
        s = 1.0
        phi(s)
    fx_new = cache.get((s, "v"))
    if fx_new is None:
        fx_new = fx_fun(x + s * dx)
    return x + s * dx, fx_new
