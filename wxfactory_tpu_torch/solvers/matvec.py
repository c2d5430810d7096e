"""Matrix-free Jacobian-action operators on torch tensors.

Counterpart of ``wxfactory_tpu/solvers/matvec.py``. The Jacobian action is
exact: through the RHS's own linearisation when it has one
(``jtv_prep``/``jtv_apply``, the tangent mode of the 3D Euler kernel on a
GPU, as the JAX package's Epi takes its fused Jacobian action,
integrators/epi.py:181-195 there), otherwise ``torch.func.jvp`` of the RHS,
which needs an RHS written in differentiable torch (a kernel launched
through ctypes has no derivative). The linearisation point's preparation
runs once per closure. The finite-difference form is kept as a parity and
debug mode.

Every closure counts the Jacobian actions it is asked for in
``jacobian_actions``, so a run can hold the tangent kernel's launches
against them.
"""

from typing import Callable

import numpy as np
import torch

# Jacobian actions asked of every closure made here.
jacobian_actions = 0


def jacobian(rhs: Callable, q: torch.Tensor) -> Callable:
    """``v -> J(q).v`` (state-shaped in and out), uncounted."""
    if hasattr(rhs, "jtv_prep"):
        prep = rhs.jtv_prep(q)
        return lambda v: rhs.jtv_apply(prep, v)
    return lambda v: torch.func.jvp(rhs, (q,), (v,))[1]


def make_jvp_matvec(rhs: Callable, q: torch.Tensor, dt: float = 1.0) -> Callable:
    """Return ``v -> dt * J(q).v`` on flat vectors (cast to q's dtype for
    the action and back: the Krylov basis is float64)."""
    shape = q.shape
    jac = jacobian(rhs, q)

    def matvec(v):
        global jacobian_actions
        jacobian_actions += 1
        return dt * jac(v.reshape(shape).to(q.dtype)).reshape(-1).to(v.dtype)

    return matvec


def make_fd_matvec(rhs: Callable, q: torch.Tensor, rhs_q: torch.Tensor, dt: float = 1.0) -> Callable:
    """Finite-difference Jacobian action (parity/debug mode, the reference's
    method='fd': eps = sqrt(float32 eps))."""
    shape = q.shape
    epsilon = float(np.sqrt(np.finfo(np.float32).eps))

    def matvec(v):
        global jacobian_actions
        jacobian_actions += 1
        qvec = q + epsilon * v.reshape(shape)
        return dt * ((rhs(qvec) - rhs_q) / epsilon).reshape(-1)

    return matvec


def make_rat_matvec(rhs: Callable, q: torch.Tensor, dt: float) -> Callable:
    """Return ``v -> v - dt/2 * J(q).v``, the system operator of the Ros2 /
    Crank-Nicolson rational form (reference solvers/matvec.py:76-88)."""
    shape = q.shape
    jac = jacobian(rhs, q)
    half_dt = 0.5 * dt

    def matvec(v):
        global jacobian_actions
        jacobian_actions += 1
        return v - half_dt * jac(v.reshape(shape).to(q.dtype)).reshape(-1).to(v.dtype)

    return matvec
