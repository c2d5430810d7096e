"""Matrix-free Jacobian-action operators on torch tensors.

Counterpart of ``wxfactory_tpu/solvers/matvec.py``. The Jacobian action is
exact: through the RHS's own linearisation when it has one
(``jtv_prep``/``jtv_apply``: the tangent kernels of the 3D Euler and
shallow-water operators on a GPU, as the JAX package's Epi takes its fused Jacobian action,
integrators/epi.py:181-195 there), otherwise ``torch.func.jvp`` of the RHS,
which needs an RHS written in differentiable torch (a kernel launched
through ctypes has no derivative). The float32 companion of a
mixed-precision Krylov loop follows the JAX package's own rule
(``companion_jacobian``). The linearisation point's preparation runs once
per closure. The finite-difference form is kept as a parity and debug
mode.

Every closure counts the Jacobian actions it is asked for in
``jacobian_actions``, and every linearisation point prepared through an
RHS's ``jtv_prep`` in ``linearisations``, so a run can hold the tangent
kernels' launches against them.
"""

from typing import Callable, Optional

import numpy as np
import torch

# Jacobian actions asked of every closure made here, and the linearisation
# points (``jtv_prep`` calls) their Jacobian actions were prepared at.
jacobian_actions = 0
linearisations = 0


def _prepared(rhs, q) -> Callable:
    """``v -> J(q).v`` through ``rhs.jtv_prep(q)`` once and
    ``rhs.jtv_apply`` a call; counts the preparation."""
    global linearisations
    linearisations += 1
    prep = rhs.jtv_prep(q)
    return lambda v: rhs.jtv_apply(prep, v)


def jacobian(rhs: Callable, q: torch.Tensor) -> Callable:
    """``v -> J(q).v`` (state-shaped in and out), uncounted."""
    if hasattr(rhs, "jtv_prep"):
        return _prepared(rhs, q)
    return lambda v: torch.func.jvp(rhs, (q,), (v,))[1]


def companion_jacobian(rhs32: Callable, q32: torch.Tensor) -> Callable:
    """``v -> J(q32).v`` of the float32 companion ``rhs32`` of a
    mixed-precision Krylov loop, uncounted, by the JAX package's rule
    (integrators/epi.py:181-200 and integrators/rosenbrock.py:104-117
    there): the companion's own Jacobian action when it has one
    (``jtv_prep``/``jtv_apply``: the perturbation tangent kernel of the 3D
    companion; the SW companion's, the absolute float32 operator's J.v at
    q32, which is what ``jax.jvp`` of its ``xla`` form gives there), else
    ``torch.func.jvp`` of its ``xla`` form when it has one (the absolute
    operator of its dtype), else of the companion itself. A kernel launched
    through ctypes has no derivative, so off the CPU a companion without
    ``jtv_prep`` raises."""
    if hasattr(rhs32, "jtv_prep"):
        return _prepared(rhs32, q32)
    if q32.device.type != "cpu":
        raise NotImplementedError(
            f"the float32 companion has no Jacobian-action kernel (jtv_prep), and torch.func.jvp cannot pass "
            f"through a kernel on {q32.device}"
        )
    fn = getattr(rhs32, "xla", rhs32)
    return lambda v: torch.func.jvp(fn, (q32,), (v,))[1]


def make_jvp_matvec(rhs: Callable, q: torch.Tensor, dt: float = 1.0, jac: Optional[Callable] = None) -> Callable:
    """Return ``v -> dt * J(q).v`` on flat vectors (cast to q's dtype for
    the action and back: the Krylov basis is float64). ``jac`` is the
    state-shaped action, ``jacobian(rhs, q)`` when None (a float32
    companion passes ``companion_jacobian``)."""
    shape = q.shape
    jac = jacobian(rhs, q) if jac is None else jac

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


def make_rat_matvec(rhs: Callable, q: torch.Tensor, dt: float, jac: Optional[Callable] = None) -> Callable:
    """Return ``v -> v - dt/2 * J(q).v``, the system operator of the Ros2 /
    Crank-Nicolson rational form (reference solvers/matvec.py:76-88), on
    flat vectors of any dtype (the action runs in q's dtype; ``jac`` as in
    ``make_jvp_matvec``). dt/2 multiplies a float32 action as
    ``float32(dt/2)``."""
    shape = q.shape
    jac = jacobian(rhs, q) if jac is None else jac
    half_dt = 0.5 * dt

    def matvec(v):
        global jacobian_actions
        jacobian_actions += 1
        return v - half_dt * jac(v.reshape(shape).to(q.dtype)).reshape(-1).to(v.dtype)

    return matvec
