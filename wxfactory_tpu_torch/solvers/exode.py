"""EXODE: phi-function combinations by adaptive explicit RK integration.

Counterpart of ``wxfactory_tpu/solvers/exode.py``: the combination
w = phi_0(A)u_0 + phi_1(A)u_1 + ... equals y(1) of the augmented ODE

    y' = A y + sum_j t^j / j! * u_{j+1},   y(0) = u_0,

integrated over [0, 1] with an adaptive embedded Runge-Kutta pair
(``solvers/erk.py``). The state and every stage stay on the state's device
(each stage evaluation one matvec); the controller reads one host value an
attempt. The step-size warm start persists across calls like the
reference's ``exode.first_step`` (reference exode.py:23,133).
"""

import math
from typing import Callable

import torch

from .erk import erk_integrate
from .stats import PhiStats

_state = {"first_step": None}


def exode(
    tau_out,
    A: Callable,
    u: torch.Tensor,
    method: str = "BS3(2)",
    controller: str = "deadbeat",
    rtol: float = 1e-3,
    atol: float = 1e-6,
    task1: bool = False,
):
    """`u` has shape (p+1, n) on the state's device and `A` maps a flat
    float64 tensor of n to one there; returns (w, stats) with w of shape
    (1, n)."""
    u = torch.as_tensor(u).to(torch.float64)
    ppo, n = u.shape
    p = ppo - 1
    if p == 0:
        p = 1
        u = torch.cat([u, torch.zeros((1, n), dtype=u.dtype, device=u.device)])

    y0 = u[0].clone()
    tau_f = float(torch.as_tensor(tau_out, dtype=torch.float64).reshape(-1)[-1])

    def fun(t, x):
        ret = A(x).clone()
        for j in range(p):
            ret += t**j / math.factorial(j) * u[j + 1]
        return ret

    first_step = _state["first_step"]
    if not (first_step is not None and 0 < first_step < tau_f):
        first_step = tau_f

    res = erk_integrate(
        fun, 0.0, y0, tau_f,
        method=method, controller=controller,
        rtol=rtol, atol=atol, first_step=first_step,
    )
    if res.status != "finished":
        raise RuntimeError(f"EXODE integration failed (steps={res.num_steps}, failed={res.failed_steps})")

    if res.h_mean > 0:
        _state["first_step"] = res.h_mean

    w = res.y[None, :]
    if task1:
        w = w / tau_f

    stats = PhiStats()
    stats.krylov_steps = res.nfev
    stats.substeps = res.num_steps
    stats.last_krylov_size = 1
    return w, stats
