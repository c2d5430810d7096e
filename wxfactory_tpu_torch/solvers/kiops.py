"""KIOPS: adaptive Krylov evaluation of linear combinations of phi-functions.

Computes  w(i) = phi_0(tau_i A) u_0 + phi_1(tau_i A) u_1 + ...  with the
augmented-matrix trick, incomplete orthogonalization (IOP-2) and joint
adaptivity of the substep size tau and the Krylov dimension m (Gaudreault,
Rainwater & Tokman 2018, JCP; the reference's solvers/kiops.py).

Counterpart of ``wxfactory_tpu/solvers/kiops.py``, line for line: it is the
adaptivity reference, so its controller, IOP-2, the augmented matrix, the
phantom outputs and the guards are the same. The Krylov basis ``V`` lives on
the state's device as one ``(mmax+1, n+p)`` float64 tensor, and the matvec,
the projections and the updates run there; ``H``, the controller and the
small ``(m+1) x (m+1)`` matrix exponential (scipy) stay on the host in
float64. Each Arnoldi iteration brings its IOP-2 projections and the new
vector's squared norm to the host in one transfer (the ``nrm < tol`` test
needs them): one host sync an iteration, plus one for the input's scale and
one for each restart's norm, all counted (``common.device.host_read``); the
small vectors go back through pinned memory without a wait
(``common.device.to_device``), so a solve runs inside
``forbid_uncounted_syncs``.
"""

import math
from typing import Callable, Sequence, Tuple

import numpy as np
import scipy.linalg
import torch

from ..common.device import host_read, to_device
from .stats import PhiStats


def kiops(
    tau_out: Sequence[float],
    A: Callable,
    u: torch.Tensor,
    tol: float = 1e-7,
    m_init: int = 10,
    mmin: int = 10,
    mmax: int = 128,
    iop: int = 2,
    task1: bool = False,
) -> Tuple[torch.Tensor, PhiStats]:
    """Evaluate phi-function combinations at the times in `tau_out`.

    `u` has shape (p+1, n): row 0 multiplies phi_0, row k multiplies phi_k.
    `A` maps a flat float64 tensor of n to one on the same device.
    Returns (w, stats) with w of shape (len(tau_out), n) on u's device.
    """
    u = torch.as_tensor(u).to(torch.float64)
    dev = u.device
    tau_out = np.asarray(tau_out, dtype=np.float64)
    ppo, n = u.shape
    p = ppo - 1
    if p == 0:
        p = 1
        u = torch.cat([u, torch.zeros((1, n), dtype=u.dtype, device=dev)])

    m = max(mmin, min(m_init, mmax))

    V = torch.zeros((mmax + 1, n + p), dtype=torch.float64, device=dev)
    H = np.zeros((mmax + 1, mmax + 1))

    stats = PhiStats()
    sgn = float(np.sign(tau_out[-1]))
    tau_now = 0.0
    tau_end = float(abs(tau_out[-1]))
    happy = False
    j = 0

    num_steps = len(tau_out)
    w = torch.zeros((num_steps, n), dtype=torch.float64, device=dev)
    w[0, :] = u[0, :]

    # Scale the phi-coefficient rows to unit order of magnitude.
    norm_u = float(host_read(u[1:, :].abs().sum(dim=1).max()))
    if ppo > 1 and norm_u > 0:
        ex = math.ceil(math.log2(norm_u))
        nu, mu = 2.0**-ex, 2.0**ex
    else:
        nu, mu = 1.0, 1.0
    u_flip = nu * torch.flip(u[1:, :], dims=[0])

    tau = tau_end
    if tau_end > 1:
        gamma, gamma_mmax = 0.2, 0.1
    else:
        gamma, gamma_mmax = 0.9, 0.6
    delta = 1.4

    oldm, oldtau, omega = -1, math.nan, math.nan
    order_old, kest_old = True, True
    order = 0.0
    kest = 2.0
    ireject = 0
    l = 0
    beta = 0.0

    while tau_now < tau_end:
        if j == 0:
            # (Re)start the Krylov space from the current solution.
            V[0, :n] = w[l, :]
            head = [(tau_now ** (p - k + 1)) / math.factorial(p - k + 1) * mu for k in range(p - 1)] + [mu]
            V[0, n:] = to_device(head, V)
            beta = math.sqrt(float(host_read(torch.dot(V[0, :n], V[0, :n]) + torch.dot(V[0, n:], V[0, n:]))))
            V[0, :] /= beta

        # --- Incomplete orthogonalization (IOP) Arnoldi
        while j < m:
            j += 1
            # Augmented matrix-vector product
            V[j, :n] = A(V[j - 1, :n]) + V[j - 1, n : n + p] @ u_flip
            V[j, n : n + p - 1] = V[j - 1, n + 1 : n + p]
            V[j, n + p - 1 :].zero_()

            ilow = max(0, j - iop)
            h = V[ilow:j, :] @ V[j, :]
            V[j, :] -= h @ V[ilow:j, :]
            hn = np.asarray(host_read(torch.cat([h, torch.dot(V[j, :], V[j, :])[None]])))
            H[ilow:j, j - 1] = hn[:-1]

            nrm = math.sqrt(hn[-1])
            if nrm < tol:
                happy = True
                break
            H[j, j - 1] = nrm
            V[j, :] /= nrm
            stats.krylov_steps += 1

        # phi_1 coupling for the error estimate
        H[0, j] = 1.0
        nrm = H[j, j - 1]
        H[j, j - 1] = 0.0
        F = scipy.linalg.expm(sgn * tau * H[: j + 1, : j + 1])
        stats.num_expm += 1
        H[j, j - 1] = nrm

        if happy:
            omega, err = 0.0, 0.0
            tau_new, m_new = min(tau_end - (tau_now + tau), tau), m
            happy = False
        else:
            # Local truncation error and the omega controller. Guard every
            # estimate against non-finite values (overflowing expm / lost
            # IOP orthogonality at large m force a clean rejection instead
            # of NaNs propagating into the controller).
            err = abs(beta * nrm * F[j - 1, j])
            oldomega = omega
            omega = tau_end * err / (tau * tol)
            if not math.isfinite(omega):
                omega = 1e300  # forces rejection below with finite arithmetic

            if m == oldm and tau != oldtau and ireject >= 1 and oldomega > 0 and math.isfinite(oldomega):
                try:
                    order = max(1.0, math.log(omega / oldomega) / math.log(tau / oldtau))
                except (ValueError, ZeroDivisionError, OverflowError):
                    order = max(1.0, j / 4)
                order_old = False
            elif order_old or ireject == 0:
                order_old = True
                order = j / 4
            else:
                order_old = True
            if not math.isfinite(order) or order <= 0:
                order = max(1.0, j / 4)

            if m != oldm and tau == oldtau and ireject >= 1 and oldomega > 0 and math.isfinite(oldomega):
                try:
                    kest = max(1.1, (omega / oldomega) ** (1.0 / (oldm - m)))
                except (ValueError, ZeroDivisionError, OverflowError):
                    kest = 2.0
                kest_old = False
            elif kest_old or ireject == 0:
                kest_old = True
                kest = 2.0
            else:
                kest_old = True
            if not math.isfinite(kest) or kest <= 1.0:
                kest = 2.0

            remaining_time = tau_end - tau_now if omega > delta else tau_end - (tau_now + tau)

            same_tau = min(remaining_time, tau)
            tau_opt = tau * (gamma / omega) ** (1.0 / order)
            tau_opt = min(remaining_time, max(tau / 5, min(5 * tau, tau_opt)))
            try:
                m_opt = math.ceil(j + math.log(omega / gamma) / math.log(kest))
            except (ValueError, OverflowError):
                m_opt = j
            m_opt = max(mmin, min(mmax, max(math.floor(3 / 4 * m), min(m_opt, math.ceil(4 / 3 * m)))))

            if j == mmax:
                if omega > delta:
                    m_new = j
                    tau_new = tau * (gamma_mmax / omega) ** (1.0 / order)
                    tau_new = min(tau_end - tau_now, max(tau / 5, tau_new))
                else:
                    tau_new, m_new = tau_opt, m
            else:
                m_new, tau_new = m_opt, same_tau

        if omega <= delta:
            # Accept the substep.
            stats.rejected += ireject
            stats.substeps += 1

            # Produce outputs that fall inside (tau_now, tau_now + tau).
            blown = 0
            next_t = tau_now + tau
            for k in range(l, num_steps):
                if abs(tau_out[k]) < abs(next_t):
                    blown += 1
            if blown:
                w[l + blown, :] = w[l, :]
                for k in range(blown):
                    tau_phantom = tau_out[l + k] - tau_now
                    F2 = scipy.linalg.expm(sgn * tau_phantom * H[:j, :j])
                    w[l + k, :] = beta * (to_device(F2[:j, 0], V) @ V[:j, :n])
                l += blown

            w[l, :] = beta * (to_device(F[:j, 0], V) @ V[:j, :n])
            tau_now += tau
            j = 0
            ireject = 0
            stats.error_estimate += err
        else:
            ireject += 1
            H[0, j] = 0.0

        oldtau, tau = tau, tau_new
        oldm, m = m, m_new
        if tau <= 0.0 and tau_now < tau_end:
            tau = tau_end - tau_now  # finish the residual rounding sliver

    if task1:
        for k in range(num_steps):
            w[k, :] /= tau_out[k]

    stats.last_krylov_size = m
    return w, stats
