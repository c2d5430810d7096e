"""PMEX: projection-based exponential integrator phi-solver.

Counterpart of ``wxfactory_tpu/solvers/pmex.py``, line for line: the same
task as KIOPS (linear combinations of phi-functions times vectors) with full
orthogonalization by a two-step Gauss-Seidel projection onto the orthogonal
complement, a norm *estimate* from the same Gram products (one reduction an
iteration), and a step-halving local error estimate (the reference's
solvers/pmex.py). The augmented Krylov basis ``V`` lives on the state's
device as one ``(mmax+1, n+p)`` float64 tensor, and the matvec, the batched
Gram block ``V[:j+1] @ V[j-1:j+1].T`` and the projection run there; the
Gram block comes to the host in one transfer an iteration (the projection
coefficients and the norm estimate need it; the coefficients go back
through pinned memory without a wait, ``common.device.to_device``, so the
loop runs inside ``forbid_uncounted_syncs``), where the Gauss-Seidel
matrices ``M``, ``N``, ``Minv``, the triangular solve, the small matrix
exponential (scipy) and the controller stay in float64. Where the estimate
cancels, the explicit norm costs a second read.
"""

import math
from typing import Callable, Sequence, Tuple

import numpy as np
import scipy.linalg
import torch

from ..common.device import host_read, to_device, to_host
from .stats import PhiStats


def pmex(
    tau_out: Sequence[float],
    A: Callable,
    u: torch.Tensor,
    tol: float = 1e-7,
    delta: float = 1.2,
    m_init: int = 10,
    mmin: int = 10,
    mmax: int = 128,
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
    Minv = np.eye(mmax)
    M = np.eye(mmax)
    N = np.zeros((mmax, mmax))

    stats = PhiStats()
    sgn = float(np.sign(tau_out[-1]))
    tau_now = 0.0
    tau_end = float(abs(tau_out[-1]))
    happy = False
    j = 0
    num_steps = len(tau_out)
    w = torch.zeros((num_steps, n), dtype=torch.float64, device=dev)
    w[0, :] = u[0, :]

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

    old_m, old_tau, ohm = -1, math.nan, math.nan
    kest, kest_old = 2.0, True
    ireject = 0
    l = 0
    beta = 0.0

    while tau_now < tau_end:
        if j == 0:
            H[:, :] = 0.0
            V[0, :n] = w[l, :]
            head = [(tau_now ** (p - k + 1)) / math.factorial(p - k + 1) * mu for k in range(p - 1)] + [mu]
            V[0, n:] = to_device(head, V)
            beta = math.sqrt(float(host_read(torch.dot(V[0, :n], V[0, :n]) + torch.dot(V[0, n:], V[0, n:]))))
            V[0, :] /= beta

        while j < m:
            j += 1
            # Augmented matrix-vector product
            V[j, :n] = A(V[j - 1, :n]) + V[j - 1, n : n + p] @ u_flip
            V[j, n : n + p - 1] = V[j - 1, n + 1 : n + p]
            V[j, n + p - 1 :].zero_()

            # One batched Gram product gives both the projection coefficients
            # and the data for the norm estimate: one host read an iteration.
            gram = to_host(V[: j + 1, :] @ V[j - 1 : j + 1, :].T)  # (j+1, 2)

            # Two-step Gauss-Seidel projection onto the orthogonal complement
            if j > 1:
                M[j - 1, : j - 1] = gram[: j - 1, 0]
                N[: j - 1, j - 1] = -gram[: j - 1, 0]
                Minv[j - 1, : j - 1] = -gram[: j - 1, 0].T @ Minv[: j - 1, : j - 1]
            rhs_vec = (np.eye(j) + N[:j, :j] @ Minv[:j, :j]) @ gram[:j, 1]
            sol = scipy.linalg.solve_triangular(M[:j, :j], rhs_vec, lower=True, unit_diagonal=True)
            V[j, :] -= to_device(sol, V) @ V[:j, :]

            # Norm estimate from the Gram data (long-double accumulation),
            # falling back to an explicit norm when cancellation is severe.
            sum_sqrd = float(np.sum(np.array(gram[:j, 1], np.longdouble) ** 2))
            if gram[-1, 1] < sum_sqrd:
                curr_nrm = math.sqrt(float(host_read(torch.dot(V[j, :], V[j, :]))))
            else:
                curr_nrm = float(np.sqrt(np.longdouble(gram[-1, 1]) - sum_sqrd))

            if curr_nrm < tol:
                happy = True
                break

            V[j, :] /= curr_nrm
            H[j, j - 1] = curr_nrm
            H[:j, j - 1] = sol
            stats.krylov_steps += 1

        H[0, j] = 1.0
        nrm = H[j, j - 1]
        H[j, j - 1] = 0.0
        F_half = scipy.linalg.expm(sgn * 0.5 * tau * H[: j + 1, : j + 1])
        F = F_half @ F_half
        stats.num_expm += 1
        H[j, j - 1] = nrm

        if happy:
            ohm, err = 0.0, 0.0
            tau_new, m_new = min(tau_end - (tau_now + tau), tau), m
            happy = False
        else:
            err_half = abs(beta * nrm * F_half[j - 1, j])
            err = abs(beta * nrm * F[j - 1, j])

            old_ohm = ohm
            ohm = tau_end * err / (tau * tol)
            # Step-halving order estimate
            order = math.log(err / err_half) / math.log(2) if err_half > 0 else j / 4

            if m != old_m and tau == old_tau and ireject >= 1:
                kest = max(1.1, (ohm / old_ohm) ** (1.0 / (old_m - m)))
                kest_old = False
            elif kest_old or ireject == 0:
                kest, kest_old = 2.0, True
            else:
                kest_old = True

            remaining_time = tau_end - tau_now if ohm > delta else tau_end - (tau_now + tau)
            same_tau = min(remaining_time, tau)
            tau_opt = tau * (gamma / ohm) ** (1.0 / order)
            tau_opt = min(remaining_time, max(tau / 5, min(5 * tau, tau_opt)))
            m_opt = math.ceil(j + math.log(ohm / gamma) / math.log(kest))
            m_opt = max(mmin, min(mmax, max(math.floor(3 / 4 * m), min(m_opt, math.ceil(4 / 3 * m)))))

            if j == mmax:
                if ohm > delta:
                    m_new = j
                    tau_new = tau * (gamma_mmax / ohm) ** (1.0 / order)
                    tau_new = min(tau_end - tau_now, max(tau / 5, tau_new))
                else:
                    tau_new, m_new = tau_opt, m
            else:
                m_new = m if same_tau < tau else m_opt
                tau_new = same_tau

        if ohm <= delta:
            stats.rejected += ireject
            stats.substeps += 1

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

        old_tau, tau = tau, tau_new
        old_m, m = m, m_new

    if task1:
        for k in range(num_steps):
            w[k, :] /= tau_out[k]

    stats.last_krylov_size = m
    return w, stats
