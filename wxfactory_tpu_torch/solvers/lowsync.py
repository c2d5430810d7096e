"""Low-synchronization Krylov phi-function solvers.

Counterpart of ``wxfactory_tpu/solvers/lowsync.py``, line for line: ONE
engine, ``lowsync_phi``, hosts the orthogonalization schemes CWY and ICWY
crossed with the synchronization structures of the family, each a
different way to reach ONE global reduction per Arnoldi iteration:

  * ``ne``   - norm ESTIMATE: normalize the new vector at once with the
               Pythagorean estimate ||v - Vh||^2 = ||v||^2 - ||h||^2 read
               off the same fused Gram product, with an exact-norm fallback
               reduction under cancellation;
  * ``1s``   - LAGGED exact normalization: the new vector stays
               unnormalized, its true norm arrives in the NEXT iteration's
               fused product (the matvec is linear, so both rows rescale),
               and H[j-1, j-2] is written one iteration late; one extra
               reduction normalizes the final basis vector after the loop;
  * ``ne1s`` - both: normalize now with the estimate, rescale with the true
               norm when it arrives next iteration;

plus ``neiop`` (the norm estimate over an incomplete-orthogonalization
window, iop = 2: ``icwy_neiop``, ``kiops_nest``) and ``dcgs2`` (delayed
classical Gram-Schmidt-2, its own inner loop: the second pass of vector j
rides the reduction of iteration j+1; an exact norm makes it 2 a step).

CWY and ICWY differ in the T-matrix correction:
  T[j,:j] = -gram^T @ T  (compact WY)
  T[j,:j] = -gram        (inverse compact WY, Neumann)

The augmented Krylov basis ``V`` lives on the state's device as one
``(mmax+1, n+p)`` float64 tensor; the matvec, the fused Gram product
``V[:j+1] @ V[j-1:j+1].T`` (one ``torch.matmul``) and the vector updates run
there. Every global reduction of the JAX package's engine (its ``_count``
sites) is exactly one counted host read here (``common.device.to_host`` /
``host_read``), so ``NUM_REDUCTIONS`` keeps its meaning and the card's
``host_syncs`` show the family's one synchronization an iteration. The
coefficients go back to the card through pinned memory without a wait
(``common.device.to_device``), and the input scaling (``nu``, ``mu``) is
computed on the card, so the Arnoldi loop runs inside
``forbid_uncounted_syncs``. T, H, the Pythagorean estimate (in
``np.longdouble``), the small matrix exponential (scipy) and the controller
stay on the host in float64.
"""

import math
from typing import Callable, Sequence, Tuple

import numpy as np
import scipy.linalg
import torch

from ..common.device import host_read, to_device, to_host
from .stats import PhiStats

# Global-reduction accounting: every site that is one counted host read
# (an allreduce in the reference) bumps this.
NUM_REDUCTIONS = 0


def _gram(V: torch.Tensor, rows: slice, cols: slice) -> np.ndarray:
    """``V[rows] @ V[cols].T`` on the host: one global reduction."""
    global NUM_REDUCTIONS
    NUM_REDUCTIONS += 1
    return to_host(V[rows, :] @ V[cols, :].T)


def _exact_norm(row: torch.Tensor) -> float:
    """The 2-norm of ``row`` on the host: one global reduction."""
    global NUM_REDUCTIONS
    NUM_REDUCTIONS += 1
    return math.sqrt(float(host_read(torch.dot(row, row))))


def _pythagoras(own_sq: float, coeffs: np.ndarray) -> float:
    """Norm estimate of the orthogonalized vector from the fused Gram data;
    -1.0 when cancellation invalidates it (the caller falls back to an
    exact norm)."""
    sum_sqrd = float(np.sum(np.array(coeffs, np.longdouble) ** 2))
    if own_sq >= sum_sqrd:
        return float(np.sqrt(np.longdouble(own_sq) - sum_sqrd))
    return -1.0


class _Setup:
    """The start of every phi evaluation of the family: the padded input,
    its scaling on the card, the output rows and the controller's
    constants."""

    def __init__(self, tau_out, A, u, mmax):
        self.A = A
        u = torch.as_tensor(u).to(torch.float64)
        self.dev = u.device
        self.tau_out = np.asarray(tau_out, dtype=np.float64)
        ppo, n = u.shape
        p = ppo - 1
        if p == 0:
            p = 1
            u = torch.cat([u, torch.zeros((1, n), dtype=u.dtype, device=self.dev)])
        self.n, self.p = n, p
        self.V = torch.zeros((mmax + 1, n + p), dtype=torch.float64, device=self.dev)
        self.num_steps = len(self.tau_out)
        self.w = torch.zeros((self.num_steps, n), dtype=torch.float64, device=self.dev)
        self.w[0, :] = u[0, :]
        # nu = 2^-ceil(log2 |u|), mu = 1/nu, on the card (no host read).
        norm_u = u[1:, :].abs().sum(dim=1).max()
        ex = torch.nan_to_num(torch.ceil(torch.log2(norm_u)), neginf=0.0)  # norm_u = 0: 1
        if ppo > 1:
            self.nu, self.mu = torch.exp2(-ex), torch.exp2(ex)
        else:
            self.nu = self.mu = torch.ones((), dtype=torch.float64, device=self.dev)
        self.u_flip = self.nu * torch.flip(u[1:, :], dims=[0])
        self.sgn = float(np.sign(self.tau_out[-1]))
        self.tau_end = float(abs(self.tau_out[-1]))
        self.gamma, self.gamma_mmax = (0.2, 0.1) if self.tau_end > 1 else (0.9, 0.6)

    def start(self, l: int, tau_now: float) -> None:
        """Row 0 of the basis: the current output and the phi rows' tail."""
        V, n, p = self.V, self.n, self.p
        V[0, :n] = self.w[l, :]
        head = [(tau_now ** (p - k + 1)) / math.factorial(p - k + 1) for k in range(p - 1)] + [1.0]
        V[0, n:] = to_device(head, V) * self.mu

    def extend(self, j: int) -> None:
        """The augmented matvec into row j."""
        V, n, p = self.V, self.n, self.p
        V[j, :n] = self.A(V[j - 1, :n]) + V[j - 1, n : n + p] @ self.u_flip
        V[j, n : n + p - 1] = V[j - 1, n + 1 : n + p]
        V[j, n + p - 1 :].zero_()

    def combine(self, coeffs, rows: int) -> torch.Tensor:
        """``coeffs @ V[:rows, :n]`` on the card."""
        return to_device(coeffs, self.V) @ self.V[:rows, : self.n]


# An error ratio above it rejects the substep.
_DELTA = 1.4


def _controller(st, state, j, m, tau, tau_now, beta, nrm, F, mmin, mmax, tol):
    """The tau/m controller of kiops (the JAX engine's, shared by every
    scheme): returns (omega, err, tau_new, m_new). ``state`` carries the
    previous omega, m and tau, the order/kest estimates and ireject."""
    err = abs(beta * nrm * F[j - 1, j])
    oldomega = state["omega"]
    omega = st.tau_end * err / (tau * tol)
    if not math.isfinite(omega):
        omega = 1e300
    oldm, oldtau, ireject = state["oldm"], state["oldtau"], state["ireject"]

    if m == oldm and tau != oldtau and ireject >= 1 and oldomega > 0 and math.isfinite(oldomega):
        try:
            state["order"] = max(1.0, math.log(omega / oldomega) / math.log(tau / oldtau))
        except (ValueError, ZeroDivisionError, OverflowError):
            state["order"] = max(1.0, j / 4)
        state["order_old"] = False
    elif state["order_old"] or ireject == 0:
        state["order_old"] = True
        state["order"] = j / 4
    else:
        state["order_old"] = True
    if not math.isfinite(state["order"]) or state["order"] <= 0:
        state["order"] = max(1.0, j / 4)
    order = state["order"]

    if m != oldm and tau == oldtau and ireject >= 1 and oldomega > 0 and math.isfinite(oldomega):
        try:
            state["kest"] = max(1.1, (omega / oldomega) ** (1.0 / (oldm - m)))
        except (ValueError, ZeroDivisionError, OverflowError):
            state["kest"] = 2.0
        state["kest_old"] = False
    elif state["kest_old"] or ireject == 0:
        state["kest_old"] = True
        state["kest"] = 2.0
    else:
        state["kest_old"] = True
    if not math.isfinite(state["kest"]) or state["kest"] <= 1.0:
        state["kest"] = 2.0
    kest = state["kest"]

    remaining_time = st.tau_end - tau_now if omega > _DELTA else st.tau_end - (tau_now + tau)
    same_tau = min(remaining_time, tau)
    tau_opt = tau * (st.gamma / omega) ** (1.0 / order)
    tau_opt = min(remaining_time, max(tau / 5, min(5 * tau, tau_opt)))
    try:
        m_opt = math.ceil(j + math.log(omega / st.gamma) / math.log(kest))
    except (ValueError, OverflowError):
        m_opt = j
    m_opt = max(mmin, min(mmax, max(math.floor(3 / 4 * m), min(m_opt, math.ceil(4 / 3 * m)))))

    if j == mmax:
        if omega > _DELTA:
            m_new = j
            tau_new = tau * (st.gamma_mmax / omega) ** (1.0 / order)
            tau_new = min(st.tau_end - tau_now, max(tau / 5, tau_new))
        else:
            tau_new, m_new = tau_opt, m
    else:
        m_new, tau_new = m_opt, same_tau
    state["omega"] = omega
    return omega, err, tau_new, m_new


def _accept(st, H, F, j, l, tau_now, tau, beta) -> int:
    """An accepted substep: the phantom outputs it passed and the current
    output; returns the new output index."""
    tau_out, num_steps = st.tau_out, st.num_steps
    blown = 0
    next_t = tau_now + tau
    for k in range(l, num_steps):
        if abs(tau_out[k]) < abs(next_t):
            blown += 1
    if blown:
        st.w[l + blown, :] = st.w[l, :]
        for k in range(blown):
            tau_phantom = tau_out[l + k] - tau_now
            F2 = scipy.linalg.expm(st.sgn * tau_phantom * H[:j, :j])
            st.w[l + k, :] = st.combine(beta * F2[:j, 0], j)
        l += blown
    st.w[l, :] = st.combine(beta * F[:j, 0], j)
    return l


def _finish(st, stats, m, task1):
    if task1:
        for k in range(st.num_steps):
            st.w[k, :] /= st.tau_out[k]
    stats.last_krylov_size = m
    return st.w, stats


def _new_state():
    return {"omega": math.nan, "oldm": -1, "oldtau": math.nan, "order": 1.0, "kest": 2.0,
            "order_old": True, "kest_old": True, "ireject": 0}


def lowsync_phi(
    tau_out: Sequence[float],
    A: Callable,
    u: torch.Tensor,
    scheme: str = "icwy",
    mode: str = "ne",
    iop: int = 2,
    tol: float = 1e-7,
    m_init: int = 10,
    mmin: int = 10,
    mmax: int = 64,
    task1: bool = False,
) -> Tuple[torch.Tensor, PhiStats]:
    """Adaptive phi-combination evaluation with a low-sync orthogonalizer.

    ``scheme``: "cwy" | "icwy" | "dcgs2"; ``mode``: "ne" | "1s" | "ne1s" |
    "neiop" (the icwy window variant). `u` has shape (p+1, n) on the state's
    device, `A` maps a flat float64 tensor of n to one there; returns (w,
    stats) with w of shape (len(tau_out), n) on u's device. The same outer
    loop as kiops/pmex (tau substepping + Krylov-size adaptivity).
    """
    if scheme == "dcgs2":
        return _dcgs2_impl(tau_out, A, u, tol, m_init, mmin, mmax, task1)
    st = _Setup(tau_out, A, u, mmax)
    V, n = st.V, st.n
    m = max(mmin, min(m_init, mmax))
    H = np.zeros((mmax + 1, mmax + 1))
    T = np.eye(mmax + 1)

    stats = PhiStats()
    tau_now, tau_end = 0.0, st.tau_end
    happy = False
    j = 0
    tau = tau_end
    state = _new_state()
    l = 0
    beta = 0.0
    lagged = mode in ("1s", "ne1s")
    prev_normalized = False  # lag modes: is V[j] normalized with its TRUE norm?
    reached_mmax = False  # skip the final normalization after hitting mmax
    prev_nrm_est = 1.0  # ne1s: the estimate that scaled the previous vector

    def t_update(gram_col0, jj):
        """Loss-of-orthogonality correction row of T from the fused Gram
        column (projections of v_{jj-1} on the older basis rows)."""
        if jj > 1:
            if scheme == "cwy":
                T[jj - 1, : jj - 1] = -gram_col0[: jj - 1].T @ T[: jj - 1, : jj - 1]
            else:
                T[jj - 1, : jj - 1] = -gram_col0[: jj - 1]

    while tau_now < tau_end:
        if j == 0:
            H[:, :] = 0.0
            T[:, :] = np.eye(mmax + 1)
            st.start(l, tau_now)
            if not lagged:
                beta = _exact_norm(V[0, :])
                V[0, :] /= beta
            prev_normalized = False

        while j < m:
            j += 1
            st.extend(j)

            if mode == "neiop":
                # Windowed (incomplete) orthogonalization + norm estimate.
                ilow = max(0, j - iop)
                gram = _gram(V, slice(ilow, j + 1), slice(j - 1, j + 1))
                jw = j - ilow  # row of v_{j-1} within the window
                # The ICWY correction restricted to the window.
                if j > 1:
                    Tw = np.eye(jw)
                    Tw[jw - 1, : jw - 1] = -gram[: jw - 1, 0]
                    coeffs = Tw @ gram[:jw, 1]
                else:
                    coeffs = gram[:jw, 1].copy()
                V[j, :] -= to_device(coeffs, V) @ V[ilow:j, :]
                nrm = _pythagoras(gram[jw, 1], coeffs)
                if nrm < 0.0:
                    nrm = _exact_norm(V[j, :])
                if nrm < tol:
                    happy = True
                    break
                H[ilow:j, j - 1] = coeffs
                H[j, j - 1] = nrm
                V[j, :] /= nrm
                stats.krylov_steps += 1
                continue

            if mode == "ne1s" and j > 1 and not prev_normalized:
                # Undo the estimate scaling -> raw vectors, so the fused
                # product below carries the TRUE previous norm.
                V[j - 1 : j + 1, :] *= prev_nrm_est

            # THE single fused reduction of the iteration.
            gram = _gram(V, slice(0, j + 1), slice(j - 1, j + 1))  # (j+1, 2)

            if lagged:
                nrm_prev = math.sqrt(max(gram[j - 1, 0], 0.0))
                if j == 1:
                    beta = nrm_prev
                if not prev_normalized:
                    # Rescale both rows (A is linear) and the Gram entries;
                    # quadratic entries get the factor twice.
                    V[j - 1 : j + 1, :] /= nrm_prev
                    gram[:, 1] /= nrm_prev
                    gram[j - 1 : j + 1, 1] /= nrm_prev
                    gram[: j - 1, 0] /= nrm_prev
                    if j > 1:
                        H[j - 1, j - 2] = nrm_prev

            t_update(gram[:, 0], j)
            coeffs = T[:j, :j] @ gram[:j, 1]
            V[j, :] -= to_device(coeffs, V) @ V[:j, :]

            if mode == "ne":
                nrm = _pythagoras(gram[j, 1], coeffs)
                if nrm < 0.0:
                    nrm = _exact_norm(V[j, :])
                if nrm < tol:
                    happy = True
                    break
                H[:j, j - 1] = coeffs
                H[j, j - 1] = nrm
                V[j, :] /= nrm
            elif mode == "1s":
                # Happy check on the LAGGED (previous-vector) norm; the new
                # vector stays unnormalized until the next fused product.
                if j > 1 and H[j - 1, j - 2] < tol:
                    happy = True
                    break
                H[:j, j - 1] = coeffs
                prev_normalized = False
            else:  # ne1s
                H[:j, j - 1] = coeffs
                if j < m:
                    nrm = _pythagoras(gram[j, 1], coeffs)
                    if nrm < 0.0:
                        nrm = _exact_norm(V[j, :])
                    if nrm < tol:
                        happy = True
                        break
                    V[j, :] /= nrm
                    prev_nrm_est = nrm
                prev_normalized = False

            stats.krylov_steps += 1

        if lagged and not reached_mmax and not happy:
            # Normalize the final basis vector exactly: the one extra
            # reduction of the lagged schemes.
            final_nrm = _exact_norm(V[j, :])
            V[j, :] /= final_nrm
            H[j, j - 1] = final_nrm
            prev_normalized = True

        H[0, j] = 1.0
        nrm = H[j, j - 1]
        H[j, j - 1] = 0.0
        F = scipy.linalg.expm(st.sgn * tau * H[: j + 1, : j + 1])
        stats.num_expm += 1
        H[j, j - 1] = nrm

        if happy:
            omega, err = 0.0, 0.0
            state["omega"] = omega
            tau_new, m_new = min(tau_end - (tau_now + tau), tau), m
            happy = False
        else:
            omega, err, tau_new, m_new = _controller(st, state, j, m, tau, tau_now, beta, nrm, F, mmin, mmax, tol)
            if j == mmax:
                reached_mmax = True

        if omega <= _DELTA:
            stats.rejected += state["ireject"]
            stats.substeps += 1
            l = _accept(st, H, F, j, l, tau_now, tau, beta)
            tau_now += tau
            j = 0
            state["ireject"] = 0
            reached_mmax = False
            prev_normalized = False
            stats.error_estimate += err
        else:
            state["ireject"] += 1
            H[0, j] = 0.0

        state["oldtau"], tau = tau, tau_new
        state["oldm"], m = m, m_new
        if tau <= 0.0 and tau_now < tau_end:
            tau = tau_end - tau_now

    return _finish(st, stats, m, task1)


def _dcgs2_impl(tau_out, A, u, tol, m_init, mmin, mmax, task1):
    """Delayed classical Gram-Schmidt-2: two-pass CGS where the second pass
    of vector j rides the reduction of iteration j+1 (reference
    dcgs2.py:155-230): one fused reduction an iteration, plus the exact
    norm."""
    st = _Setup(tau_out, A, u, mmax)
    V = st.V
    m = max(mmin, min(m_init, mmax))
    H = np.zeros((mmax + 1, mmax + 1))

    stats = PhiStats()
    tau_now, tau_end = 0.0, st.tau_end
    happy = False
    j = 0
    tau = tau_end
    state = _new_state()
    l = 0
    beta = 0.0

    while tau_now < tau_end:
        if j == 0:
            H[:, :] = 0.0
            st.start(l, tau_now)
            beta = _exact_norm(V[0, :])
            V[0, :] /= beta

        while j < m:
            j += 1
            st.extend(j)

            # One fused reduction: first-pass projections of v_j AND the
            # delayed second-pass corrections of v_{j-1}.
            gram = _gram(V, slice(0, j + 1), slice(j - 1, j + 1))  # (j+1, 2)

            coeffs = gram[:j, 1].copy()
            V[j, :] -= to_device(coeffs, V) @ V[:j, :]
            if j > 1:
                corr = gram[: j - 1, 0]
                V[j - 1, :] -= to_device(corr, V) @ V[: j - 1, :]
                H[: j - 1, j - 2] += corr
            nrm = _exact_norm(V[j, :])
            if nrm < tol:
                happy = True
                break
            H[:j, j - 1] = coeffs
            H[j, j - 1] = nrm
            V[j, :] /= nrm
            stats.krylov_steps += 1

        H[0, j] = 1.0
        nrm = H[j, j - 1]
        H[j, j - 1] = 0.0
        F = scipy.linalg.expm(st.sgn * tau * H[: j + 1, : j + 1])
        stats.num_expm += 1
        H[j, j - 1] = nrm

        if happy:
            omega, err = 0.0, 0.0
            state["omega"] = omega
            tau_new, m_new = min(tau_end - (tau_now + tau), tau), m
            happy = False
        else:
            omega, err, tau_new, m_new = _controller(st, state, j, m, tau, tau_now, beta, nrm, F, mmin, mmax, tol)

        if omega <= _DELTA:
            stats.rejected += state["ireject"]
            stats.substeps += 1
            l = _accept(st, H, F, j, l, tau_now, tau, beta)
            tau_now += tau
            j = 0
            state["ireject"] = 0
            stats.error_estimate += err
        else:
            state["ireject"] += 1
            H[0, j] = 0.0

        state["oldtau"], tau = tau, tau_new
        state["oldm"], m = m, m_new
        if tau <= 0.0 and tau_now < tau_end:
            tau = tau_end - tau_now

    return _finish(st, stats, m, task1)


# --- Named variants matching the reference's solver registry -----------------


def _variant(scheme: str, mode: str):
    def solver(tau_out, A, u, tol=1e-7, m_init=10, mmin=10, mmax=64, task1=False, **kw):
        return lowsync_phi(tau_out, A, u, scheme=scheme, mode=mode,
                           tol=tol, m_init=m_init, mmin=mmin, mmax=mmax, task1=task1)

    solver.__name__ = f"{scheme}_{mode}"
    return solver


cwy_1s = _variant("cwy", "1s")
cwy_ne = _variant("cwy", "ne")
cwy_ne1s = _variant("cwy", "ne1s")
icwy_1s = _variant("icwy", "1s")
icwy_ne = _variant("icwy", "ne")
icwy_ne1s = _variant("icwy", "ne1s")
icwy_neiop = _variant("icwy", "neiop")


def dcgs2(tau_out, A, u, tol=1e-7, m_init=10, mmin=10, mmax=64, task1=False, **kw):
    return _dcgs2_impl(tau_out, A, u, tol, m_init, mmin, mmax, task1)


def pmex_1s(tau_out, A, u, tol=1e-7, m_init=10, mmin=10, mmax=64, task1=False, **kw):
    from .pmex import pmex

    return pmex(tau_out, A, u, tol=tol, m_init=m_init, mmin=mmin, mmax=mmax, task1=task1)


pmex_ne1s = pmex_1s


def kiops_nest(tau_out, A, u, tol=1e-7, m_init=10, mmin=10, mmax=64, task1=False, **kw):
    """KIOPS with norm-estimate incomplete orthogonalization (reference
    solvers/kiops_nest.py): the windowed-estimate structure (= icwy_neiop's
    inner loop) under the same adaptive controller."""
    return lowsync_phi(tau_out, A, u, scheme="icwy", mode="neiop",
                       tol=tol, m_init=m_init, mmin=mmin, mmax=mmax, task1=task1)
