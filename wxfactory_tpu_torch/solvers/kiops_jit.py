"""Device-resident KIOPS: the adaptive Krylov phi-function evaluation with
its basis, its Hessenberg matrix, the small matrix exponential and the
tau/m controller all on the state's device.

Counterpart of ``wxfactory_tpu/solvers/kiops_jit.py`` (one XLA program
there). Eager PyTorch has no device-side loop, so the host still drives
the Arnoldi iterations, but it never waits for the device inside a cycle:

* no value of the device is read inside an Arnoldi cycle, and no host
  value is copied to it (both make the host wait for the card): the host
  knows the cycle's first row ``j`` and its size ``m`` from its last read,
  and launches the iterations ``j+1 .. m``; the CGS2 or IOP products read
  only the rows the host's counter names, and the device's copy of a row
  index is a view of one ``arange`` made per call;
* a happy breakdown (``nrm < tol``) found mid-cycle turns the remaining
  iterations of the cycle into masked no-ops (``torch.where``): they still
  apply the operator, write nothing, and are counted apart from
  ``krylov_steps`` (``masked_iterations``);
* the host reads one small packed tensor once per ``control`` (j, m,
  whether tau_end is reached, tau_now and the running statistics): one
  host sync per substep or rejection, where the host-orchestrated
  ``kiops`` syncs once per iteration.

Everything else follows the JAX package line for line (itself the host
``kiops`` on fixed ``(mmax+1)`` buffers): the scaled augmented rows, the
restart weights with the reference's ``i = p - k + 1`` exponent, IOP-``iop``
or full CGS2 orthogonalisation (``full_ortho``), ``basis_dtype`` for the
basis and the state-sized vector algebra, ``one_sync``'s Pythagorean norm,
the persistent H with the phi_1 coupling entry, the solve-free
scaling-and-squaring Taylor exponential, and the omega controller with its
non-finite guards. The basis Gram products and combinations are
``torch.matmul``, as the JAX package computes them outside any kernel.

Vectors are flat: ``u`` is ``(p+1, n)``, ``A`` maps a flat ``(n,)`` tensor
of ``basis_dtype`` to one.
"""

from dataclasses import dataclass
from typing import Callable

import torch

from ..common import device as _device

def _expm_taylor(A: torch.Tensor, order: int = 20, max_squarings: int = 48) -> torch.Tensor:
    """Matrix exponential by scaling and squaring with a Taylor/Horner
    series, in A's dtype with matmuls only and no host decision: the
    squarings past the needed count leave the matrix as it is
    (``_expm_taylor``, kiops_jit.py:36-53 of the JAX package)."""
    norm = A.abs().sum(dim=1).max()
    k = torch.clamp(torch.ceil(torch.log2(torch.clamp(norm, min=1e-300)) + 1.0), 0, max_squarings)
    B = A / torch.pow(torch.full_like(k, 2.0), k)
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    E = eye
    for i in range(order, 0, -1):
        E = eye + (B @ E) / float(i)
    for i in range(max_squarings):
        E = torch.where(i < k, E @ E, E)
    return E


@dataclass
class KiopsJitStats:
    """Statistics of one ``kiops_jit`` call (read on the host with the
    controls' packed reads; no extra sync)."""

    krylov_steps: int = 0
    substeps: int = 0
    rejected: int = 0
    num_expm: int = 0
    error_estimate: float = 0.0
    last_krylov_size: int = 0
    controls: int = 0  # host reads, one per control
    masked_iterations: int = 0
    matvecs: int = 0  # applications of A: Krylov steps, happy breakdowns and masked iterations


def _factorial(k: int) -> int:
    out = 1
    for i in range(2, k + 1):
        out *= i
    return out


def kiops_jit(
    A: Callable,
    u: torch.Tensor,
    tau_end: float = 1.0,
    tol: float = 1e-7,
    m_init: int = 10,
    mmin: int = 10,
    mmax: int = 64,
    iop: int = 2,
    task1: bool = False,
    full_ortho: bool = False,
    basis_dtype=None,
    one_sync: bool = False,
):
    """Evaluate w = phi_0(tau A) u[0] + phi_1(tau A) u[1] + ... at tau_end.

    ``u`` is ``(p+1, n)`` on the device; ``A`` maps a flat ``basis_dtype``
    vector to one (``full_ortho`` is required for inexact, e.g. float32,
    operators; see the JAX package's docstring). Returns (w, stats), w of
    shape (n,) in u's dtype on u's device."""
    u = torch.as_tensor(u)
    dtype, dev = u.dtype, u.device
    bd = dtype if basis_dtype is None else basis_dtype
    ppo, n = u.shape
    p = ppo - 1
    if p == 0:
        p = 1
        u = torch.cat([u, torch.zeros((1, n), dtype=dtype, device=dev)])
    # Device scalars are filled on the card, never copied from the host (a
    # copy from pageable host memory waits for the card), and are made once:
    # the cycle itself creates none.
    t = lambda v: torch.full((), v, dtype=dtype, device=dev)
    ridx = torch.arange(mmax + 1, device=dev)  # also the device copies of the host's row counter
    zero, two, huge = t(0.0), t(2.0), t(1e300)
    false = torch.zeros((), dtype=torch.bool, device=dev)

    sgn = 1.0 if tau_end >= 0 else -1.0
    tau_end_a = t(abs(tau_end))
    if abs(tau_end) > 1:
        gamma, gamma_mmax = 0.2, 0.1
    else:
        gamma, gamma_mmax = 0.9, 0.6
    delta = 1.4

    # Scale the phi-coefficient rows to unit order of magnitude.
    norm_u = u[1:].abs().sum(dim=1).max()
    ex = torch.ceil(torch.log2(norm_u))
    use_scale = (norm_u > 0) & (ppo > 1)
    nu = torch.where(use_scale, torch.pow(two, -ex), t(1.0))
    mu = torch.where(use_scale, torch.pow(two, ex), t(1.0))
    u_flip = (nu * torch.flip(u[1:], dims=[0])).to(bd)  # (p, n)

    aug_i = torch.stack([t(float(p - k + 1)) for k in range(p - 1)] + [zero])
    aug_fact = torch.stack([t(float(_factorial(p - k + 1))) for k in range(p - 1)] + [t(1.0)])

    w = u[0].clone()
    Vb = torch.zeros((mmax + 1, n), dtype=bd, device=dev)
    Va = torch.zeros((mmax + 1, p), dtype=bd, device=dev)
    H = torch.zeros((mmax + 1, mmax + 1), dtype=dtype, device=dev)
    m_init = max(mmin, min(int(m_init), mmax))
    st = {
        "j": ridx[0], "m": ridx[m_init], "beta": zero, "tau_now": zero, "tau": tau_end_a, "happy": false,
        "omega": t(float("nan")), "oldm": torch.full((), -1, dtype=torch.int64, device=dev),
        "oldtau": t(float("nan")), "order": zero, "kest": two, "order_old": ~false, "kest_old": ~false,
        "ireject": ridx[0], "ksteps": ridx[0], "substeps": ridx[0], "rejected": ridx[0], "nexpm": ridx[0],
        "err_sum": zero, "masked": ridx[0],
    }
    one_bd = torch.ones((), dtype=bd, device=dev)
    zero_a = torch.zeros(1, dtype=bd, device=dev)

    def restart():
        aug = mu * torch.pow(st["tau_now"], aug_i) / aug_fact
        aug[p - 1] = mu
        beta = torch.sqrt(torch.dot(w, w) + torch.dot(aug, aug))
        Vb[0] = (w / beta).to(bd)
        Va[0] = (aug / beta).to(bd)
        st["beta"] = beta

    def gram(rows_b, rows_a, vb, va):
        """[rows; v] @ v: the projections and the new vector's own squared
        norm in one batch (``one_sync``)."""
        return torch.cat([rows_b @ vb + rows_a @ va, (torch.dot(vb, vb) + torch.dot(va, va))[None]])

    def arnoldi(j: int):
        """Build basis row j (the host's counter); a no-op once happy."""
        active = ~st["happy"]
        vprev_b, vprev_a = Vb[j - 1], Va[j - 1]
        vjb = A(vprev_b) + vprev_a @ u_flip
        vja = torch.cat([vprev_a[1:], zero_a])
        oldcol = H[:, j - 1].clone()
        nrm_est = None
        if full_ortho:
            # Full CGS2: project on all previous basis rows, twice.
            rows_b, rows_a = Vb[:j], Va[:j]
            h1 = rows_b @ vjb + rows_a @ vja
            vjb = vjb - h1 @ rows_b
            vja = vja - h1 @ rows_a
            if one_sync:
                G = gram(rows_b, rows_a, vjb, vja)
                h2 = G[:j]
                vjb = vjb - h2 @ rows_b
                vja = vja - h2 @ rows_a
                nrm_est = torch.sqrt(torch.clamp(G[j] - h2 @ h2, min=0.0))
            else:
                h2 = rows_b @ vjb + rows_a @ vja
                vjb = vjb - h2 @ rows_b
                vja = vja - h2 @ rows_a
            newcol = oldcol.clone()
            newcol[:j] = (h1 + h2).to(dtype)
        else:
            # Incomplete orthogonalization: the last `iop` basis rows only.
            ilow = max(0, j - iop)
            rows_b, rows_a = Vb[ilow:j], Va[ilow:j]
            if one_sync:
                G = gram(rows_b, rows_a, vjb, vja)
                hvals = G[: j - ilow]
                vjb = vjb - hvals @ rows_b
                vja = vja - hvals @ rows_a
                nrm_est = torch.sqrt(torch.clamp(G[j - ilow] - hvals @ hvals, min=0.0))
            else:
                hvals = rows_b @ vjb + rows_a @ vja
                vjb = vjb - hvals @ rows_b
                vja = vja - hvals @ rows_a
            # H[ilow:j, j-1] = hvals; the column's other rows keep their
            # (possibly stale) values, as in the reference.
            newcol = oldcol.clone()
            newcol[ilow:j] = hvals.to(dtype)
        nrm = torch.sqrt(torch.dot(vjb, vjb) + torch.dot(vja, vja)) if nrm_est is None else nrm_est
        happy = nrm < tol
        # On the happy break V[j] stays unnormalised and H[j, j-1] untouched.
        newcol[j] = torch.where(happy, oldcol[j], nrm.to(dtype))
        inv = torch.where(happy, one_bd, 1.0 / torch.where(happy, one_bd, nrm))
        H[:, j - 1] = torch.where(active, newcol, oldcol)
        Vb[j] = torch.where(active, vjb * inv, Vb[j])
        Va[j] = torch.where(active, vja * inv, Va[j])
        st["j"] = torch.where(active, ridx[j], st["j"])
        st["ksteps"] = st["ksteps"] + (active & ~happy).long()
        st["masked"] = st["masked"] + (~active).long()
        st["happy"] = st["happy"] | (active & happy)

    def at(M, r, c):
        """M[r, c] for index tensors, without a host read (indexing with a
        0-d tensor would read it on the host)."""
        return torch.take(M, r * M.shape[1] + c)

    def control():
        nonlocal w
        s = st
        j = s["j"]
        jf = j.to(dtype)
        flat = H.view(-1)
        flat.index_fill_(0, j.reshape(1), 1.0)  # H[0, j] = 1, the phi_1 coupling
        nrm_keep = at(H, j, j - 1)
        Hexp = torch.where((ridx[:, None] <= j) & (ridx[None, :] <= j), H, zero)
        Hexp.view(-1).index_fill_(0, (j * (mmax + 1) + j - 1).reshape(1), 0.0)
        F = _expm_taylor(sgn * s["tau"] * Hexp)
        s["nexpm"] = s["nexpm"] + 1

        fj = at(F, j - 1, j)
        err_raw = torch.abs(s["beta"] * nrm_keep * fj)

        # --- omega controller (reference kiops.py:237-288) ---
        oldomega = s["omega"]
        omega_raw = tau_end_a * err_raw / (s["tau"] * tol)
        omega = torch.where(torch.isfinite(omega_raw), omega_raw, huge)
        old_ok = (oldomega > 0) & torch.isfinite(oldomega) & (s["ireject"] >= 1)
        order_branch = (s["m"] == s["oldm"]) & (s["tau"] != s["oldtau"]) & old_ok
        cand_o = torch.log(omega / oldomega) / torch.log(s["tau"] / s["oldtau"])
        cand_o = torch.where(torch.isfinite(cand_o), torch.clamp(cand_o, min=1.0), torch.clamp(jf / 4, min=1.0))
        default_o = s["order_old"] | (s["ireject"] == 0)
        order = torch.where(order_branch, cand_o, torch.where(default_o, jf / 4, s["order"]))
        order_old = ~order_branch
        order = torch.where(torch.isfinite(order) & (order > 0), order, torch.clamp(jf / 4, min=1.0))

        kest_branch = (s["m"] != s["oldm"]) & (s["tau"] == s["oldtau"]) & old_ok
        cand_k = torch.pow(omega / oldomega, 1.0 / (s["oldm"] - s["m"]).to(dtype))
        cand_k = torch.where(torch.isfinite(cand_k), torch.clamp(cand_k, min=1.1), two)
        default_k = s["kest_old"] | (s["ireject"] == 0)
        kest = torch.where(kest_branch, cand_k, torch.where(default_k, two, s["kest"]))
        kest_old = ~kest_branch
        kest = torch.where(torch.isfinite(kest) & (kest > 1.0), kest, two)

        remaining = torch.where(omega > delta, tau_end_a - s["tau_now"], tau_end_a - (s["tau_now"] + s["tau"]))
        same_tau = torch.minimum(remaining, s["tau"])
        tau_opt = s["tau"] * torch.pow(gamma / omega, 1.0 / order)
        tau_opt = torch.minimum(remaining, torch.maximum(s["tau"] / 5, torch.minimum(5 * s["tau"], tau_opt)))
        m_opt_raw = jf + torch.log(omega / gamma) / torch.log(kest)
        m_opt_raw = torch.where(torch.isfinite(m_opt_raw), torch.ceil(m_opt_raw), jf)
        mf = s["m"].to(dtype)
        m_opt = torch.clamp(torch.maximum(torch.floor(3 / 4 * mf), torch.minimum(m_opt_raw, torch.ceil(4 / 3 * mf))),
                            mmin, mmax).long()

        at_mmax = j == mmax
        tau_red = s["tau"] * torch.pow(gamma_mmax / omega, 1.0 / order)
        tau_red = torch.minimum(tau_end_a - s["tau_now"], torch.maximum(s["tau"] / 5, tau_red))
        m_new_nh = torch.where(at_mmax, torch.where(omega > delta, j, s["m"]), m_opt)
        tau_new_nh = torch.where(at_mmax, torch.where(omega > delta, tau_red, tau_opt), same_tau)

        # Happy path overrides (omega = err = 0, keep m, cap tau).
        happy = s["happy"]
        omega = torch.where(happy, zero, omega)
        err = torch.where(happy, zero, err_raw)
        m_new = torch.where(happy, s["m"], m_new_nh)
        tau_new = torch.where(happy, torch.minimum(tau_end_a - (s["tau_now"] + s["tau"]), s["tau"]), tau_new_nh)

        # --- accept / reject ---
        accept = omega <= delta
        fcol = torch.where(ridx < j, F[:, 0], zero)
        # The result combination runs in the basis dtype.
        w_acc = s["beta"] * (fcol.to(bd) @ Vb).to(dtype)
        w = torch.where(accept, w_acc, w)
        # A rejection undoes the phi_1 coupling entry (H[0, j] = 0).
        flat.index_copy_(0, j.reshape(1), accept.to(dtype).reshape(1))
        tau_now = torch.where(accept, s["tau_now"] + s["tau"], s["tau_now"])
        s["j"] = torch.where(accept, ridx[0], j)
        s["substeps"] = s["substeps"] + accept.long()
        s["rejected"] = s["rejected"] + torch.where(accept, s["ireject"], ridx[0])
        s["err_sum"] = s["err_sum"] + torch.where(accept, err, zero)
        s["ireject"] = torch.where(accept, ridx[0], s["ireject"] + 1)
        tau_next = torch.where((tau_new <= 0.0) & (tau_now < tau_end_a), tau_end_a - tau_now, tau_new)
        s.update(m=m_new, tau_now=tau_now, tau=tau_next, happy=false, omega=omega,
                 oldm=s["m"], oldtau=s["tau"], order=order, kest=kest, order_old=order_old, kest_old=kest_old)

    stats = KiopsJitStats()
    j_h, m_h, running = 0, m_init, abs(tau_end) > 0
    ks = sub = rej = nexp = err_sum = masked = 0
    while running:
        if j_h == 0:
            restart()
        for jr in range(j_h + 1, m_h + 1):
            arnoldi(jr)
            stats.matvecs += 1
        control()
        packed = torch.stack([
            st["j"].to(torch.float64), st["m"].to(torch.float64), (st["tau_now"] < tau_end_a).to(torch.float64),
            st["ksteps"].to(torch.float64), st["substeps"].to(torch.float64), st["rejected"].to(torch.float64),
            st["nexpm"].to(torch.float64), st["err_sum"].to(torch.float64), st["masked"].to(torch.float64),
        ])
        j_f, m_f, run_f, ks, sub, rej, nexp, err_sum, masked = _device.host_read(packed)
        j_h, m_h, running = int(j_f), int(m_f), run_f > 0
        stats.controls += 1
    stats.krylov_steps, stats.substeps, stats.rejected, stats.num_expm = int(ks), int(sub), int(rej), int(nexp)
    stats.error_estimate, stats.last_krylov_size, stats.masked_iterations = err_sum, m_h, int(masked)
    if task1:
        w = w / tau_end
    return w, stats
