"""GCROT(m,k): recycled-subspace Krylov linear solver.

Counterpart of ``wxfactory_tpu/solvers/gcrot.py`` (the reference's
solvers/gcrot.py:129, a scipy-derived GCROT(m,k)):

* Outer loop: a GCRO step built on an m-step Arnoldi process orthogonalized
  against BOTH the recycled C basis and the Krylov basis, with one
  reorthogonalization pass (two passes of classical Gram-Schmidt, as the
  JAX module's docstring describes it; its loop projects one basis vector
  at a time, which differs from the batched products here by rounding).
* The new recycle pair comes matvec-free from the Arnoldi relation: with
  z_j = M(v_j) (flexible right preconditioning) the process gives
  A Z = C B + V_{m+1} H, so for the least-squares minimizer y,
  u = Z y - U (B y) and c = A u = V_{m+1} (H y).
* Truncation: the recycle space keeps the most recent k (c, u) pairs.

The vectors (the iterate, the residual, V, Z, C and U) stay on the state's
device, where the matvec, the preconditioner and the projections run; each
pass of the Gram-Schmidt is one batched product brought to the host in one
read (``common.device.to_host``), and the small least-squares problem, H
and B are float64 numpy on the host. The coefficients go back through
pinned memory without a wait (``common.device.to_device``).

Returns the framework solver contract (as ``fgmres``): a tuple (x, |r|,
|b|, num_iter, flag, residuals) with residuals a list of (relative
residual, elapsed seconds, work) entries.
"""

from time import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..common.device import host_read, to_device, to_host


def gcrot(
    A: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    tol: float = 1e-5,
    restart: int = 20,
    maxiter: Optional[int] = None,
    preconditioner: Optional[Callable] = None,
    verbose: int = 0,
    recycle: Optional[int] = None,
) -> Tuple[torch.Tensor, float, float, int, int, List]:
    """Solve Ax = b with GCROT(m, k); m = ``restart``, k = ``recycle`` or m.

    ``A`` and ``preconditioner`` map a flat float64 tensor on ``b``'s
    device to one there. ``maxiter`` bounds the number of OUTER iterations
    (one inner Arnoldi cycle of up to m matvecs each), like the
    scipy/reference solver.
    """
    b = torch.as_tensor(b).reshape(-1).to(torch.float64)
    n, dev = b.numel(), b.device
    m = max(int(restart), 1)
    k = m if recycle is None else max(int(recycle), 1)
    maxiter = maxiter or 200
    mv = lambda v: A(v).reshape(-1).to(torch.float64)
    psolve = (lambda v: preconditioner(v).reshape(-1).to(torch.float64)) if preconditioner is not None else (
        lambda v: v)

    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0).reshape(-1).to(torch.float64).clone()
    norm_b, any_x = host_read(torch.stack([torch.linalg.vector_norm(b), (x != 0).any().to(torch.float64)]))
    if norm_b == 0.0:
        return x * 0.0, 0.0, 0.0, 0, 0, []
    r = b - mv(x) if x0 is not None and any_x else b.clone()

    C = torch.zeros((0, n), dtype=torch.float64, device=dev)  # recycled c (orthonormal rows), A u = c
    U = torch.zeros((0, n), dtype=torch.float64, device=dev)
    residuals: List[Tuple[float, float, float]] = []
    t0 = time()
    num_iter = 0
    norm_r = host_read(torch.linalg.vector_norm(r))
    tol_abs = tol * norm_b

    for _outer in range(maxiter):
        if norm_r <= tol_abs:
            break
        # Project the current residual out of the recycle space: the GCRO
        # minimization works in the complement of span(C).
        if len(C):
            yc = to_device(to_host(C @ r), r)
            x += yc @ U
            r -= yc @ C
        norm_r = host_read(torch.linalg.vector_norm(r))
        if norm_r <= tol_abs or norm_r == 0.0:
            break

        # --- inner Arnoldi (m steps), orthogonal to C ---------------------
        nc = len(C)
        V = torch.zeros((m + 1, n), dtype=torch.float64, device=dev)
        Z = torch.zeros((m, n), dtype=torch.float64, device=dev)
        H = np.zeros((m + 1, m))
        Bm = np.zeros((nc, m))
        V[0] = r / norm_r
        j_done = 0
        breakdown = False
        for j in range(m):
            Z[j] = psolve(V[j])
            w = mv(Z[j])
            num_iter += 1
            # Two passes of classical Gram-Schmidt against [C | V_0..j].
            basis = torch.cat([C, V[: j + 1]])
            for _pass in range(2):
                h = to_host(basis @ w)
                Bm[:, j] += h[:nc]
                H[: j + 1, j] += h[nc:]
                w -= to_device(h, w) @ basis
            hj = host_read(torch.linalg.vector_norm(w))
            H[j + 1, j] = hj
            j_done = j + 1
            if hj <= 1e-14 * norm_r:  # happy breakdown
                breakdown = True
                break
            V[j + 1] = w / hj

        mj = j_done
        Hj = H[: mj + 1, :mj]
        rhs = np.zeros(mj + 1)
        rhs[0] = norm_r
        y, *_ = np.linalg.lstsq(Hj, rhs, rcond=None)

        # --- new recycle pair, matvec-free --------------------------------
        u_new = to_device(y, r) @ Z[:mj]
        if nc:
            u_new -= to_device(Bm[:, :mj] @ y, r) @ U
        c_new = to_device(Hj @ y, r) @ V[: mj + 1]  # = A u_new
        alpha, c_r = host_read(torch.stack([torch.linalg.vector_norm(c_new), c_new @ r]))
        if alpha == 0.0:
            break
        c_new /= alpha
        u_new /= alpha

        gamma = c_r / alpha
        x += gamma * u_new
        r -= gamma * c_new
        norm_r = host_read(torch.linalg.vector_norm(r))
        residuals.append((norm_r / norm_b, time() - t0, 0.0))
        if verbose:
            print(f"gcrot outer {_outer}: |r|/|b| = {norm_r / norm_b:.3e} ({num_iter} matvecs)")

        C = torch.cat([C, c_new[None]])[-k:]  # truncate the oldest
        U = torch.cat([U, u_new[None]])[-k:]
        if breakdown:
            break

    flag = 0 if norm_r <= tol_abs else -1
    return x, norm_r, norm_b, num_iter, flag, residuals
