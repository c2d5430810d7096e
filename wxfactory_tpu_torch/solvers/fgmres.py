"""FGMRES with one synchronisation per iteration (host-orchestrated).

Flexible GMRES (right-preconditioned, restarted) whose orthogonalisation is
the low-synchronisation inverse-compact-WY Gram-Schmidt with lagged
normalisation (Swirydowicz, Langou, Ananthan, Yang & Thomas 2020): one
batched Gram product per Krylov iteration.

Counterpart of ``wxfactory_tpu/solvers/fgmres.py``, line for line, with
the flexible form's preconditioner (``Z`` holds the preconditioned vectors
M(V), ``precondition/``'s ``Factorization`` or ``Multigrid`` or any
callable on a flat tensor of the basis's device) and without the unused
``hegedus`` start. The Krylov basis ``V`` and the
preconditioned vectors ``Z`` live on the state's device, where the operator,
the Gram product and the vector updates run; the small algebra (R, T, K,
H, the Givens rotations, g and the triangular solve) is float64 numpy on
the host. The one batched Gram product of an iteration is its one host
read (``common.device.to_host``), as the port's host ``kiops`` reads its
projections; a restart reads |r| and the stagnation test in one more. The
small vectors go back through pinned memory without a wait
(``common.device.to_device``), so a solve runs inside
``forbid_uncounted_syncs``.
"""

import math
from time import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import scipy.linalg
import torch

from ..common.device import host_read, to_device, to_host


def _givens(a: float, b: float) -> Tuple[float, float, float]:
    """Coefficients (c, s, r) of the Givens rotation zeroing b against a."""
    if b == 0.0:
        return 1.0, 0.0, a
    if a == 0.0:
        return 0.0, 1.0, b
    scl = min(abs(a), abs(b))
    sigma = math.copysign(1.0, a) if abs(a) > abs(b) else math.copysign(1.0, b)
    r = sigma * scl * math.sqrt((a / scl) ** 2 + (b / scl) ** 2)
    return a / r, b / r, r


def _low_sync_orthonormalize(V: torch.Tensor, R, T, K, j: int) -> float:
    """One step of 1-sync lagged-normalisation iterated Gram-Schmidt.

    Row j-1 of V is orthogonalised against the previous rows and row j-2
    is normalised (its normalisation was lagged one iteration). All the
    global information comes from ONE batched product of V[:j] with the
    last two rows, read on the host. Returns the (lagged) norm used to
    rescale, or -1 on the first call."""
    if j < 2:
        return -1.0

    # The single global reduction of the iteration, and its host read:
    gram = to_host(V[:j, :] @ V[j - 2 : j, :].T)  # (j, 2)
    prev = gram[: j - 2, 0]  # <V_i, V_{j-2}> for i < j-2

    R[: j - 1, j - 1] = gram[: j - 1, 1]
    norm2 = gram[j - 2, 0] - prev @ prev
    norm = math.sqrt(norm2)
    R[j - 2, j - 2] = norm
    R[j - 2, j - 1] = (R[j - 2, j - 1] - prev @ R[: j - 2, j - 1]) / norm
    T[: j - 2, j - 2] = prev / norm

    if j > 2:
        low = np.tril(T[: j - 2, : j - 2].T, -1) + np.eye(j - 2)
        corr = np.linalg.solve(low, prev)
        R[: j - 2, j - 2] = K[: j - 2, j - 3] + corr
        K[: j - 1, j - 2] = (R[: j - 1, j - 1] - R[: j - 1, 1 : j - 1] @ corr) / norm
        # V[j-2] -= V[:j-2].T @ prev and V[j-1] -= V[:j-2].T @ R[:j-2, j-1]
        # in one product (neither update reads the other's row).
        coef = to_device(np.stack([prev, R[: j - 2, j - 1]]), V)
        V[j - 2 : j, :] -= coef @ V[: j - 2, :]
    else:
        K[: j - 1, j - 2] = R[: j - 1, j - 1] / norm

    V[j - 2, :] /= norm
    V[j - 1, :] -= V[j - 2, :] * R[j - 2, j - 1]
    V[j - 1, :] /= norm
    return norm


def fgmres(
    A: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    tol: float = 1e-5,
    restart: int = 20,
    maxiter: Optional[int] = None,
    preconditioner: Optional[Callable] = None,
    verbose: int = 0,
) -> Tuple[torch.Tensor, float, float, int, int, List[Tuple[float, float, float]]]:
    """Solve Ax = b for a flat float64 ``b`` on its device (``A`` maps such
    a tensor to one; so does ``preconditioner``, the flexible form's M,
    applied to each basis vector). Returns (x, |r|, |b|, num_iter, flag,
    residual_history); flag: 0 converged, -1 not converged / stagnated."""
    b = torch.as_tensor(b).reshape(-1).to(torch.float64)
    n, dev = b.numel(), b.device
    t_start = time()
    niter = 0

    precond = preconditioner if preconditioner is not None else (lambda v: v)
    if maxiter is None:
        maxiter = n * 10

    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0).reshape(-1).to(torch.float64).clone()

    norm_b = host_read(torch.linalg.vector_norm(b))
    if norm_b == 0.0:
        return torch.zeros_like(b), 0.0, 0.0, 0, 0, [(0.0, time() - t_start, 0.0)]
    tol_rel = tol * norm_b

    r = b - A(x)
    norm_r = host_read(torch.linalg.vector_norm(r))
    residuals: List[Tuple[float, float, float]] = [(norm_r / norm_b, time() - t_start, 0.0)]

    flag = -1
    for _ in range(maxiter):
        H = np.zeros((restart + 2, restart + 2))
        R = np.zeros((restart + 2, restart + 2))
        T = np.zeros((restart + 2, restart + 2))
        K = np.zeros((restart + 2, restart + 2))
        V = torch.zeros((restart + 2, n), dtype=torch.float64, device=dev)
        Z = torch.zeros((restart + 1, n), dtype=torch.float64, device=dev)
        givens: List[np.ndarray] = []

        V[0, :] = r / norm_r
        Z[0, :] = precond(V[0, :])
        V[1, :] = A(Z[0, :])
        v_norm = _low_sync_orthonormalize(V, R, T, K, 2)

        g = np.zeros(restart + 2)
        g[0] = norm_r

        inner = -1
        for inner in range(restart):
            niter += 1
            Z[inner + 1, :] = precond(V[inner + 1])
            V[inner + 2, :] = A(Z[inner + 1, :] / v_norm) * v_norm
            v_norm = _low_sync_orthonormalize(V, R, T, K, inner + 3)
            H[inner, : inner + 2] = R[: inner + 2, inner + 1]
            Z[inner + 1, :] /= v_norm

            # Apply the accumulated Givens rotations to the new column of H
            for jj, qb in enumerate(givens):
                H[inner, jj : jj + 2] = qb @ H[inner, jj : jj + 2]

            if H[inner, inner + 1] != 0.0:
                c, s, _ = _givens(H[inner, inner], H[inner, inner + 1])
                qb = np.array([[c, s], [-s, c]])
                givens.append(qb)
                g[inner : inner + 2] = qb @ g[inner : inner + 2]
                H[inner, inner] = qb[0, :] @ H[inner, inner : inner + 2]
                H[inner, inner + 1] = 0.0

            if inner < restart - 1:
                norm_r = abs(g[inner + 1])
                residuals.append((norm_r / norm_b, time() - t_start, 0.0))
                if verbose > 1:
                    print(f"fgmres: |r|/|b| = {residuals[-1][0]:.3e}", flush=True)
                if norm_r < tol_rel:
                    break

        # Solve the small triangular system and update the iterate.
        y = scipy.linalg.solve_triangular(H[: inner + 1, : inner + 1].T, g[: inner + 1])
        update = to_device(y, b) @ Z[: inner + 1, :]
        x = x + update
        r = b - A(x)
        # |r| and the stagnation test (max |update/x| over x != 0) in one read.
        nz = x != 0
        ratio = torch.where(nz, (update / torch.where(nz, x, 1.0)).abs(), 0.0).max()
        norm_r, ratio, any_nz = host_read(torch.stack([torch.linalg.vector_norm(r), ratio,
                                                       nz.any().to(torch.float64)]))
        residuals.append((norm_r / norm_b, time() - t_start, 0.0))
        if verbose > 0:
            print(f"fgmres: restart residual {norm_r / norm_b:.2e} (iter {niter})", flush=True)

        # Stagnation check
        if any_nz and ratio < 1e-12:
            return x, norm_r, norm_b, niter, -1, residuals

        if norm_r < tol_rel:
            flag = 0
            break

    if norm_r < tol_rel:
        flag = 0
    return x, norm_r, norm_b, niter, flag, residuals
