"""Device-resident FGMRES: restarted flexible GMRES with its basis, its
Hessenberg columns, the Givens rotations and the triangular solve on the
state's device.

Counterpart of ``wxfactory_tpu/solvers/fgmres_jit.py`` (one XLA program of
``lax.while_loop``s there). Eager PyTorch has no device-side loop, so the
host drives the iterations as the port's ``kiops_jit`` does, without
waiting for the device inside a restart cycle:

* the host launches the ``restart`` iterations of a cycle without reading
  the device; the Gram-Schmidt products read only the basis rows the
  host's iteration counter names (the JAX package's mask over rows 0..j);
* once the cycle has converged (``|g[j+1]| < tol*|b|``) or broken down
  (``nrm == 0``), its remaining iterations are masked no-ops
  (``torch.where``): they still apply the operator, write no basis row,
  and are counted apart from ``num_iter`` (``masked_iterations``);
* the host reads one small packed tensor (|r|, the iteration count, the
  cycle's converged iterations) once per restart cycle, and |r| and |b|
  once before the first.

Everything else follows the JAX program: fixed ``(restart+1)`` V/Z/H
buffers, classical Gram-Schmidt as one batched product (with
``one_sync`` the new vector's norm rides the same product and the
orthogonalised norm is the Pythagorean estimate ``||w||^2 - ||h||^2``,
clamped at zero), the Givens rotations as device scalars (applied to a new
column as their accumulated product, one small matrix-vector product,
where the JAX loop applies them one by one: the same to rounding), the
back-substitution on the rotated H masked to the cycle's completed columns
with identity padding, the flexible form's ``preconditioner`` (Z = M(V),
z = M(v_j) before each operator application; M runs on the basis's
device and its result is stored in the basis dtype), and ``A32`` with
``basis_dtype``: the inner Arnoldi
runs the cheap operator on a ``basis_dtype`` basis (float32) while every
outer residual ``r = b - A(x)`` and the solution update stay in b's dtype
with the exact operator (restarted iterative refinement). The basis
products are ``torch.matmul``, as the JAX package computes them outside
any kernel.

Vectors are flat: ``b`` is ``(n,)``; ``A`` maps a flat tensor of b's dtype
to one, ``A32`` one of ``basis_dtype``.
"""

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..common.device import host_read


@dataclass
class FgmresJitInfo:
    """Result of one ``fgmres_jit`` solve (host values, read with the
    cycles' packed reads)."""

    norm_r: float
    norm_b: float
    num_iter: int  # converged inner iterations, the JAX solver's count
    converged: bool
    cycles: int = 0  # restart cycles, one host read each
    masked_iterations: int = 0  # inner iterations after a cycle had converged
    matvecs: int = 0  # applications of A and A32


def fgmres_jit(
    A: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    tol: float = 1e-5,
    restart: int = 20,
    max_outer: int = 20,
    preconditioner: Optional[Callable] = None,
    one_sync: bool = False,
    A32: Optional[Callable] = None,
    basis_dtype=None,
):
    """Solve A x = b. Returns (x, FgmresJitInfo), x of b's shape and dtype
    on b's device. ``A32`` + ``basis_dtype=torch.float32``: the mixed
    precision restart cycles of the module docstring (``basis_dtype``
    defaults to float32 when ``A32`` is given, as in the JAX package).
    ``preconditioner``: the flexible form's M on a flat tensor (identity
    when None)."""
    b = torch.as_tensor(b)
    dtype, dev = b.dtype, b.device
    if basis_dtype is None:
        basis_dtype = torch.float32 if A32 is not None else dtype
    bd = basis_dtype
    A_in = A if A32 is None else A32
    R = restart
    n = b.numel()
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0).reshape(b.shape).to(dtype)

    def norm(v):
        return torch.sqrt(torch.dot(v, v))

    norm_b = norm(b)
    tol_rel = tol * norm_b
    # Device constants are made once, never copied from the host inside a
    # cycle (a copy from pageable host memory waits for the card).
    kidx = torch.arange(R, device=dev)
    eye = torch.eye(R + 1, dtype=dtype, device=dev)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    zero, one = torch.zeros((), dtype=dtype, device=dev), torch.ones((), dtype=dtype, device=dev)
    one_bd = one.to(bd)
    info = FgmresJitInfo(norm_r=0.0, norm_b=0.0, num_iter=0, converged=False)

    r = b - A(x)
    norm_r = norm(r)
    info.matvecs += 1
    niter = torch.zeros((), dtype=torch.int64, device=dev)
    norm_r_h, norm_b_h = host_read(torch.stack([norm_r, norm_b]))
    while norm_r_h >= tol * norm_b_h and info.cycles < max_outer and norm_b_h > 0:
        V = torch.zeros((R + 1, n), dtype=bd, device=dev)
        V[0] = (r / norm_r).to(bd)
        Z = torch.zeros((R, n), dtype=bd, device=dev)
        Hcol = torch.zeros((R + 1, R), dtype=dtype, device=dev)
        Q = eye.clone()  # the accumulated Givens rotations of the cycle
        g = torch.zeros(R + 1, dtype=dtype, device=dev)
        g[0] = norm_r
        done, jdone = false, niter.new_zeros(())
        for j in range(R):
            active = ~done
            z = V[j] if preconditioner is None else preconditioner(V[j]).to(bd)
            w = A_in(z)
            rows = V[: j + 1]
            if one_sync:
                # [V; w] @ w: on one device the two products need no copy of the rows.
                G = torch.cat([rows @ w, torch.dot(w, w)[None]])
                hb = G[: j + 1]
                w = w - hb @ rows
                nrm = torch.sqrt(torch.clamp(G[j + 1] - hb @ hb, min=0.0))
            else:
                hb = rows @ w
                w = w - hb @ rows
                nrm = norm(w)
            nrm = nrm.to(dtype)
            hfull = torch.cat([hb.to(dtype), nrm[None], g.new_zeros(R - j - 1)])
            hfull = Q @ hfull

            # New rotation zeroing the subdiagonal entry.
            a_, b_ = hfull[j], hfull[j + 1]
            r_ = torch.sqrt(a_ * a_ + b_ * b_)
            safe = r_ > 0
            c = torch.where(safe, a_ / torch.where(safe, r_, one), one)
            s = torch.where(safe, b_ / torch.where(safe, r_, one), zero)
            hfull[j] = r_
            hfull[j + 1] = zero
            gj = g[j].clone()
            g[j] = c * gj
            g[j + 1] = -s * gj
            qj = Q[j].clone()
            Q[j] = c * qj + s * Q[j + 1]
            Q[j + 1] = -s * qj + c * Q[j + 1]
            Hcol[:, j] = hfull

            nrm_b = nrm.to(bd)
            vnew = torch.where(nrm_b > 0, w / torch.where(nrm_b > 0, nrm_b, one_bd), w)
            V[j + 1] = torch.where(active, vnew, V[j + 1])
            Z[j] = torch.where(active, z, Z[j])
            jdone = jdone + active.long()
            done = done | (active & ((g[j + 1].abs() < tol_rel) | (nrm == 0.0)))
        info.matvecs += R

        # Back-substitution on the rotated (upper-triangular) H, masked to
        # the jdone completed columns (identity padding elsewhere: y = 0).
        cmask = kidx < jdone
        Ht = torch.where(cmask[None, :] & cmask[:, None], Hcol[:R, :], zero)
        Ht = Ht + torch.diag((~cmask).to(dtype))
        rhs = torch.where(cmask, g[:R], zero)
        y = torch.linalg.solve_triangular(Ht, rhs[:, None], upper=True)[:, 0]
        # The state-sized update runs in the basis dtype; the solution, the
        # residual and its norm stay in b's dtype with the exact A.
        x = x + (y.to(bd) @ Z).to(dtype)
        r = b - A(x)
        norm_r = norm(r)
        niter = niter + jdone
        info.matvecs += 1
        info.cycles += 1
        norm_r_h, niter_h, jdone_h = host_read(torch.stack([norm_r, niter.to(dtype), jdone.to(dtype)]))
        info.masked_iterations += R - int(jdone_h)
        info.num_iter = int(niter_h)
    info.norm_r, info.norm_b = norm_r_h, norm_b_h
    info.converged = norm_r_h < tol * norm_b_h or norm_b_h == 0
    return x, info
