"""Jacobian spectrum tooling: the dense Jacobian of a matrix-free operator,
assembled column by column, and its spectrum.

Counterpart of ``wxfactory_tpu/solvers/eigenvalue_util.py`` (reference
solvers/eigenvalue_util.py ``gen_matrix`` + scripts/eigenvalue.py). The
columns of the Jacobian are exact Jacobian actions J(q).e_j through the
RHS's own linearisation (``solvers.matvec.jacobian``: one ``jtv_prep`` at q,
then one tangent apply a column, the tangent kernels on the card), taken in
chunks of ``chunk`` columns that come to the host together. The dense
matrix is float64 numpy on the host, as in the JAX package: n = 3 * 6 *
nel^2 * s^2 columns for shallow water, so it is practical only for small
grids.
"""

from typing import Callable

import numpy as np
import torch

from ..common.device import to_host
from . import matvec as _matvec


def _columns(apply: Callable, n: int, chunk: int, like: torch.Tensor) -> np.ndarray:
    """The (n, n) matrix whose column j is ``apply(e_j)`` (flat), e_j the
    unit vectors shaped and typed as ``like``; ``chunk`` columns a host
    read."""
    cols = []
    for start in range(0, n, chunk):
        size = min(chunk, n - start)
        block = torch.empty((size, n), dtype=torch.float64, device=like.device)
        for i in range(size):
            e = torch.zeros(n, dtype=like.dtype, device=like.device)
            e[start + i] = 1.0
            block[i] = apply(e.reshape(like.shape)).reshape(-1).to(torch.float64)
        cols.append(to_host(block).T)
    return np.concatenate(cols, axis=1)


def gen_matrix(matvec: Callable, n: int, chunk: int = 64, device="cpu") -> np.ndarray:
    """Dense matrix of a matrix-free operator on flat float64 tensors of
    ``device`` (column-by-column probing)."""
    return _columns(matvec, n, chunk, torch.zeros(n, dtype=torch.float64, device=device))


def jacobian_matrix(rhs: Callable, q: torch.Tensor, chunk: int = 64) -> np.ndarray:
    """Dense Jacobian of the RHS at the state q: one linearisation at q,
    then one Jacobian action a unit vector."""
    jac = _matvec.jacobian(rhs, q)
    return _columns(jac, q.numel(), chunk, q)


def save_spectrum(matrix: np.ndarray, path: str, compute_vectors: bool = False) -> np.ndarray:
    """Eigenvalues (optionally vectors) of the assembled Jacobian, saved as
    .npz; returns the eigenvalues."""
    if compute_vectors:
        vals, vecs = np.linalg.eig(matrix)
        np.savez(path, eigenvalues=vals, eigenvectors=vecs)
    else:
        vals = np.linalg.eigvals(matrix)
        np.savez(path, eigenvalues=vals)
    return vals
