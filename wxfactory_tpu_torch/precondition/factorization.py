"""Direct-factorization preconditioner (LU / ILU).

Counterpart of ``wxfactory_tpu/precondition/factorization.py`` (reference
precondition/factorization.py): assemble I - dt/2 J by probing the exact
Jacobian action (``solvers.eigenvalue_util.jacobian_matrix``: the RHS's
tangent kernels on the card), factorise it with scipy ``splu`` / ``spilu``
on the host, and solve with the factors inside FGMRES; each application
copies its vector to the host and the solution back to the vector's
device. Practical only for small problems, as in the JAX package and the
reference.
"""

from typing import Callable

import numpy as np
import scipy.sparse
import scipy.sparse.linalg
import torch

from ..common.device import from_host, to_host
from ..solvers.eigenvalue_util import jacobian_matrix


class Factorization:
    def __init__(self, rhs: Callable, kind: str = "lu", drop_tol: float = 1e-4, fill_factor: float = 10.0):
        if kind not in ("lu", "ilu"):
            raise ValueError(f"Factorization kind must be 'lu' or 'ilu', got {kind}")
        self.rhs = rhs
        self.kind = kind
        self.drop_tol = drop_tol
        self.fill_factor = fill_factor
        self._solve = None

    def prepare(self, dt: float, q) -> None:
        """(Re)build and factorise I - dt/2 J at the current state."""
        jac = jacobian_matrix(self.rhs, q)
        n = jac.shape[0]
        system = np.eye(n) - 0.5 * dt * jac
        sp = scipy.sparse.csc_matrix(system)
        if self.kind == "lu":
            fact = scipy.sparse.linalg.splu(sp)
        else:
            fact = scipy.sparse.linalg.spilu(sp, drop_tol=self.drop_tol, fill_factor=self.fill_factor)
        self._solve = fact.solve

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        """M^-1 v for a flat tensor, on its device and in its dtype."""
        if self._solve is None:
            raise RuntimeError("Factorization.prepare(dt, q) must be called before applying")
        x = self._solve(np.asarray(to_host(v), np.float64).ravel())
        return from_host(x, v)
