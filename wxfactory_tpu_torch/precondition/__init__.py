"""Preconditioners of the implicit and rational systems (I - dt/2 J):
direct factorisation (lu, ilu) and the p-mg / fv-mg V-cycles."""

from .factorization import Factorization
from .multigrid import Multigrid, MultigridLevel

__all__ = ["Factorization", "Multigrid", "MultigridLevel"]
