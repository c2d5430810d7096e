from .base import Integrator, SolverInfo
from .explicit import Euler1, Tvdrk3

__all__ = ["Integrator", "SolverInfo", "Euler1", "Tvdrk3"]
