from .base import Integrator, SolverInfo
from .epi import Epi, EpiStiff
from .explicit import Euler1, Tvdrk3

__all__ = ["Integrator", "SolverInfo", "Epi", "EpiStiff", "Euler1", "Tvdrk3"]
