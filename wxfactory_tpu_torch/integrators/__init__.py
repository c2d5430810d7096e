from .base import Integrator, SolverInfo
from .explicit import Euler1, Tvdrk3
from .epi import Epi, EpiStiff, alpha_coeff
from .rosenbrock import Ros2
from .srerk import Srerk, opt_nodes
from .hybrid import Imex2, PartRosExp2, RosExp2, SdirkLstable
from .splitting import LieSplitting, OS22Splitting, StrangSplitting
from .implicit import BackwardEuler, Bdf2, CrankNicolson

__all__ = [
    "Integrator",
    "SolverInfo",
    "Euler1",
    "Tvdrk3",
    "Epi",
    "EpiStiff",
    "alpha_coeff",
    "Ros2",
    "Srerk",
    "opt_nodes",
    "Imex2",
    "RosExp2",
    "PartRosExp2",
    "SdirkLstable",
    "LieSplitting",
    "StrangSplitting",
    "OS22Splitting",
    "BackwardEuler",
    "Bdf2",
    "CrankNicolson",
]
