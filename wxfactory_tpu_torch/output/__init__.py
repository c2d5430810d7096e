from .diagnostics import global_integral_2d, potential_enstrophy, total_energy
from .manager import OutputManager
from .state import load_state, save_state

__all__ = [
    "OutputManager",
    "global_integral_2d",
    "load_state",
    "potential_enstrophy",
    "save_state",
    "total_energy",
]
