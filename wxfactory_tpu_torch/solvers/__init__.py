from .global_ops import global_dotprod, global_inf_norm, global_norm
from .kiops import kiops
from .kiops_jit import KiopsJitStats, kiops_jit
from .matvec import make_fd_matvec, make_jvp_matvec, make_rat_matvec
from .stats import PhiStats

__all__ = [
    "global_dotprod",
    "global_inf_norm",
    "global_norm",
    "kiops",
    "kiops_jit",
    "KiopsJitStats",
    "make_fd_matvec",
    "make_jvp_matvec",
    "make_rat_matvec",
    "PhiStats",
]
