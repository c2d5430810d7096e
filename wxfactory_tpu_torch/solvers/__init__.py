from .global_ops import global_dotprod, global_inf_norm, global_norm
from .matvec import companion_jacobian, make_fd_matvec, make_jvp_matvec, make_rat_matvec
from .kiops import kiops
from .kiops_jit import KiopsJitStats, kiops_jit
from .pmex import pmex
from .lowsync import (
    cwy_1s, cwy_ne, cwy_ne1s, dcgs2, icwy_1s, icwy_ne, icwy_ne1s, icwy_neiop, kiops_nest, lowsync_phi, pmex_1s,
    pmex_ne1s,
)
from .fgmres import fgmres
from .fgmres_jit import FgmresJitInfo, fgmres_jit
from .eigenvalue_util import gen_matrix, jacobian_matrix, save_spectrum
from .exode import exode
from .gcrot import gcrot
from .nonlin import newton_krylov
from .stats import PhiStats

__all__ = [
    "global_dotprod",
    "global_inf_norm",
    "global_norm",
    "companion_jacobian",
    "make_jvp_matvec",
    "make_fd_matvec",
    "make_rat_matvec",
    "kiops",
    "kiops_jit",
    "KiopsJitStats",
    "pmex",
    "pmex_1s",
    "pmex_ne1s",
    "cwy_1s",
    "cwy_ne",
    "cwy_ne1s",
    "icwy_1s",
    "icwy_ne",
    "icwy_ne1s",
    "icwy_neiop",
    "dcgs2",
    "kiops_nest",
    "lowsync_phi",
    "fgmres",
    "fgmres_jit",
    "FgmresJitInfo",
    "newton_krylov",
    "exode",
    "gcrot",
    "gen_matrix",
    "jacobian_matrix",
    "save_spectrum",
    "PhiStats",
]
