from .quadrature import gauss_legendre
from .dfr import (
    DFROperators,
    check_skew_centrosymmetry,
    diffmat,
    lagrange_eval,
    legendre_vandermonde,
    make_dfr_operators,
    make_filter_matrix,
    remesh_operator,
)

__all__ = [
    "gauss_legendre",
    "DFROperators",
    "check_skew_centrosymmetry",
    "diffmat",
    "lagrange_eval",
    "legendre_vandermonde",
    "make_dfr_operators",
    "make_filter_matrix",
    "remesh_operator",
]
