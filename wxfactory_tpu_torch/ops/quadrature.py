"""Gauss-Legendre quadrature nodes and weights (host-side, high precision).

Capability parity with the reference's ``wx_factory/geometry/quadrature.py``
(gauss_legendre): nodes are computed symbolically (sympy) at 34 digits so the
downstream Lagrange-derivative operator matrices are accurate to the last
float64 ulp, which the reference requires for its skew-centrosymmetry check.

All of this runs once at setup on the host; the resulting float64 matrices
become compile-time constants of the jitted RHS.
"""

from functools import lru_cache
from typing import List, Tuple

import numpy as np
import sympy

N_DIGITS = 34  # ~quadruple precision, same as the reference


@lru_cache(maxsize=None)
def _gauss_legendre_sym(n: int) -> Tuple[Tuple[sympy.Expr, ...], Tuple[sympy.Expr, ...]]:
    """Symbolic Gauss-Legendre nodes and weights on [-1, 1].

    Nodes are the roots of P_n; weights w_i = 2 / ((1 - x_i^2) P_n'(x_i)^2).
    """
    x = sympy.symbols("x")
    poly = sympy.legendre(n, x)
    # real_roots returns sorted exact/CRootOf roots
    roots = sympy.Poly(poly, x).real_roots()
    dpoly = sympy.diff(poly, x)
    weights = []
    for r in roots:
        rr = sympy.Float(r.evalf(N_DIGITS), N_DIGITS)
        dp = dpoly.evalf(N_DIGITS, subs={x: rr})
        weights.append(2 / ((1 - rr**2) * dp**2))
    return tuple(roots), tuple(weights)


def gauss_legendre(n: int) -> Tuple[List[sympy.Expr], np.ndarray, np.ndarray]:
    """Gauss-Legendre quadrature points (symbolic + float64) and weights.

    Returns ``(points_sym, points, weights)`` with points sorted ascending.
    """
    if n < 1:
        raise ValueError(f"Invalid number of quadrature points: {n}")
    roots, weights = _gauss_legendre_sym(n)
    points_sym = [sympy.Float(r.evalf(N_DIGITS), N_DIGITS) if not r.is_Float else r for r in roots]
    points = np.array([float(p.evalf(N_DIGITS)) for p in roots], dtype=np.float64)
    weights_num = np.array([float(w) for w in weights], dtype=np.float64)
    return points_sym, points, weights_num
