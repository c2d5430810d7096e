"""Direct Flux Reconstruction (DFR) element operator matrices.

Same code as ``wxfactory_tpu/ops/dfr.py`` (reference
``wx_factory/geometry/operators.py``, DFROperators): extrapolation of nodal
values to element faces, interior derivative matrices, boundary-correction
matrices, modal filters.

Every spatial operator is a single dense matrix applied to the trailing
``solpts^d`` axis of the state. The 1D building blocks are computed
symbolically on the host (sympy, ~34 digits) once at setup and
Kronecker-lifted to 2D/3D.

Element-internal node ordering (identical to the reference "new layout"):
2D: index = kz * s + kx (x fastest); 3D: index = (kz * s + ky) * s + kx.
Interface arrays pack both faces of an element on the trailing axis:
``[..., :s^(d-1)]`` = negative face, ``[..., s^(d-1):]`` = positive face.
"""

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Optional

import numpy as np
import sympy

from .quadrature import gauss_legendre, N_DIGITS


def lagrange_poly(x: sympy.Symbol, i: int, points) -> sympy.Expr:
    """Symbolic i-th Lagrange basis polynomial over the given points."""
    return sympy.prod([(x - points[j]) / (points[i] - points[j]) for j in range(len(points)) if j != i])


def lagrange_eval(points, new_pt) -> np.ndarray:
    """Evaluate every Lagrange basis polynomial of `points` at `new_pt`."""
    x = sympy.symbols("x")
    n = len(points)
    if n == 1:
        return np.ones(1)
    return np.array(
        [float(lagrange_poly(x, i, points).evalf(20, subs={x: new_pt})) for i in range(n)], dtype=np.float64
    )


def diffmat(points_sym) -> np.ndarray:
    """Differentiation matrix D[j, i] = dL_i/dx at x_j over the given (symbolic) points.

    Applied as ``f_nodes @ D.T`` -> derivative of the interpolant at the nodes.
    The result is skew-centrosymmetric for symmetric point sets; we enforce
    that exactly (removes last-ulp asymmetry from the symbolic evaluation).
    """
    x = sympy.symbols("x")
    m = len(points_sym)
    D = np.zeros((m, m))
    for i in range(m):
        dL = sympy.diff(lagrange_poly(x, i, points_sym), x)
        for j in range(m):
            D[j, i] = float(dL.evalf(N_DIGITS, subs={x: points_sym[j]}))
    # Enforce exact skew-centrosymmetry: D[i,j] == -D[n-1-i, n-1-j]
    D = 0.5 * (D - D[::-1, ::-1])
    return D


def legendre_vandermonde(x: np.ndarray, deg: int) -> np.ndarray:
    """Legendre Vandermonde matrix V[i, j] = P_j(x_i), via the recurrence."""
    x = np.asarray(x, dtype=np.float64)
    v = np.empty((deg + 1,) + x.shape, dtype=np.float64)
    v[0] = 1.0
    if deg > 0:
        v[1] = x
        for i in range(2, deg + 1):
            v[i] = (v[i - 1] * x * (2 * i - 1) - v[i - 2] * (i - 1)) / i
    return np.moveaxis(v, 0, -1)


def check_skew_centrosymmetry(m: np.ndarray) -> bool:
    """True iff m[i, j] == -m[n-1-i, n-1-j] for all entries."""
    return bool(np.array_equal(m, -m[::-1, ::-1]))


def remesh_operator(src_points: np.ndarray, target_points: np.ndarray) -> np.ndarray:
    """Modal projection operator between two nodal bases (used by p-multigrid).

    Transfers through Legendre modal space, keeping the common modes and
    damping the highest retained mode by 1/2 (as the reference's
    geometry/operators.py:773 remesh_operator does).
    """
    ns, nt = len(src_points), len(target_points)
    inv_v_src = np.linalg.inv(legendre_vandermonde(np.asarray(src_points), ns - 1))
    v_target = legendre_vandermonde(np.asarray(target_points), nt - 1)
    modes = np.zeros((nt, ns))
    k = min(ns, nt)
    for i in range(k):
        modes[i, i] = 1.0
    modes[k - 1, k - 1] = 0.5
    return v_target @ modes @ inv_v_src


def filter_exponential(n: int, nc: int, s: int, v: np.ndarray, inv_v: np.ndarray) -> np.ndarray:
    """Exponential modal filter F = V diag(sigma) V^-1 (Hesthaven & Warburton 5.16)."""
    alpha = -np.log(np.finfo(np.float64).eps)
    sigma = np.ones(n + 1)
    for i in range(nc, n + 1):
        t = (i - nc) / (n - nc)
        sigma[i] = np.exp(-alpha * t**s)
    return v @ np.diag(sigma) @ inv_v


@dataclass(frozen=True)
class DFROperators:
    """All element-local DFR operator matrices for a given polynomial order.

    Matrices are float64 numpy arrays shaped to act on the trailing axis of
    the state (``q @ op``). They are geometry-independent; the per-direction
    scaling (-2/dx etc.) is applied by the RHS.
    """

    num_solpts: int
    solpts: np.ndarray  # (s,) Gauss-Legendre nodes
    weights: np.ndarray  # (s,) quadrature weights
    extension: np.ndarray  # (s+2,) nodes with -1, +1 appended

    extrap_neg: np.ndarray  # (s,) nodal -> value at x=-1
    extrap_pos: np.ndarray  # (s,) nodal -> value at x=+1
    diff_ext: np.ndarray  # (s+2, s+2) derivative matrix on extension pts
    diff_solpt: np.ndarray  # (s, s) interior block of diff_ext
    correction: np.ndarray  # (s, 2) boundary columns of diff_ext
    diff: np.ndarray  # (s, s) plain derivative on solution points
    highfilter: np.ndarray  # (s, s) kill-highest-mode filter

    # 2D Kronecker-lifted (trailing axis s^2); identical names to reference API
    extrap_x: np.ndarray  # (s^2, 2s)
    extrap_z: np.ndarray  # (s^2, 2s)
    derivative_x: np.ndarray  # (s^2, s^2)
    derivative_z: np.ndarray  # (s^2, s^2)
    correction_WE: np.ndarray  # (2s, s^2)
    correction_DU: np.ndarray  # (2s, s^2)

    # 3D Kronecker-lifted (trailing axis s^3), built on demand
    extrap_x3: Optional[np.ndarray] = field(default=None, repr=False)
    extrap_y3: Optional[np.ndarray] = field(default=None, repr=False)
    extrap_z3: Optional[np.ndarray] = field(default=None, repr=False)
    derivative_x3: Optional[np.ndarray] = field(default=None, repr=False)
    derivative_y3: Optional[np.ndarray] = field(default=None, repr=False)
    derivative_z3: Optional[np.ndarray] = field(default=None, repr=False)
    correction_WE3: Optional[np.ndarray] = field(default=None, repr=False)
    correction_SN3: Optional[np.ndarray] = field(default=None, repr=False)
    correction_DU3: Optional[np.ndarray] = field(default=None, repr=False)
    highfilter_k: Optional[np.ndarray] = field(default=None, repr=False)
    quad_weights: Optional[np.ndarray] = field(default=None, repr=False)  # (s, s) outer product


@lru_cache(maxsize=None)
def make_dfr_operators(num_solpts: int, three_d: bool = False) -> DFROperators:
    """Build the DFR operator set for `num_solpts` Gauss-Legendre points.

    Mirrors the construction in the reference's geometry/operators.py:32-208
    but computed fresh from the mathematical definitions: Legendre modal
    extrapolation to the element faces, Lagrange differentiation over the
    extension points {-1} U nodes U {+1}, and boundary-correction columns.
    """
    s = num_solpts
    pts_sym, pts, wts = gauss_legendre(s)
    extension = np.concatenate(([-1.0], pts, [1.0]))
    extension_sym = [sympy.Integer(-1)] + list(pts_sym) + [sympy.Integer(1)]

    # Modal (Legendre) extrapolation of interior nodal values to the faces.
    v = legendre_vandermonde(pts, s - 1)
    inv_v = np.linalg.inv(v)
    extrap_neg = (legendre_vandermonde(np.array([-1.0]), s - 1) @ inv_v).reshape(-1)
    extrap_pos = (legendre_vandermonde(np.array([+1.0]), s - 1) @ inv_v).reshape(-1)

    # Highest-mode removal filter (used by the vertical gravity-forcing term).
    feye = np.eye(s)
    feye[-1, -1] = 0.0
    highfilter = v @ feye @ inv_v

    diff_ext = diffmat(extension_sym)
    if not check_skew_centrosymmetry(diff_ext):
        raise ValueError("DFR differentiation matrix lost skew-centrosymmetry")
    diff_solpt = np.ascontiguousarray(diff_ext[1:-1, 1:-1])
    correction = np.column_stack((diff_ext[1:-1, 0], diff_ext[1:-1, -1]))
    diff = diffmat(pts_sym)

    ident = np.eye(s)

    # --- 2D lifts (trailing axis ordering: kz * s + kx, x fastest)
    extrap_x = np.vstack((np.kron(ident, extrap_neg), np.kron(ident, extrap_pos))).T
    extrap_z = np.vstack((np.kron(extrap_neg, ident), np.kron(extrap_pos, ident))).T
    derivative_x = np.kron(ident, diff_solpt).T
    derivative_z = np.kron(diff_solpt, ident).T
    corr_neg = diff_ext[1:-1, 0]
    corr_pos = diff_ext[1:-1, -1]
    correction_WE = np.vstack((np.kron(ident, corr_neg), np.kron(ident, corr_pos)))
    correction_DU = np.vstack((np.kron(corr_neg, ident), np.kron(corr_pos, ident)))

    kwargs = {}
    if three_d:
        i2 = np.eye(s)
        i3 = np.eye(s * s)
        kwargs = dict(
            extrap_x3=np.vstack((np.kron(i3, extrap_neg), np.kron(i3, extrap_pos))).T,
            extrap_y3=np.vstack(
                (np.kron(i2, np.kron(extrap_neg, i2)), np.kron(i2, np.kron(extrap_pos, i2)))
            ).T,
            extrap_z3=np.vstack((np.kron(extrap_neg, i3), np.kron(extrap_pos, i3))).T,
            derivative_x3=np.kron(i3, diff_solpt).T,
            derivative_y3=np.kron(i2, np.kron(diff_solpt, i2)).T,
            derivative_z3=np.kron(diff_solpt, i3).T,
            correction_WE3=np.vstack((np.kron(i3, corr_neg), np.kron(i3, corr_pos))),
            correction_SN3=np.vstack((np.kron(i2, np.kron(corr_neg, i2)), np.kron(i2, np.kron(corr_pos, i2)))),
            correction_DU3=np.vstack((np.kron(corr_neg, i3), np.kron(corr_pos, i3))),
            highfilter_k=np.kron(highfilter.T, np.eye(s * s)),
        )

    return DFROperators(
        num_solpts=s,
        solpts=pts,
        weights=wts,
        extension=extension,
        extrap_neg=extrap_neg,
        extrap_pos=extrap_pos,
        diff_ext=diff_ext,
        diff_solpt=diff_solpt,
        correction=correction,
        diff=diff,
        highfilter=highfilter,
        extrap_x=extrap_x,
        extrap_z=extrap_z,
        derivative_x=derivative_x,
        derivative_z=derivative_z,
        correction_WE=correction_WE,
        correction_DU=correction_DU,
        quad_weights=np.outer(wts, wts),
        **kwargs,
    )


def make_filter_matrix(num_solpts: int, alpha: float, order: int, cutoff: float) -> np.ndarray:
    """Exponential modal filter on the solution points (reference operators.py:210)."""
    _, pts, _ = gauss_legendre(num_solpts)
    modes = np.arange(num_solpts) / (num_solpts - 1)
    residual = np.ones_like(modes)
    mask = modes > cutoff
    residual[mask] = np.exp(-alpha * ((modes[mask] - cutoff) / (1 - cutoff)) ** order)
    vander = legendre_vandermonde(pts, num_solpts - 1)
    return vander @ np.diag(residual) @ np.linalg.inv(vander)
