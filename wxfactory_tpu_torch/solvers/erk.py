"""Adaptive embedded explicit Runge-Kutta engine (the EXODE backend).

Counterpart of ``wxfactory_tpu/solvers/erk.py``: the tableaux, the arctan
step-ratio limiter, the deadbeat/PI/H211 step-size controller family, the
FSAL handling and the min-step rules of the reference's
integrators/explicit_runge_kutta.py and integrators/butcher.py. The
controller runs on the host; every stage evaluation is a call of ``fun`` on
the state's device (in EXODE one Jacobian action: one launch of a tangent
apply kernel on the card), and the stage combinations run there too. An
attempt's error norms (the scaled inf-norm, DOP853's second estimate and
the unscaled inf-norm the result reports) come to the host in ONE counted
read (``common.device.host_read``).

Tableaus are the published coefficients of each method:

- BS3(2)    Bogacki & Shampine 1989 (FSAL)
- DP5(4)    Dormand & Prince 1980 (FSAL)
- M4(3)     Merson 1957 (order 5 on linear homogeneous problems)
- KC3(2)    Kennedy & Carpenter 2003, ARK3(2)4L[2]SA-ERK explicit tableau
- EXLRK3(2) classic Kutta 3-stage with embedded 2nd-order weights
- EXLRK4(3) classic RK4 with embedded 3rd-order weights
- DP8(7)    Hairer's 8th-order DOP853 tableau with the combined 5th/3rd
            order error estimator (scipy publishes the coefficients)
- F10(8)    Feagin RK10(8), 17 stages
- F14(12)   Feagin RK14(12), 35 stages
            The Feagin coefficient payloads (published numerical tables,
            T. Feagin, https://sce.uhcl.edu/rungekutta/) are this package's
            own copy, solvers/data_feagin.npz.
"""

import math
import os
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ..common.device import host_read

BIG_FACTOR = 4.0

# (kb1, kb2, a, g) per controller: reference explicit_runge_kutta.py:257-265.
CONTROLLERS = {
    "DEADBEAT": (1, 0, 0, 0.9),  # elementary (I) controller
    "PI3040": (0.7, -0.4, 0, 0.8),  # Gustafsson PI
    "PI4020": (0.6, -0.2, 0, 0.8),  # PI for nonstiff methods
    "H211PI": (1 / 6, 1 / 6, 0, 0.8),  # LP filter of PI structure
    "H110": (1 / 3, 0, 0, 0.8),  # I controller (convolution filter)
    "H211D": (1 / 2, 1 / 2, 1 / 2, 0.8),  # LP filter, gain 1/2
    "H211B": (1 / 4, 1 / 4, 1 / 4, 0.8),  # general-purpose LP filter
}


def limiter(u: float, kappa: float = 2.0) -> float:
    """Arctan step-size-ratio limiter (reference explicit_runge_kutta.py:16)."""
    return 1.0 + kappa * math.atan((u - 1.0) / kappa)


@dataclass(frozen=True)
class Tableau:
    A: np.ndarray  # (s, s) strictly lower triangular
    B: np.ndarray  # (s,)
    C: np.ndarray  # (s,)
    E: np.ndarray  # (s+1,) embedded-difference weights; E[-1] != 0 => FSAL
    order: int
    error_estimator_order: int
    E3: Optional[np.ndarray] = None  # second error vector (DOP853 estimator)

    @property
    def n_stages(self) -> int:
        return len(self.B)

    @property
    def fsal(self) -> bool:
        return bool(self.E[-1])


def _bs32() -> Tableau:
    A = np.zeros((3, 3))
    A[1, 0] = 1 / 2
    A[2, 1] = 3 / 4
    B = np.array([2 / 9, 1 / 3, 4 / 9])
    bh = np.array([7 / 24, 1 / 4, 1 / 3, 1 / 8])
    E = bh.copy()
    E[:3] -= B
    return Tableau(A, B, np.array([0, 1 / 2, 3 / 4]), E, 3, 2)


def _dp54() -> Tableau:
    A = np.zeros((6, 6))
    A[1, :1] = [1 / 5]
    A[2, :2] = [3 / 40, 9 / 40]
    A[3, :3] = [44 / 45, -56 / 15, 32 / 9]
    A[4, :4] = [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729]
    A[5, :5] = [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656]
    B = np.array([35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84])
    E = np.array([-71 / 57600, 0, 71 / 16695, -71 / 1920, 17253 / 339200, -22 / 525, 1 / 40])
    return Tableau(A, B, np.array([0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1]), E, 5, 4)


def _m43() -> Tableau:
    A = np.zeros((5, 5))
    A[1, :1] = [1 / 3]
    A[2, :2] = [1 / 6, 1 / 6]
    A[3, :3] = [1 / 8, 0, 3 / 8]
    A[4, :4] = [1 / 2, 0, -3 / 2, 2]
    B = np.array([1 / 6, 0, 0, 2 / 3, 1 / 6])
    bh = np.array([1 / 10, 0, 3 / 10, 2 / 5, 1 / 5, 0])
    E = bh.copy()
    E[:5] -= B
    return Tableau(A, B, np.array([0, 1 / 3, 1 / 3, 1 / 2, 1]), E, 4, 3)


def _kc32() -> Tableau:
    # Kennedy & Carpenter 2003, ARK3(2)4L[2]SA: the explicit tableau.
    A = np.zeros((4, 4))
    A[1, :1] = [1767732205903 / 2027836641118]
    A[2, :2] = [5535828885825 / 10492691773637, 788022342437 / 10882634858940]
    A[3, :3] = [
        6485989280629 / 16251701735622,
        -4246266847089 / 9704473918619,
        10755448449292 / 10357097424841,
    ]
    B = np.array(
        [
            1471266399579 / 7840856788654,
            -4482444167858 / 7529755066697,
            11266239266428 / 11593286722821,
            1767732205903 / 4055673282236,
        ]
    )
    bh = np.array(
        [
            2756255671327 / 12835298489170,
            -10771552573575 / 22201958757719,
            9247589265047 / 10645013368117,
            2193209047091 / 5459859503100,
        ]
    )
    E = np.concatenate([bh - B, [0.0]])
    C = np.array([0.0, 1767732205903 / 2027836641118, 3 / 5, 1.0])
    return Tableau(A, B, C, E, 3, 2)


def _exlrk32() -> Tableau:
    A = np.zeros((3, 3))
    A[1, 0] = 1 / 2
    A[2, :2] = [-1.0, 2.0]
    B = np.array([1 / 6, 2 / 3, 1 / 6])
    bh = np.array([0.25, 0.5, 0.1, 0.15])
    E = bh.copy()
    E[:3] -= B
    return Tableau(A, B, np.array([0.0, 1 / 2, 1.0]), E, 3, 2)


def _exlrk43() -> Tableau:
    A = np.zeros((4, 4))
    A[1, 0] = 1 / 2
    A[2, 1] = 1 / 2
    A[3, 2] = 1.0
    B = np.array([1 / 6, 1 / 3, 1 / 3, 1 / 6])
    bh = np.array([1 / 6, 1 / 3, 1 / 3, 41 / 300, 3 / 100])
    E = bh.copy()
    E[:4] -= B
    return Tableau(A, B, np.array([0.0, 1 / 2, 1 / 2, 1.0]), E, 4, 3)


def _dp87() -> Tableau:
    from scipy.integrate._ivp import dop853_coefficients as dc

    ns = dc.N_STAGES  # 12
    A = np.array(dc.A[:ns, :ns], dtype=np.float64)
    B = np.array(dc.B, dtype=np.float64)
    C = np.array(dc.C[:ns], dtype=np.float64)
    E5 = np.array(dc.E5, dtype=np.float64)  # (ns+1,), FSAL slot at the end
    E3 = np.array(dc.E3, dtype=np.float64)
    return Tableau(A, B, C, E5, 8, 7, E3=E3)


def _feagin(key: str, order: int, eeo: int) -> Tableau:
    """Feagin RK10(8) / RK14(12): published coefficient payloads loaded from
    binary data (E is already in embedded-difference form, non-FSAL)."""
    path = os.path.join(os.path.dirname(__file__), "data_feagin.npz")
    d = np.load(path)
    return Tableau(d[f"{key}_A"], d[f"{key}_B"], d[f"{key}_C"], d[f"{key}_E"], order, eeo)


_BUILDERS = {
    "BS3(2)": _bs32,
    "DP5(4)": _dp54,
    "M4(3)": _m43,
    "KC3(2)": _kc32,
    "ARK3(2)4L[2]SA-ERK": _kc32,
    "EXLRK3(2)": _exlrk32,
    "EXLRK4(3)": _exlrk43,
    "DP8(7)": _dp87,
    "F10(8)": lambda: _feagin("f108", 10, 8),
    "F14(12)": lambda: _feagin("f1412", 14, 12),
}


def get_tableau(method: str) -> Tableau:
    key = method.upper().replace(" ", "")
    if key not in _BUILDERS:
        raise ValueError(f"`method` must be one of {sorted(_BUILDERS)}, got {method!r}")
    tab = _BUILDERS[key]()
    # Row-sum consistency C_i = sum_j A_ij (order-1 condition), sum B = 1.
    assert np.allclose(tab.A.sum(axis=1), tab.C, atol=1e-12), method
    assert abs(tab.B.sum() - 1.0) < 1e-12, method
    return tab


@dataclass
class ErkResult:
    y: torch.Tensor
    status: str  # "finished" | "failed"
    nfev: int
    num_steps: int
    failed_steps: int
    h_final: float  # proposed step for a warm restart
    h_mean: float  # mean accepted step
    error_estimation: float


def erk_integrate(
    fun: Callable,
    t0: float,
    y0: torch.Tensor,
    t_bound: float,
    method: str = "BS3(2)",
    controller: Union[str, Tuple[float, float, float, float], None] = None,
    rtol: float = 1e-3,
    atol: float = 1e-6,
    first_step: Optional[float] = None,
    max_step: float = np.inf,
    max_steps: int = 100_000,
) -> ErkResult:
    """Integrate y' = fun(t, y) from t0 to t_bound with an embedded RK pair.

    ``y0`` and what ``fun`` returns are tensors on one device. Semantics of
    reference explicit_runge_kutta.py:294-434: per-attempt stage loop, FSAL
    error term, arctan limiter, second-order (two-error-history) step-size
    controller with the DEADBEAT/PI/H211 coefficient families.
    """
    tab = get_tableau(method)
    ns = tab.n_stages

    if isinstance(controller, tuple) and len(controller) == 4:
        kb1, kb2, a, g = controller
    else:
        name = (controller or "DEADBEAT").upper()
        if name not in CONTROLLERS:
            raise ValueError(f"Invalid controller {controller!r}; must be one of {list(CONTROLLERS)} or a 4-tuple")
        kb1, kb2, a, g = CONTROLLERS[name]

    error_exponent = -1.0 / (tab.error_estimator_order + 1)
    minbeta1 = kb1 * error_exponent
    minbeta2 = kb2 * error_exponent
    minalpha = -a
    safety = g
    safety_sc = g ** (kb1 + kb2)

    # Min-step rule parameters (reference :437-470).
    cdiff = 1.0
    for c1 in tab.C:
        for c2 in tab.C:
            d = abs(c1 - c2)
            if d:
                cdiff = min(cdiff, d)
    cdiff = max(cdiff, 1e-3)
    fi = np.finfo(np.float32 if y0.dtype == torch.float32 else np.float64)
    h_min_a = 10 * fi.epsneg / cdiff
    h_min_b = math.sqrt(fi.tiny)
    tiny_err = h_min_b

    t = float(t0)
    t_end = float(t_bound)
    y = y0
    f = fun(t, y)
    nfev = 1
    if first_step is None:
        first_step = abs(t_end - t0)
    h = min(float(first_step), abs(t_end - t0))
    if h <= 0:
        raise ValueError("`first_step` must be positive")

    err_old = 1.0
    standard_sc = True
    num_steps = 0
    failed_steps = 0
    h_accum = 0.0
    n_accepted = 0
    error_estimation = 0.0

    A, B, C, E, E3 = tab.A, tab.B, tab.C, tab.E, tab.E3

    while t < t_end:
        if num_steps >= max_steps:
            return ErkResult(y, "failed", nfev, num_steps, failed_steps, h, 0.0, error_estimation)

        # Reassess step size (reference :472-530).
        min_step = max(h_min_a * (abs(t) + h), h_min_b)
        if h < min_step or h > max_step:
            h = min(max_step, max(min_step, h))
            standard_sc = True
        d = abs(t_end - t)
        if d < 2 * h:
            if d > h:
                h = max(0.5 * d, min_step)
                standard_sc = True
            else:
                h = d

        h_previous = h
        step_accepted = False
        step_rejected = False

        while not step_accepted:
            if h < min_step:
                return ErkResult(y, "failed", nfev, num_steps, failed_steps, h, 0.0, error_estimation)

            K = [f]
            for i in range(1, ns):
                dy = h * sum(A[i, j] * K[j] for j in range(i) if A[i, j])
                K.append(fun(t + C[i] * h, y + dy))
                nfev += 1
            y_new = y + h * sum(B[j] * K[j] for j in range(ns) if B[j])

            if tab.fsal:
                K.append(fun(t + h, y_new))
                nfev += 1

            scale = atol + torch.maximum(y.abs(), y_new.abs()) * rtol
            nK = ns + (1 if tab.fsal else 0)
            err_vec = h * sum(E[j] * K[j] for j in range(nK) if E[j])
            # The attempt's norms in one read: the scaled error, the unscaled
            # one (the accepted step's error estimate) and DOP853's second.
            norms = [(err_vec / scale).abs().max(), err_vec.abs().max()]
            if E3 is not None:
                err3_vec = h * sum(E3[j] * K[j] for j in range(nK) if E3[j])
                norms.append((err3_vec / scale).abs().max())
            norms = host_read(torch.stack(norms))
            if E3 is not None:
                # DOP853 combined 5th/3rd-order estimator (inf-norm variant).
                e5, e3 = norms[0], norms[2]
                den = math.hypot(e5, 0.1 * e3)
                error_norm = e5 * (e5 / den) if den > 0 else 0.0
            else:
                error_norm = norms[0]

            if error_norm < 1.0:
                step_accepted = True
                if error_norm < tiny_err:
                    factor = BIG_FACTOR
                    standard_sc = True
                elif standard_sc:
                    factor = safety * error_norm**error_exponent
                    standard_sc = False
                else:
                    h_ratio = h / h_previous
                    factor = safety_sc * (
                        max(error_norm, tiny_err) ** minbeta1
                        * max(err_old, tiny_err) ** minbeta2
                        * h_ratio**minalpha
                    )
                if step_rejected:
                    factor = min(1.0, factor)

                h_accepted = h
                h *= limiter(factor)
                num_steps += 1
            else:
                step_rejected = True
                h *= limiter(safety * max(error_norm, tiny_err) ** error_exponent)
                if h < 1e-12:
                    return ErkResult(y, "failed", nfev, num_steps, failed_steps, h, 0.0, error_estimation)
                failed_steps += 1
                num_steps += 1
                if math.isnan(error_norm) or math.isinf(error_norm):
                    return ErkResult(y, "failed", nfev, num_steps, failed_steps, h, 0.0, error_estimation)

        if tab.fsal:
            f = K[ns]
        else:
            f = fun(t + h_accepted, y_new)
            nfev += 1
        err_old = error_norm
        error_estimation = norms[1]
        t = t + h_accepted
        y = y_new
        h_accum += h_accepted
        n_accepted += 1

    h_mean = h_accum / n_accepted if n_accepted else 0.0
    return ErkResult(y, "finished", nfev, num_steps, failed_steps, h, h_mean, error_estimation)
