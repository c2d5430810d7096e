"""Matsuno equatorial-wave analytic solutions (Shamir et al. 2019, GMD 12,
2181-2193 — the pymaws algorithm; reference init/matsuno.py).

Vectorized over the whole grid (the reference evaluates point by point).
Gives the analytic (u, v, phi) fields of Rossby / EIG / WIG modes at any
time, used both as the case-9 initial condition and as the error reference.

Counterpart of ``wxfactory_tpu/testcases/matsuno.py``, same code.
"""

import math
from typing import Dict

import numpy as np

EARTH = {
    "angular_frequency": 7.29212e-5,
    "gravitational_acceleration": 9.80616,
    "mean_radius": 6371220.0,
    "layer_mean_depth": 30.0,
}


def eval_omega(k: int, n: int, parameters: Dict = EARTH) -> Dict[str, float]:
    """Wave frequencies of the three modes for wave number k, mode n
    (cubic dispersion relation, Eqs. 2-5 of the paper)."""
    if k < 1 or n < 1:
        raise ValueError("only k>=1, n>=1 supported")
    om = parameters["angular_frequency"]
    g = parameters["gravitational_acceleration"]
    a = parameters["mean_radius"]
    h0 = parameters["layer_mean_depth"]

    delta0 = 3.0 * (g * h0 * (k / a) ** 2 + 2.0 * om * math.sqrt(g * h0) / a * (2 * n + 1))
    delta4 = -54.0 * om * g * h0 * k / a**2
    omegaj = np.zeros(3)
    for j in range(1, 4):
        dj = (delta4**2 - 4.0 * delta0**3 + 0j) ** 0.5
        dj = (0.5 * (delta4 + dj)) ** (1.0 / 3.0)
        dj = dj * np.exp(2.0 * np.pi * 1j * j / 3.0)
        omegaj[j - 1] = np.real(-(dj + delta0 / dj) / 3.0)
    return {"rossby": -np.min(np.abs(omegaj)), "wig": float(np.min(omegaj)), "eig": float(np.max(omegaj))}


def hermite_normalized(x: np.ndarray, n: int) -> np.ndarray:
    """Normalized Hermite polynomial H_n via the stable recurrence (Eq. 7)."""
    if n < 0:
        return np.zeros_like(x)
    h_prev = np.ones_like(x) / np.pi**0.25
    if n == 0:
        return h_prev
    h = (4.0 / np.pi) ** 0.25 * x
    for m in range(2, n + 1):
        h, h_prev = (2.0 / m) ** 0.5 * x * h - ((m - 1) / m) ** 0.5 * h_prev, h
    return h


def _v_amplitude(lat, lamb, n, amp):
    y = lamb**0.25 * lat
    return amp * np.exp(-0.5 * y**2) * hermite_normalized(y, n)


def eval_field(
    lat: np.ndarray,
    lon: np.ndarray,
    time: float,
    k: int = 5,
    n: int = 1,
    amp: float = 1e-5,
    field: str = "phi",
    wave_type: str = "rossby",
    parameters: Dict = EARTH,
) -> np.ndarray:
    """Analytic u / v / phi field of the chosen wave at the given time."""
    om = parameters["angular_frequency"]
    g = parameters["gravitational_acceleration"]
    a = parameters["mean_radius"]
    h0 = parameters["layer_mean_depth"]
    lamb = (2.0 * om * a) ** 2 / (g * h0)
    omega = eval_omega(k, n, parameters)[wave_type.lower()]

    v_hat = _v_amplitude(lat, lamb, n, amp)
    if field == "v":
        f_hat = v_hat
    else:
        vp = _v_amplitude(lat, lamb, n + 1, amp)
        vm = _v_amplitude(lat, lamb, n - 1, amp)
        c = math.sqrt(g * h0)
        pref = g * h0 * lamb**0.25 / (1j * a * (omega**2 - g * h0 * (k / a) ** 2))
        if field == "u":
            f_hat = pref * (
                -math.sqrt((n + 1) / 2.0) * (omega / c + k / a) * vp
                - math.sqrt(n / 2.0) * (omega / c - k / a) * vm
            )
        elif field == "phi":
            f_hat = pref * (
                -math.sqrt((n + 1) / 2.0) * (omega + c * k / a) * vp
                + math.sqrt(n / 2.0) * (omega - c * k / a) * vm
            )
        else:
            raise KeyError("field must be u, v or phi")

    f = np.real(np.exp(1j * (k * lon - omega * time)) * f_hat)
    if field == "phi":
        f = f + g * h0
    return f


def case_matsuno(geom, wave_type: str = "rossby", amp: float = 1e-5, time: float = 0.0) -> np.ndarray:
    """SW case 9 initial state Q = [h, h*u1, h*u2] from the analytic wave."""
    g = EARTH["gravitational_acceleration"]
    h = eval_field(geom.lat, geom.lon, time, field="phi", wave_type=wave_type, amp=amp) / g
    u = eval_field(geom.lat, geom.lon, time, field="u", wave_type=wave_type, amp=amp)
    v = eval_field(geom.lat, geom.lon, time, field="v", wave_type=wave_type, amp=amp)
    u1, u2 = geom.wind2contra(u, v)
    return np.stack([h, h * u1, h * u2])
