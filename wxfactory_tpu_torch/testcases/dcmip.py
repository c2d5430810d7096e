"""DCMIP test cases for the 3D Euler equations on the cubed sphere (host
numpy, float64).

Counterpart of ``wxfactory_tpu/testcases/dcmip.py`` (reference
init/dcmip.py) for the cases the port runs, same code: 31 (non-hydrostatic
gravity wave on a reduced planet) and 77 (acoustic wave). Each returns the
global state ``Q[5, 6, nk, ny, nx, s^3]`` (rho, rho*u1, rho*u2, rho*w,
rho*theta). The reduced-planet configuration is the geometry's
(``make_cubed_sphere_3d(planet_scaling_factor=..., planet_is_rotating=...)``,
``dcmip_planet_params``).
"""

import math
from typing import Tuple

import numpy as np

from ..common.constants import CPD, GRAVITY, P0, RD


def dcmip_planet_params(case_number: int) -> Tuple[float, bool]:
    """(planet scaling factor, rotating) of a DCMIP case (reference
    cubed_sphere_3d.py:408-432; the JAX package's
    ``simulation._dcmip_planet_params``)."""
    if case_number == 31:
        return 125.0, False
    if case_number == 20:
        return 1.0, False
    if case_number in (21, 22):
        return 500.0, False
    return 1.0, True


def _assemble(rho, u1, u2, w, theta):
    return np.stack([rho, rho * u1, rho * u2, rho * w, rho * theta])


def dcmip_gravity_wave(geom) -> np.ndarray:
    """DCMIP case 31: gravity wave along the equator on a small planet
    (reference init/dcmip.py:763-880). Geometry must be built with
    planet_scaling_factor=125, planet_is_rotating=False, ztop=10000."""
    u0 = 20.0
    Teq = 300.0
    Peq = 100000.0
    lambdac = 2.0 * math.pi / 3.0
    d = 5000.0
    phic = 0.0
    delta_theta = 1.0
    Lz = 20000.0
    N2 = 0.01**2
    bigG = GRAVITY**2 / (N2 * CPD)
    kappa = RD / CPD
    inv_kappa = CPD / RD

    lat, lon, z = geom.lat, geom.lon, geom.height
    a = geom.earth_radius
    omega = geom.rotation_speed

    u = u0 * np.cos(lat)
    v = np.zeros_like(u)
    w = np.zeros_like(u)

    ts = bigG + (Teq - bigG) * np.exp(
        -(u0 * N2 / (4.0 * GRAVITY**2)) * (u0 + 2.0 * omega * a) * (np.cos(2.0 * lat) - 1.0)
    )
    ps = (
        Peq
        * np.exp((u0 / (4.0 * bigG * RD)) * (u0 + 2.0 * omega * a) * (np.cos(2.0 * lat) - 1.0))
        * (ts / Teq) ** inv_kappa
    )
    p = ps * ((bigG / ts) * np.exp(-N2 * z / GRAVITY) + 1.0 - bigG / ts) ** inv_kappa
    t_mean = bigG * (1.0 - np.exp(N2 * z / GRAVITY)) + ts * np.exp(N2 * z / GRAVITY)
    theta_base = t_mean * (P0 / p) ** kappa
    rho = p / (RD * t_mean)

    sin_tmp = np.sin(lat) * math.sin(phic)
    cos_tmp = np.cos(lat) * math.cos(phic)
    r = a * np.arccos(np.clip(sin_tmp + cos_tmp * np.cos(lon - lambdac), -1.0, 1.0))
    shape = d**2 / (d**2 + r**2)
    theta = theta_base + delta_theta * shape * np.sin(2.0 * math.pi * z / Lz)

    u1, u2 = geom.wind2contra_2d(u, v)
    return _assemble(rho, u1, u2, w, theta)


def acoustic_wave(geom) -> np.ndarray:
    """Case 77: acoustic wave in an isothermal atmosphere at rest
    (reference init/dcmip.py:889-966). ztop = 10000, normal planet."""
    T0 = 300.0
    delta_p = 100.0
    eta_v = 1
    re = 6371000.0
    rc = re / 3.0
    ztop = 10000.0

    lat, lon, z = geom.lat, geom.lon, geom.height

    H = RD * T0 / GRAVITY
    p_mean = P0 * np.exp(-z / H)
    r = re * np.arccos(np.clip(np.cos(lat) * np.cos(lon), -1.0, 1.0))
    f = np.where(r > rc, 0.0, 0.5 * delta_p * (1.0 + np.cos(math.pi * r / rc)))
    g = np.sin(eta_v * math.pi * r / ztop)
    pressure = p_mean + f * g

    rho = pressure / (RD * T0)
    theta = T0 * (P0 / pressure) ** (RD / CPD)

    zero = np.zeros_like(rho)
    u1, u2 = geom.wind2contra_2d(zero, zero)
    return _assemble(rho, u1, u2, zero, theta)


def initial_state_3d(geom, case_number: int) -> np.ndarray:
    """Initial 3D Euler state of a DCMIP case the port runs (31, 77).

    The other cases of the JAX package raise: 11 and 12 are advection-only
    with prescribed winds, 20 has topography (panel-dependent metric), 21
    and 22 have topography and Rayleigh-damping forcing."""
    if case_number == 31:
        return dcmip_gravity_wave(geom)
    if case_number == 77:
        return acoustic_wave(geom)
    reasons = {
        11: "advection-only transport with prescribed winds and tracers (ROADMAP queue 1, item 9)",
        12: "advection-only transport with prescribed winds and tracers (ROADMAP queue 1, item 9)",
        20: "topography: the operator's one-panel metric does not hold (ROADMAP queue 1, item 9)",
        21: "topography and Rayleigh-damping forcing (ROADMAP queue 1, item 9)",
        22: "topography and Rayleigh-damping forcing (ROADMAP queue 1, item 9)",
    }
    raise NotImplementedError(
        f"3D Euler case {case_number} is not ported yet: "
        + reasons.get(case_number, "unknown case (the port runs DCMIP 31 and 77)")
    )
