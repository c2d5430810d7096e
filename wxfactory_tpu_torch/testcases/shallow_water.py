"""Shallow-water test cases on the cubed sphere (host numpy, float64).

Counterpart of ``wxfactory_tpu/testcases/shallow_water.py``: Williamson et
al. (1992) cases 2 and 6, same code. The other cases wait for the port's
topography and perturbation forms (ROADMAP queue 1, item 3) and raise.
"""

import math
from dataclasses import dataclass

import numpy as np

from ..common.constants import DAY_IN_SECS, GRAVITY


@dataclass(frozen=True)
class Topography:
    """Bottom topography fields (same fields as the JAX package's
    ``models.shallow_water.Topography``). No case of the port builds one
    yet; the shallow-water model refuses it rather than ignore it."""

    hsurf: np.ndarray  # (6, ny, nx, s^2)
    hsurf_itf_x1: np.ndarray  # (6, ny, nx+1, s) at x1 interfaces
    hsurf_itf_x2: np.ndarray  # (6, ny+1, nx, s) at x2 interfaces
    dzdx1: np.ndarray  # (6, ny, nx, s^2)
    dzdx2: np.ndarray


def solid_body_rotation(geom, case_number: int = 2):
    """Zonal solid-body rotation wind field (reference shallow_water_test.py:29)."""
    if case_number == 5:
        u0 = 20.0
    else:
        u0 = 2.0 * math.pi * geom.earth_radius / (12.0 * DAY_IN_SECS)
    u = u0 * geom.coslat
    v = np.zeros_like(u)
    return geom.wind2contra(u, v)


def williamson_case2(geom) -> np.ndarray:
    """Steady-state nonlinear zonal geostrophic flow. Q = [h, hu1, hu2]."""
    u1, u2 = solid_body_rotation(geom, 2)
    h = height_case2(geom)
    return np.stack([h, h * u1, h * u2])


def height_case2(geom) -> np.ndarray:
    gh0 = 29400.0
    u0 = 2.0 * math.pi * geom.earth_radius / (12.0 * DAY_IN_SECS)
    return (gh0 - (geom.earth_radius * geom.rotation_speed * u0 + 0.5 * u0**2) * geom.sinlat**2) / GRAVITY


def williamson_case6(geom) -> np.ndarray:
    """Rossby-Haurwitz wave (reference shallow_water_test.py:223-273)."""
    R = 4
    omega = 7.848e-6
    K = omega
    h0 = 8000.0
    O = geom.rotation_speed
    coslat, sinlat, lon = geom.coslat, geom.sinlat, geom.lon

    A = 0.5 * omega * (2.0 * O + omega) * coslat**2 + 0.25 * K**2 * coslat ** (2 * R) * (
        (R + 1) * coslat**2 + (2.0 * R**2 - R - 2.0) - 2.0 * R**2 * coslat ** (-2)
    )
    B = (
        2.0
        * (O + omega)
        * K
        / ((R + 1) * (R + 2))
        * coslat**R
        * ((R**2 + 2 * R + 2) - (R + 1) ** 2 * coslat**2)
    )
    C = 0.25 * K**2 * coslat ** (2 * R) * ((R + 1) * coslat**2 - (R + 2.0))

    r = geom.earth_radius
    h = h0 + (r**2 * A + r**2 * B * np.cos(R * lon) + r**2 * C * np.cos(2.0 * R * lon)) / GRAVITY

    u = r * omega * coslat + r * K * coslat ** (R - 1) * (R * sinlat**2 - coslat**2) * np.cos(R * lon)
    v = -r * K * R * coslat ** (R - 1) * sinlat * np.sin(R * lon)
    u1, u2 = geom.wind2contra(u, v)
    return np.stack([h, h * u1, h * u2])


def initial_state(geom, case_number: int) -> np.ndarray:
    """Initial shallow-water state of a Williamson case the port runs."""
    if case_number == 2:
        return williamson_case2(geom)
    if case_number == 6:
        return williamson_case6(geom)
    raise NotImplementedError(
        f"Shallow-water case {case_number} is not ported yet (ROADMAP queue 1, item 3: "
        "SW test cases; cases 5 and 10 also need the topography form of item 4)"
    )
