"""Shallow-water test cases on the cubed sphere (host numpy, float64).

Counterpart of ``wxfactory_tpu/testcases/shallow_water.py``, same code:
Williamson et al. (1992) cases 1, 2, 5 and 6, the circular vortex (case
0), the Galewsky et al. (2004) barotropic-instability jet (case 8) and the
Laeuter et al. (2005) unsteady zonal flow (case 10). Cases 5 and 10 return
their bottom topography (``models.shallow_water.Topography``) beside the
state. ``initial_state`` dispatches on the case number as the JAX
package's ``Simulation._init_sw`` does; case 9 (Matsuno) is
``testcases.matsuno``.
"""

import math
from typing import Tuple

import numpy as np

from ..common.constants import DAY_IN_SECS, GRAVITY
from ..models.shallow_water import Topography

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


def williamson_case5(geom, ops) -> Tuple[np.ndarray, Topography]:
    """Zonal flow over an isolated mountain (reference shallow_water_test.py:164-220)."""
    u0 = 20.0
    h0 = 5960.0
    u1, u2 = solid_body_rotation(geom, 5)
    h_star = (GRAVITY * h0 - (geom.earth_radius * geom.rotation_speed * u0 + 0.5 * u0**2) * geom.sinlat**2) / GRAVITY

    hs0 = 2000.0
    rr = math.pi / 9.0
    lon_m = 1.5 * math.pi
    lat_m = math.pi / 6.0

    def mountain(lon, lat):
        r = np.sqrt(np.minimum(rr**2, (lon - lon_m) ** 2 + (lat - lat_m) ** 2))
        return hs0 * (1.0 - r / rr)

    s = geom.num_solpts
    hsurf = mountain(geom.lon, geom.lat)
    # Interface surface height, per interface (west-face slots of halo-layout
    # elements 1..nx+1 are the nx+1 interfaces).
    hsurf_ix = mountain(geom.lon_itf_i[:, :, 1:, :s], geom.lat_itf_i[:, :, 1:, :s])
    hsurf_jx = mountain(geom.lon_itf_j[:, 1:, :, :s], geom.lat_itf_j[:, 1:, :, :s])

    faces_x = np.concatenate([hsurf_ix[..., :-1, :], hsurf_ix[..., 1:, :]], axis=-1)
    faces_y = np.concatenate([hsurf_jx[..., :-1, :, :], hsurf_jx[..., 1:, :, :]], axis=-1)
    dzdx1 = hsurf @ ops.derivative_x + faces_x @ ops.correction_WE
    dzdx2 = hsurf @ ops.derivative_z + faces_y @ ops.correction_DU

    topo = Topography(hsurf=hsurf, hsurf_itf_x1=hsurf_ix, hsurf_itf_x2=hsurf_jx, dzdx1=dzdx1, dzdx2=dzdx2)
    h = h_star - hsurf
    return np.stack([h, h * u1, h * u2]), topo


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


def _galewsky_u(lat: np.ndarray) -> np.ndarray:
    """Galewsky jet profile u(phi), vectorized (reference :12-26)."""
    u_max = 80.0
    phi0 = math.pi / 7.0
    phi1 = 0.5 * math.pi - phi0
    e_n = math.exp(-4.0 / ((phi1 - phi0) ** 2))
    inside = (lat > phi0) & (lat < phi1)
    safe = np.where(inside, (lat - phi0) * (lat - phi1), -1.0)
    return np.where(inside, u_max / e_n * np.exp(np.where(inside, 1.0 / safe, 0.0)), 0.0)


def case_galewsky(geom, num_quad: int = 512) -> np.ndarray:
    """Barotropic-instability jet (Galewsky et al. 2004), case 8.

    The balance integral h(phi) = h0 - (1/g) * int_{-pi/2}^{phi} (2 a O sin x
    + u'(x) tan x) u'(x) dx is evaluated with fixed-order Gauss-Legendre
    quadrature per grid point (vectorized) instead of the reference's
    per-point adaptive loop (shallow_water_test.py:295-322) — same integral,
    spectral accuracy.
    """
    h0 = 10158.18617045463179
    h_hat = 120.0
    phi2 = math.pi / 4.0
    alpha = 1.0 / 3.0
    beta = 1.0 / 15.0

    lat = geom.lat
    lon = geom.lon
    a = geom.earth_radius
    O = geom.rotation_speed

    # Gauss-Legendre nodes on [-1, 1], mapped per point to [-pi/2, lat].
    # Evaluated in chunks over the flattened grid: the dense (npts, 512)
    # quad tensor is ~5 GB of f64 per intermediate at galewsky's canonical
    # 1.2M-point grid (nel=64, s=7) and was thrashing host memory.
    # The integral depends on the latitude alone, and the cube's panels and
    # their mirror lines repeat latitudes (~4.6 points a latitude on the
    # unrotated grid), so it is evaluated once a distinct value.
    nodes, weights = np.polynomial.legendre.leggauss(num_quad)
    lo = -0.5 * math.pi
    half_len = 0.5 * (lat - lo)  # (6, ny, nx, s^2)
    hl_flat, where = np.unique(half_len, return_inverse=True)
    integral = np.empty_like(hl_flat)
    chunk = 1 << 16
    for i in range(0, hl_flat.size, chunk):
        hl = hl_flat[i : i + chunk, None]
        x = lo + hl * (nodes + 1.0)  # (chunk, num_quad)
        du = _galewsky_u(x)
        integrand = (2.0 * a * O * np.sin(x) + du * np.tan(x)) * du
        integral[i : i + chunk] = integrand @ weights
    integral = integral[where.reshape(half_len.shape)] * half_len

    h = h0 - integral / GRAVITY
    # Perturbation that triggers the instability. The reference evaluates
    # exp(-(lon/alpha)^2) with lon in [0, 2pi); points with lon near 2pi get
    # a negligible but nonzero contribution — keep identical convention.
    h = h + h_hat * np.cos(lat) * np.exp(-((lon / alpha) ** 2)) * np.exp(-(((phi2 - lat) / beta) ** 2))

    u = _galewsky_u(lat)
    v = np.zeros_like(u)
    u1, u2 = geom.wind2contra(u, v)
    return np.stack([h, h * u1, h * u2])


def case_unsteady_zonal(geom, ops) -> Tuple[np.ndarray, Topography]:
    """Laeuter et al. (2005) unsteady zonal balanced flow, case 10
    (reference shallow_water_test.py:400-455)."""
    u0 = 2.0 * math.pi * geom.earth_radius / (12.0 * DAY_IN_SECS)
    k1 = 133681.0
    k2 = 10.0
    a, O = geom.earth_radius, geom.rotation_speed

    u = u0 * np.cos(geom.lat)
    v = np.zeros_like(u)

    h = (
        -0.5 * (u0 * np.sin(geom.lat) + a * O * np.sin(geom.lat)) ** 2
        + 0.5 * (a * O * np.sin(geom.lat)) ** 2
        + k1
    )
    hs = 0.5 * (a * O * np.sin(geom.lat)) ** 2 + k2
    h = (h - hs) / GRAVITY
    hsurf = hs / GRAVITY

    s = geom.num_solpts

    def surf(lat):
        return (0.5 * (a * O * np.sin(lat)) ** 2 + k2) / GRAVITY

    hsurf_ix = surf(geom.lat_itf_i[:, :, 1:, :s])
    hsurf_jx = surf(geom.lat_itf_j[:, 1:, :, :s])
    faces_x = np.concatenate([hsurf_ix[..., :-1, :], hsurf_ix[..., 1:, :]], axis=-1)
    faces_y = np.concatenate([hsurf_jx[..., :-1, :, :], hsurf_jx[..., 1:, :, :]], axis=-1)
    dzdx1 = hsurf @ ops.derivative_x + faces_x @ ops.correction_WE
    dzdx2 = hsurf @ ops.derivative_z + faces_y @ ops.correction_DU

    topo = Topography(hsurf=hsurf, hsurf_itf_x1=hsurf_ix, hsurf_itf_x2=hsurf_jx, dzdx1=dzdx1, dzdx2=dzdx2)
    u1, u2 = geom.wind2contra(u, v)
    return np.stack([h, h * u1, h * u2]), topo


def circular_vortex(geom) -> np.ndarray:
    """Case 0: deformational circular vortex (Nair & Machenhauer 2002;
    reference shallow_water_test.py:42-101). Q = [h, h*u1, h*u2] with the
    prescribed rotational wind field."""
    lon_c = math.pi - 0.8
    lat_c = math.pi / 4.8

    h, omega_field = height_vortex(geom, 0.0)
    u = geom.earth_radius * omega_field * (
        math.sin(lat_c) * geom.coslat - math.cos(lat_c) * np.cos(geom.lon - lon_c) * geom.sinlat
    )
    v = geom.earth_radius * omega_field * math.cos(lat_c) * np.sin(geom.lon - lon_c)
    u1, u2 = geom.wind2contra(u, v)
    return np.stack([h, h * u1, h * u2])


def height_vortex(geom, t: float):
    """Analytic vortex height at time t; returns (h, Omega angular speed)."""
    lon_c = math.pi - 0.8
    lat_c = math.pi / 4.8
    v0 = 2.0 * math.pi * geom.earth_radius / (12.0 * DAY_IN_SECS)
    rho0 = 3.0
    gamma = 5.0

    lon_r = np.arctan2(
        geom.coslat * np.sin(geom.lon - lon_c),
        geom.coslat * math.sin(lat_c) * np.cos(geom.lon - lon_c) - math.cos(lat_c) * geom.sinlat,
    )
    lon_r = np.where(lon_r < 0.0, lon_r + 2.0 * math.pi, lon_r)
    lat_r = np.arcsin(
        np.clip(geom.sinlat * math.sin(lat_c) + geom.coslat * math.cos(lat_c) * np.cos(geom.lon - lon_c), -1, 1)
    )
    rho = rho0 * np.cos(lat_r)
    vt = v0 * 1.5 * math.sqrt(3.0) * np.tanh(rho) / np.cosh(rho) ** 2
    omega_field = np.where(np.abs(rho) > 1e-9, vt / (geom.earth_radius * np.maximum(rho, 1e-300)), 0.0)
    h = 1.0 - np.tanh(rho / gamma * np.sin(lon_r - omega_field * t))
    return h, omega_field


def williamson_case1(geom) -> np.ndarray:
    """Cosine-bell tracer advection (case 1)."""
    u1, u2 = solid_body_rotation(geom, 1)
    h = height_case1(geom, 0.0)
    return np.stack([h, h * u1, h * u2])


def height_case1(geom, t: float) -> np.ndarray:
    """Analytic cosine bell at time t under solid-body rotation."""
    ubar = 2.0 * math.pi / (12.0 * DAY_IN_SECS)
    lon_c = 1.5 * math.pi + ubar * t
    if lon_c > 2.0 * math.pi:
        lon_c -= 2.0 * math.pi
    h0 = 1000.0
    radius = 1.0 / 3.0
    dist = np.arccos(np.clip(geom.coslat * np.cos(geom.lon - lon_c), -1.0, 1.0))
    return 0.5 * h0 * (1.0 + np.cos(math.pi * dist / radius)) * (dist <= radius)


def initial_state(geom, ops, case_number: int, matsuno_wave_type: str = "rossby", matsuno_amp: float = 1e-5):
    """(q, topo) of a shallow-water case: the state Q = [h, h*u1, h*u2] and
    its Topography (cases 5 and 10) or None, as the JAX package's
    ``Simulation._init_sw`` (simulation.py:208-240 there) builds them."""
    from .matsuno import case_matsuno

    topo = None
    if case_number == 0:
        q = circular_vortex(geom)
    elif case_number == 9:
        q = case_matsuno(geom, matsuno_wave_type, matsuno_amp)
    elif case_number == 1:
        q = williamson_case1(geom)
    elif case_number == 2:
        q = williamson_case2(geom)
    elif case_number == 5:
        q, topo = williamson_case5(geom, ops)
    elif case_number == 6:
        q = williamson_case6(geom)
    elif case_number == 8:
        q = case_galewsky(geom)
    elif case_number == 10:
        q, topo = case_unsteady_zonal(geom, ops)
    else:
        raise ValueError(f"Unsupported shallow-water case {case_number}")
    return q, topo
