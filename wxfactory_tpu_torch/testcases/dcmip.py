"""DCMIP test cases for the 3D Euler equations on the cubed sphere (host
numpy, float64).

Counterpart of ``wxfactory_tpu/testcases/dcmip.py`` (reference
init/dcmip.py), same code: 11 and 12 (tracer transport under prescribed
time-dependent winds: the deformational flow of 4 tracers and the
Hadley-like circulation of 1, with the wind functions the step loop
overwrites the momenta from; ``testcases/winds.py`` evaluates them on the
card), 20 (steady state at rest over a mountain range), 21 and 22 (Schar
mountain waves without and with shear, under a Rayleigh sponge), 31
(non-hydrostatic gravity wave on a reduced planet) and 77 (acoustic wave).
Each builds the global state ``Q[5, 6, nk, ny, nx, s^3]`` (rho, rho*u1,
rho*u2, rho*w, rho*theta), 11 and 12 with their tracer rows rho*q_k after
those (9 and 6 rows). The
reduced-planet configuration is the geometry's
(``make_cubed_sphere_3d(planet_scaling_factor=..., planet_is_rotating=...)``,
``dcmip_planet_params``); the terrain cases return the geometry with their
topography applied, and 21/22 their sponge as host planes
(``RayleighDamping``), not as a closure.
"""

import math
from typing import Callable, Optional, Tuple

import numpy as np

from ..common.constants import CPD, GRAVITY, P0, RD
from ..geometry.cubed_sphere_3d import apply_topography
from ..models.euler_cubesphere import RayleighDamping


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


def dcmip_T11_update_winds(geom, time: float = 0.0):
    """Time-dependent deformational-flow winds of DCMIP case 11
    (reference init/dcmip.py:31-98). Returns (u1, u2, w)."""
    tau = 12.0 * 86400.0
    u0 = 2.0 * math.pi * geom.earth_radius / tau
    k0 = 10.0 * geom.earth_radius / tau
    omega0 = 23000.0 * math.pi / tau
    T0 = 300.0
    H = RD * T0 / GRAVITY

    p = P0 * np.exp(-geom.height / H)
    ptop = P0 * math.exp(-12000.0 / H)
    lonp = geom.lon - 2.0 * math.pi * time / tau
    bs = 0.2
    s = (
        1.0
        + math.exp((ptop - P0) / (bs * ptop))
        - np.exp((p - P0) / (bs * ptop))
        - np.exp((ptop - p) / (bs * ptop))
    )

    ud = (
        (omega0 * geom.earth_radius)
        / (bs * ptop)
        * np.cos(lonp)
        * np.cos(geom.lat) ** 2
        * math.cos(2.0 * math.pi * time / tau)
        * (-np.exp((p - P0) / (bs * ptop)) + np.exp((ptop - p) / (bs * ptop)))
    )
    u = (
        k0 * np.sin(lonp) ** 2 * np.sin(2.0 * geom.lat) * math.cos(math.pi * time / tau)
        + u0 * np.cos(geom.lat)
        + ud
    )
    v = k0 * np.sin(2.0 * lonp) * np.cos(geom.lat) * math.cos(math.pi * time / tau)
    w = (
        -(RD * T0 / (GRAVITY * p))
        * omega0
        * np.sin(lonp)
        * np.cos(geom.lat)
        * math.cos(2.0 * math.pi * time / tau)
        * s
    )
    u1, u2 = geom.wind2contra_2d(u, v)
    return u1, u2, w


def dcmip_T12_update_winds(geom, time: float = 0.0):
    """Time-dependent Hadley-cell winds of DCMIP case 12
    (reference init/dcmip.py:107-167)."""
    tau = 86400.0
    u0 = 40.0
    w0 = 0.15
    T0 = 300.0
    H = RD * T0 / GRAVITY
    K = 5.0

    p = P0 * np.exp(-geom.height / H)
    rho = p / (RD * T0)
    rho0 = P0 / (RD * T0)

    u = u0 * np.cos(geom.lat)
    v = (
        -(rho0 / rho)
        * (geom.earth_radius * w0 * math.pi)
        / (K * geom.ztop)
        * np.cos(geom.lat)
        * np.sin(K * geom.lat)
        * np.cos(math.pi * geom.height / geom.ztop)
        * math.cos(math.pi * time / tau)
    )
    w = (
        (rho0 / rho)
        * (w0 / K)
        * (-2.0 * np.sin(K * geom.lat) * np.sin(geom.lat) + K * np.cos(geom.lat) * np.cos(K * geom.lat))
        * np.sin(math.pi * geom.height / geom.ztop)
        * math.cos(math.pi * time / tau)
    )
    u1, u2 = geom.wind2contra_2d(u, v)
    return u1, u2, w


def dcmip_advection_deformation(geom) -> np.ndarray:
    """DCMIP case 11: 3D deformational advection of 4 tracers
    (reference init/dcmip.py:169-274). Q has 9 variables."""
    T0 = 300.0
    H = RD * T0 / GRAVITY
    RR = 0.5
    ZZ = 1000.0
    z0 = 5000.0
    lambda0 = 5.0 * math.pi / 6.0
    lambda1 = 7.0 * math.pi / 6.0

    p = P0 * np.exp(-geom.height / H)
    u1, u2, w = dcmip_T11_update_winds(geom, 0.0)
    rho = p / (RD * T0)
    theta = T0 * (P0 / p) ** (RD / CPD)

    lat, lon, z = geom.lat, geom.lon, geom.height
    r1 = np.arccos(np.clip(np.cos(lat) * np.cos(lon - lambda0), -1, 1))
    r2 = np.arccos(np.clip(np.cos(lat) * np.cos(lon - lambda1), -1, 1))
    d1 = np.minimum(1.0, (r1 / RR) ** 2 + ((z - z0) / ZZ) ** 2)
    d2 = np.minimum(1.0, (r2 / RR) ** 2 + ((z - z0) / ZZ) ** 2)

    q1 = 0.5 * (1.0 + np.cos(math.pi * d1)) + 0.5 * (1.0 + np.cos(math.pi * d2))
    q2 = 0.9 - 0.8 * q1**2
    q3 = np.where((d1 <= RR) | (d2 <= RR), 1.0, 0.1)
    q3 = np.where((z > z0) & (np.abs(lat) < 0.125), 0.1, q3)
    q4 = 1.0 - 0.3 * (q1 + q2 + q3)

    base = _assemble(rho, u1, u2, w, theta)
    tracers = np.stack([rho * q1, rho * q2, rho * q3, rho * q4])
    return np.concatenate([base, tracers])


def dcmip_advection_hadley(geom) -> np.ndarray:
    """DCMIP case 12: Hadley-like tracer transport
    (reference init/dcmip.py:275-337). Q has 6 variables."""
    T0 = 300.0
    H = RD * T0 / GRAVITY
    z1, z2 = 2000.0, 5000.0
    z0 = 0.5 * (z1 + z2)

    p = P0 * np.exp(-geom.height / H)
    u1, u2, w = dcmip_T12_update_winds(geom, 0.0)
    rho = p / (RD * T0)
    theta = T0 * (P0 / p) ** (RD / CPD)

    z = geom.height
    q1 = np.where(
        (z > z1) & (z < z2), 0.5 * (1.0 + np.cos(2.0 * math.pi * (z - z0) / (z2 - z1))), 0.0
    )
    base = _assemble(rho, u1, u2, w, theta)
    return np.concatenate([base, (rho * q1)[None]])


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


def dcmip_steady_state_mountain(geom):
    """DCMIP case 20: steady state at rest over a Schar-profile mountain
    range (reference init/dcmip.py:447-550). Returns (Q, geom_with_topo) —
    build the metric from the returned geometry.

    Geometry: normal planet, non-rotating, ztop = 12000 in the DCMIP spec.
    """
    T0 = 300.0
    gamma = 0.0065  # lapse rate (K/m)
    lambdam = 1.5 * math.pi
    phim = 0.0
    h0 = 2000.0
    Rm = 0.75 * math.pi
    zetam = math.pi / 16.0
    exponent = GRAVITY / (RD * gamma)

    def zbot_fn(lon, lat):
        r = np.arccos(
            np.clip(math.sin(phim) * np.sin(lat) + math.cos(phim) * np.cos(lat) * np.cos(lon - lambdam), -1, 1)
        )
        z = 0.5 * h0 * (1.0 + np.cos(math.pi * r / Rm)) * np.cos(math.pi * r / zetam) ** 2
        return np.where(r < Rm, z, 0.0)

    geom = apply_topography(geom, zbot_fn)

    z = geom.height
    p = P0 * (1.0 - gamma / T0 * z) ** exponent
    t = T0 - gamma * z
    rho = p / (RD * t)
    theta = t * (P0 / p) ** (RD / CPD)
    zero = np.zeros_like(rho)
    u1, u2 = geom.wind2contra_2d(zero, zero)
    return _assemble(rho, u1, u2, zero, theta), geom


def _schar_topography(geom):
    """Schar-type mountain for cases 21/22 (reference init/dcmip.py:576-594)."""
    lambdam = 0.25 * math.pi
    phim = 0.0
    h0 = 250.0
    Dm = 5000.0
    Dxi = 4000.0

    def zbot_fn(lon, lat):
        r = geom.earth_radius * np.arccos(
            np.clip(math.sin(phim) * np.sin(lat) + math.cos(phim) * np.cos(lat) * np.cos(lon - lambdam), -1, 1)
        )
        return h0 * np.exp(-(r**2) / Dm**2) * np.cos(math.pi * r / Dxi) ** 2

    return apply_topography(geom, zbot_fn)


def dcmip_schar_waves(geom, metric_builder: Callable, shear: bool = False):
    """DCMIP cases 21 (no shear) / 22 (shear): mountain waves over a
    Schar-type mountain on a small planet (reference init/dcmip.py:551-676).

    ``metric_builder(geom)`` builds the 3D metric for the terrain geometry
    (needed for the 3D wind conversion). Returns (Q, geom, metric).
    Geometry must use planet_scaling_factor=500, non-rotating; ztop=30000.
    """
    T0 = 300.0
    Ueq = 20.0
    Peq = 100000.0
    Cs = 2.5e-4 if shear else 0.0

    geom = _schar_topography(geom)
    metric = metric_builder(geom)

    lat = geom.lat
    z = geom.height
    T = T0 * (1.0 - Cs * Ueq**2 / GRAVITY * np.sin(lat) ** 2)
    p = Peq * np.exp(-(Ueq**2) / (2.0 * RD * T0) * np.sin(lat) ** 2 - GRAVITY * z / (RD * T))
    u = Ueq * np.cos(lat) * np.sqrt(2.0 * T0 / T * Cs * z + T / T0)
    v = np.zeros_like(u)
    w = np.zeros_like(u)

    u1, u2, u3 = geom.wind2contra_3d(u, v, w, metric)
    rho = p / (RD * T)
    theta = T * (P0 / p) ** (RD / CPD)
    # The reference stores the contravariant u3 in the w slot for these
    # cases (initialize_euler + dcmip.py:665-676 there).
    return _assemble(rho, u1, u2, u3, theta), geom, metric


def make_schar_damping(geom, metric, shear: bool) -> RayleighDamping:
    """Rayleigh damping toward the case 21/22 reference wind above Zh
    (reference init/dcmip.py:676-761): the sponge's mask (1/s) and the
    reference contravariant winds, host float64 planes. The JAX package
    returns them inside a closure ``extra_forcing(rho, u1, u2, w) = rho *
    mask * (u - u_ref)``; the operator here takes the planes
    (``models.euler_cubesphere.Euler3DRHS(damping=...)``)."""
    T0 = 300.0
    Ueq = 20.0
    Zh = 20000.0
    tau0 = 25.0
    Cs = 2.5e-4 if shear else 0.0

    lat = geom.lat
    z = geom.height
    mask = np.where(z > Zh, np.sin(0.5 * math.pi * (z - Zh) / (geom.ztop - Zh)) ** 2, 0.0) / tau0

    Tref = T0 * (1.0 - Cs * Ueq**2 / GRAVITY * np.sin(lat) ** 2)
    uref = Ueq * np.cos(lat) * np.sqrt(2.0 * T0 / Tref * Cs * z + Tref / T0)
    u1ref, u2ref, u3ref = geom.wind2contra_3d(uref, np.zeros_like(uref), np.zeros_like(uref), metric)
    return RayleighDamping(mask=mask, u1ref=u1ref, u2ref=u2ref, u3ref=u3ref)


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


def initial_state_3d(geom, case_number: int, metric_builder: Optional[Callable] = None):
    """Initial 3D Euler state of a DCMIP case (11, 12, 20, 21, 22, 31, 77):
    ``(Q, geom, metric, damping)``. ``geom`` is the geometry the case runs
    on (20, 21 and 22 apply their topography to the one given), ``metric``
    ``metric_builder(geom)`` on it (None without a builder; 21 and 22 need
    one, for their 3D wind conversion), ``damping`` the Rayleigh sponge of
    21 and 22 (``RayleighDamping``, else None). Q of 11 and 12 carries
    their 4 and 1 tracer rows after the 5 dynamical ones."""
    if case_number == 11:
        q = dcmip_advection_deformation(geom)
    elif case_number == 12:
        q = dcmip_advection_hadley(geom)
    elif case_number == 20:
        q, geom = dcmip_steady_state_mountain(geom)
    elif case_number in (21, 22):
        if metric_builder is None:
            raise ValueError(f"DCMIP case {case_number} needs a metric_builder (its 3D wind conversion)")
        shear = case_number == 22
        q, geom, metric = dcmip_schar_waves(geom, metric_builder, shear=shear)
        return q, geom, metric, make_schar_damping(geom, metric, shear)
    elif case_number == 31:
        q = dcmip_gravity_wave(geom)
    elif case_number == 77:
        q = acoustic_wave(geom)
    else:
        raise NotImplementedError(
            f"3D Euler case {case_number} is not ported yet: unknown case (the port runs DCMIP 11, 12, 20, 21, 22, "
            "31 and 77)")
    return q, geom, (None if metric_builder is None else metric_builder(geom)), None
