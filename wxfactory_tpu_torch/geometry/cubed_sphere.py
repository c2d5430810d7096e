"""Rotated equiangular cubed-sphere geometry (2D, shallow atmosphere).

Same code as ``wxfactory_tpu/geometry/cubed_sphere.py`` (reference
geometry/cubed_sphere_2d.py, CubedSphere2D) — equiangular panel coordinates, gnomonic projection,
per-panel grid-rotation parameters, lat/lon + Cartesian coordinates at
solution points and element interfaces, and wind <-> contravariant
conversions.

Instead of one object per MPI rank/tile, the geometry is GLOBAL — every
array carries a leading panel axis of length 6, shaped ``(6, nel, nel, s^2)``
to match the state layout ``Q[nvar, 6, ny, nx, s^2]``. All construction
happens on host in float64 numpy at setup time.

Panel layout (reference cubed_sphere_2d.py:41-54): panels 3-0-1-2 run
west->east along the equator, panel 4 holds the north pole, panel 5 the
south pole. Each panel has local equiangular coordinates
(x1, x2) in [-pi/4, pi/4]^2 and gnomonic coordinates X = tan(x1),
Y = tan(x2).
"""

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..ops.quadrature import gauss_legendre

EARTH_RADIUS = 6371220.0  # mean Earth radius (m)
ROTATION_SPEED = 7.29212e-5  # Earth angular speed (rad/s)


def panel_rotation_params(lambda0: float, phi0: float, alpha0: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-panel rotation parameters (lon_p, lat_p, angle_p) of the rotated
    cubed sphere, one triple per panel (reference cubed_sphere_2d.py:217-268).

    (lon_p, lat_p) is the physical lon/lat of the panel center and angle_p
    the rotation of the panel's central meridian relative to true north.
    """
    c1, c2, c3 = math.cos(lambda0), math.cos(phi0), math.cos(alpha0)
    s1, s2, s3 = math.sin(lambda0), math.sin(phi0), math.sin(alpha0)

    lon_p = np.empty(6)
    lat_p = np.empty(6)
    angle_p = np.empty(6)

    lon_p[0], lat_p[0], angle_p[0] = lambda0, phi0, alpha0
    lon_p[1] = math.atan2(s1 * s2 * s3 + c1 * c3, c1 * s2 * s3 - s1 * c3)
    lat_p[1] = -math.asin(c2 * s3)
    angle_p[1] = math.atan2(s2, c2 * c3)
    lon_p[2] = math.atan2(-s1, -c1)
    lat_p[2] = -phi0
    angle_p[2] = -math.atan2(s3, c3)
    lon_p[3] = math.atan2(-s1 * s2 * s3 - c1 * c3, -c1 * s2 * s3 + s1 * c3)
    lat_p[3] = math.asin(c2 * s3)
    angle_p[3] = -math.atan2(s2, c2 * c3)

    if abs(phi0) < 1e-13 and abs(alpha0) < 1e-13:
        lon_p[4], lat_p[4], angle_p[4] = 0.0, 0.5 * math.pi, -lambda0
        lon_p[5], lat_p[5], angle_p[5] = 0.0, -0.5 * math.pi, lambda0
    else:
        lon_p[4] = math.atan2(-s1 * s2 * c3 + c1 * s3, -c1 * s2 * c3 - s1 * s3)
        lat_p[4] = math.asin(c2 * c3)
        angle_p[4] = math.atan2(c2 * s3, -s2)
        lon_p[5] = math.atan2(s1 * s2 * c3 - c1 * s3, c1 * s2 * c3 + s1 * s3)
        lat_p[5] = -math.asin(c2 * c3)
        angle_p[5] = math.atan2(c2 * s3, s2)

    return lon_p, lat_p, angle_p


def gnomonic_to_cartesian(X, Y, lon_p: float, lat_p: float, angle_p: float, radius: float = 1.0):
    """Invert the gnomonic projection of one panel: (X, Y) -> physical
    Cartesian (x, y, z) on the sphere (reference cubed_sphere_2d.py:379-424)."""
    cl, sl = math.cos(lon_p), math.sin(lon_p)
    cp, sp = math.cos(lat_p), math.sin(lat_p)
    ca, sa = math.cos(angle_p), math.sin(angle_p)

    delt = np.sqrt(1.0 + X**2 + Y**2)
    r = radius / delt
    x = r * (cl * cp + X * (cl * sp * sa - sl * ca) - Y * (cl * sp * ca + sl * sa))
    y = r * (sl * cp + X * (sl * sp * sa + cl * ca) - Y * (sl * sp * ca - cl * sa))
    z = r * (sp - X * cp * sa + Y * cp * ca)
    return x, y, z


def cartesian_to_lonlat(x, y, z):
    """Physical Cartesian -> (lon in [0, 2pi), lat)."""
    lon = np.arctan2(y, x)
    lon = np.where(lon < 0.0, lon + 2.0 * math.pi, lon)
    lat = np.arctan2(z, np.hypot(x, y))
    return lon, lat


def wind_jacobian(X, Y, lat_p: float, angle_p: float):
    """Jacobian of the panel coordinate map: entries (dx1/dlon, dx1/dlat,
    dx2/dlon, dx2/dlat) at gnomonic points (X, Y), in radians (no
    reference-element scaling). Closed forms from the rotated gnomonic
    projection (reference cubed_sphere_2d.py:594-620).

    Used both by wind2contra and to build the exact panel-edge vector
    conversion matrices of the halo exchange (parallel/topology.py), which
    replaces the reference's hand-written per-edge lambda tables
    (process_topology.py:138-214).
    """
    cp, sp = math.cos(lat_p), math.sin(lat_p)
    ca, sa = math.cos(angle_p), math.sin(angle_p)
    delta2 = 1.0 + X**2 + Y**2

    denom = np.sqrt((cp + X * sp * sa - Y * sp * ca) ** 2 + (X * ca + Y * sa) ** 2)

    dx1dlon = cp * ca + (X * Y * cp * sa - Y * sp) / (1.0 + X**2)
    dx2dlon = (X * Y * cp * ca + X * sp) / (1.0 + Y**2) + cp * sa
    dx1dlat = -delta2 * ((cp * sa + X * sp) / (1.0 + X**2)) / denom
    dx2dlat = delta2 * ((cp * ca - Y * sp) / (1.0 + Y**2)) / denom
    return dx1dlon, dx1dlat, dx2dlon, dx2dlat


def inverse_wind_jacobian(X, Y, lat_p: float, angle_p: float):
    """Entries (dlon/dx1, dlon/dx2, dlat/dx1, dlat/dx2) — inverse of
    wind_jacobian (reference cubed_sphere_2d.py:650-690)."""
    cp, sp = math.cos(lat_p), math.sin(lat_p)
    ca, sa = math.cos(angle_p), math.sin(angle_p)
    delta2 = 1.0 + X**2 + Y**2

    denom2 = (cp + X * sp * sa - Y * sp * ca) ** 2 + (X * ca + Y * sa) ** 2
    denom = np.sqrt(denom2)

    dlondx1 = (cp * ca - Y * sp) * (1.0 + X**2) / denom2
    dlondx2 = (cp * sa + X * sp) * (1.0 + Y**2) / denom2
    dlatdx1 = -((X * Y * cp * ca + X * sp + (1.0 + Y**2) * cp * sa) * (1.0 + X**2)) / (delta2 * denom)
    dlatdx2 = ((1.0 + X**2) * cp * ca + X * Y * cp * sa - Y * sp) * (1.0 + Y**2) / (delta2 * denom)
    return dlondx1, dlondx2, dlatdx1, dlatdx2


@dataclass(frozen=True)
class CubedSphere2D:
    """Global cubed-sphere grid: all six panels, element-blocked layout.

    Interface arrays use the halo-element layout of the reference
    (cubed_sphere_2d.py:164-165): ``itf_i`` has shape (6, nel, nel+2, 2s)
    where the element axis includes one halo element on each side and the
    trailing axis packs [west face (s) | east face (s)]; ``itf_j`` is
    (6, nel+2, nel, 2s) with [south | north].
    """

    num_solpts: int
    num_elements: int  # elements per panel edge (whole panel)
    lambda0: float
    phi0: float
    alpha0: float
    earth_radius: float
    rotation_speed: float
    delta_x1: float
    delta_x2: float

    lon_p: np.ndarray  # (6,)
    lat_p: np.ndarray
    angle_p: np.ndarray

    x1: np.ndarray  # (nel*s,) panel-local equiangular solution-point coords
    x1_itf: np.ndarray  # (nel+1,) element-interface coords

    X: np.ndarray  # (6, nel, nel, s^2) gnomonic
    Y: np.ndarray
    delta2: np.ndarray
    delta: np.ndarray
    lon: np.ndarray
    lat: np.ndarray
    coslon: np.ndarray
    sinlon: np.ndarray
    coslat: np.ndarray
    sinlat: np.ndarray

    X_itf_i: np.ndarray  # (6, nel, nel+2, 2s)
    Y_itf_i: np.ndarray
    delta2_itf_i: np.ndarray
    delta_itf_i: np.ndarray
    lon_itf_i: np.ndarray
    lat_itf_i: np.ndarray

    X_itf_j: np.ndarray  # (6, nel+2, nel, 2s)
    Y_itf_j: np.ndarray
    delta2_itf_j: np.ndarray
    delta_itf_j: np.ndarray
    lon_itf_j: np.ndarray
    lat_itf_j: np.ndarray

    boundary_sn: np.ndarray  # (nel*s,) X along the south/north panel edges
    boundary_we: np.ndarray  # (nel*s,) Y along the west/east panel edges

    @property
    def grid_shape(self) -> Tuple[int, int, int, int]:
        return (6, self.num_elements, self.num_elements, self.num_solpts**2)

    def _bcast(self, a: np.ndarray, ndim: int) -> np.ndarray:
        """Reshape a per-panel scalar (6,) for broadcasting against grids."""
        return a.reshape((6,) + (1,) * (ndim - 1))

    def wind2contra(self, u, v, X=None, Y=None):
        """Zonal/meridional winds (m/s) -> contravariant components in
        reference-element coordinates, on the solution-point grid (or on
        custom gnomonic points X, Y of matching panel-major shape)."""
        if X is None:
            X, Y = self.X, self.Y
            coslat = self.coslat
        else:
            lon, lat = self.panel_lonlat(X, Y)
            coslat = np.cos(lat)
        nd = X.ndim
        lat_p = self._bcast(self.lat_p, nd)
        angle_p = self._bcast(self.angle_p, nd)

        lambda_dot = u / (self.earth_radius * coslat)
        phi_dot = v / self.earth_radius

        dx1dlon, dx1dlat, dx2dlon, dx2dlat = _wind_jacobian_vec(X, Y, lat_p, angle_p)
        u1 = (dx1dlon * lambda_dot + dx1dlat * phi_dot) * 2.0 / self.delta_x1
        u2 = (dx2dlon * lambda_dot + dx2dlat * phi_dot) * 2.0 / self.delta_x2
        return u1, u2

    def contra2wind(self, u1, u2):
        """Contravariant (reference-element) components -> zonal/meridional
        winds in m/s on the solution-point grid."""
        nd = self.X.ndim
        lat_p = self._bcast(self.lat_p, nd)
        angle_p = self._bcast(self.angle_p, nd)

        u1_r = u1 * self.delta_x1 / 2.0
        u2_r = u2 * self.delta_x2 / 2.0
        dlondx1, dlondx2, dlatdx1, dlatdx2 = _inverse_wind_jacobian_vec(self.X, self.Y, lat_p, angle_p)
        u = (dlondx1 * u1_r + dlondx2 * u2_r) * self.coslat * self.earth_radius
        v = (dlatdx1 * u1_r + dlatdx2 * u2_r) * self.earth_radius
        return u, v

    def panel_lonlat(self, X, Y):
        """lon/lat of arbitrary gnomonic points with panel-major leading axis."""
        lon = np.empty_like(X)
        lat = np.empty_like(X)
        for p in range(6):
            c = gnomonic_to_cartesian(X[p], Y[p], self.lon_p[p], self.lat_p[p], self.angle_p[p])
            lon[p], lat[p] = cartesian_to_lonlat(*c)
        return lon, lat

    def to_single_block(self, a: np.ndarray) -> np.ndarray:
        """(..., 6, nel, nel, s^2) -> (..., 6, nel*s, nel*s) plottable blocks."""
        s = self.num_solpts
        nel = self.num_elements
        lead = a.shape[:-3]
        tmp = np.asarray(a).reshape(lead + (nel, nel, s, s))
        tmp = np.swapaxes(tmp, -2, -3)
        return tmp.reshape(lead + (nel * s, nel * s))


def _wind_jacobian_vec(X, Y, lat_p, angle_p):
    """wind_jacobian with per-panel broadcast arrays for lat_p/angle_p."""
    cp, sp = np.cos(lat_p), np.sin(lat_p)
    ca, sa = np.cos(angle_p), np.sin(angle_p)
    delta2 = 1.0 + X**2 + Y**2
    denom = np.sqrt((cp + X * sp * sa - Y * sp * ca) ** 2 + (X * ca + Y * sa) ** 2)
    dx1dlon = cp * ca + (X * Y * cp * sa - Y * sp) / (1.0 + X**2)
    dx2dlon = (X * Y * cp * ca + X * sp) / (1.0 + Y**2) + cp * sa
    dx1dlat = -delta2 * ((cp * sa + X * sp) / (1.0 + X**2)) / denom
    dx2dlat = delta2 * ((cp * ca - Y * sp) / (1.0 + Y**2)) / denom
    return dx1dlon, dx1dlat, dx2dlon, dx2dlat


def _inverse_wind_jacobian_vec(X, Y, lat_p, angle_p):
    cp, sp = np.cos(lat_p), np.sin(lat_p)
    ca, sa = np.cos(angle_p), np.sin(angle_p)
    delta2 = 1.0 + X**2 + Y**2
    denom2 = (cp + X * sp * sa - Y * sp * ca) ** 2 + (X * ca + Y * sa) ** 2
    denom = np.sqrt(denom2)
    dlondx1 = (cp * ca - Y * sp) * (1.0 + X**2) / denom2
    dlondx2 = (cp * sa + X * sp) * (1.0 + Y**2) / denom2
    dlatdx1 = -((X * Y * cp * ca + X * sp + (1.0 + Y**2) * cp * sa) * (1.0 + X**2)) / (delta2 * denom)
    dlatdx2 = ((1.0 + X**2) * cp * ca + X * Y * cp * sa - Y * sp) * (1.0 + Y**2) / (delta2 * denom)
    return dlondx1, dlondx2, dlatdx1, dlatdx2


def make_cubed_sphere_2d(
    num_elements: int,
    num_solpts: int,
    lambda0: float = 0.0,
    phi0: float = 0.0,
    alpha0: float = 0.0,
) -> CubedSphere2D:
    """Build the global 2D cubed-sphere geometry.

    `num_elements` counts elements along one edge of a whole panel (the
    reference's per-tile count times the tiles per panel edge).
    """
    s = num_solpts
    nel = num_elements
    _, pts, _ = gauss_legendre(s)

    delta_x1 = 0.5 * math.pi / nel
    delta_x2 = delta_x1

    # 1D panel-local coordinates of solution points and element interfaces.
    offsets = -0.25 * math.pi + delta_x1 * np.arange(nel)
    ref_pts = delta_x1 * 0.5 * (pts + 1.0)
    x1 = (offsets[:, None] + ref_pts[None, :]).reshape(-1)  # (nel*s,)
    x1_itf = np.linspace(-0.25 * math.pi, 0.25 * math.pi, nel + 1)

    lon_p, lat_p, angle_p = panel_rotation_params(lambda0, phi0, alpha0)

    # --- Solution-point gnomonic grid, element-blocked (nel, nel, s^2).
    tan_x = np.tan(x1).reshape(nel, s)
    # X varies along x1 (fast axis kx), Y along x2 (element row / axis ky).
    X_e = np.broadcast_to(tan_x[None, :, None, :], (nel, nel, s, s)).reshape(nel, nel, s * s)
    Y_e = np.broadcast_to(tan_x[:, None, :, None], (nel, nel, s, s)).reshape(nel, nel, s * s)
    X = np.broadcast_to(X_e, (6,) + X_e.shape).copy()
    Y = np.broadcast_to(Y_e, (6,) + Y_e.shape).copy()

    delta2 = 1.0 + X**2 + Y**2
    delta = np.sqrt(delta2)

    lon = np.empty_like(X)
    lat = np.empty_like(X)
    for p in range(6):
        c = gnomonic_to_cartesian(X[p], Y[p], lon_p[p], lat_p[p], angle_p[p])
        lon[p], lat[p] = cartesian_to_lonlat(*c)

    # --- Interface grids in halo-element layout.
    tan_itf = np.tan(x1_itf)  # (nel+1,)

    def build_itf_i():
        """X/Y at west-east interfaces: (6, nel, nel+2, 2s)."""
        Xi = np.zeros((nel, nel + 2, 2 * s))
        Yi = np.zeros((nel, nel + 2, 2 * s))
        # Interface m (m = 0..nel) lies between halo-elements m and m+1:
        # it is the east face of element m and the west face of element m+1.
        for m in range(nel + 1):
            Xi[:, m, s:] = tan_itf[m]
            Xi[:, m + 1, :s] = tan_itf[m]
            Yi[:, m, s:] = tan_x  # varies along x2 within the element row
            Yi[:, m + 1, :s] = tan_x
        # Outermost faces of the halo elements are unused -> zero.
        Xi[:, 0, :s] = Xi[:, -1, s:] = 0.0
        Yi[:, 0, :s] = Yi[:, -1, s:] = 0.0
        return Xi, Yi

    def build_itf_j():
        """X/Y at south-north interfaces: (6, nel+2, nel, 2s)."""
        Xj = np.zeros((nel + 2, nel, 2 * s))
        Yj = np.zeros((nel + 2, nel, 2 * s))
        for m in range(nel + 1):
            Yj[m, :, s:] = tan_itf[m]
            Yj[m + 1, :, :s] = tan_itf[m]
            Xj[m, :, s:] = tan_x
            Xj[m + 1, :, :s] = tan_x
        Xj[0, :, :s] = Xj[-1, :, s:] = 0.0
        Yj[0, :, :s] = Yj[-1, :, s:] = 0.0
        return Xj, Yj

    Xi1, Yi1 = build_itf_i()
    Xj1, Yj1 = build_itf_j()
    X_itf_i = np.broadcast_to(Xi1, (6,) + Xi1.shape).copy()
    Y_itf_i = np.broadcast_to(Yi1, (6,) + Yi1.shape).copy()
    X_itf_j = np.broadcast_to(Xj1, (6,) + Xj1.shape).copy()
    Y_itf_j = np.broadcast_to(Yj1, (6,) + Yj1.shape).copy()

    delta2_itf_i = 1.0 + X_itf_i**2 + Y_itf_i**2
    delta_itf_i = np.sqrt(delta2_itf_i)
    delta2_itf_j = 1.0 + X_itf_j**2 + Y_itf_j**2
    delta_itf_j = np.sqrt(delta2_itf_j)

    lon_itf_i = np.zeros_like(X_itf_i)
    lat_itf_i = np.zeros_like(X_itf_i)
    lon_itf_j = np.zeros_like(X_itf_j)
    lat_itf_j = np.zeros_like(X_itf_j)
    for p in range(6):
        c = gnomonic_to_cartesian(X_itf_i[p], Y_itf_i[p], lon_p[p], lat_p[p], angle_p[p])
        lon_itf_i[p], lat_itf_i[p] = cartesian_to_lonlat(*c)
        c = gnomonic_to_cartesian(X_itf_j[p], Y_itf_j[p], lon_p[p], lat_p[p], angle_p[p])
        lon_itf_j[p], lat_itf_j[p] = cartesian_to_lonlat(*c)
    # Unused outer halo faces: match the reference's zeroing
    # (cubed_sphere_2d.py:447-450) so array comparisons are clean.
    for a in (lon_itf_i, lat_itf_i):
        a[:, :, 0, :s] = 0.0
        a[:, :, -1, s:] = 0.0
    for a in (lon_itf_j, lat_itf_j):
        a[:, 0, :, :s] = 0.0
        a[:, -1, :, s:] = 0.0

    return CubedSphere2D(
        num_solpts=s,
        num_elements=nel,
        lambda0=lambda0,
        phi0=phi0,
        alpha0=alpha0,
        earth_radius=EARTH_RADIUS,
        rotation_speed=ROTATION_SPEED,
        delta_x1=delta_x1,
        delta_x2=delta_x2,
        lon_p=lon_p,
        lat_p=lat_p,
        angle_p=angle_p,
        x1=x1,
        x1_itf=x1_itf,
        X=X,
        Y=Y,
        delta2=delta2,
        delta=delta,
        lon=lon,
        lat=lat,
        coslon=np.cos(lon),
        sinlon=np.sin(lon),
        coslat=np.cos(lat),
        sinlat=np.sin(lat),
        X_itf_i=X_itf_i,
        Y_itf_i=Y_itf_i,
        delta2_itf_i=delta2_itf_i,
        delta_itf_i=delta_itf_i,
        lon_itf_i=lon_itf_i,
        lat_itf_i=lat_itf_i,
        X_itf_j=X_itf_j,
        Y_itf_j=Y_itf_j,
        delta2_itf_j=delta2_itf_j,
        delta_itf_j=delta_itf_j,
        lon_itf_j=lon_itf_j,
        lat_itf_j=lat_itf_j,
        boundary_sn=np.tan(x1),
        boundary_we=np.tan(x1),
    )
