"""3D rotated cubed-sphere geometry with terrain-following vertical coordinate.

Same code as ``wxfactory_tpu/geometry/cubed_sphere_3d.py`` (reference
geometry/cubed_sphere_3d.py, CubedSphere3D): equiangular horizontal panels, computational eta in [0, 1]
mapped to height by the linear terrain-following (Gal-Chen style) relation
z = zbot + (ztop - zbot) * eta, topography application, lat/lon fields, and
2D/3D wind <-> contravariant conversions.

As in the 2D geometry, arrays are GLOBAL with a leading panel axis, element-blocked "new layout"
``(6, nk, ny, nx, s^3)`` with in-element index (kz*s + ky)*s + kx.
Interface quantities are stored PER INTERFACE (one value each), shapes
``itf_i: (6, nk, ny, nx+1, s^2)`` (face index kz*s + ky),
``itf_j: (6, nk, ny+1, nx, s^2)`` (kz*s + kx),
``itf_k: (6, nk+1, ny, nx, s^2)`` (ky*s + kx) — the reference's
halo-element layout (cubed_sphere_3d.py:192-194) collapses to this since
both faces of an interface share the value.
"""

import math
from dataclasses import dataclass, field, replace
from typing import Callable, Optional, Tuple

import numpy as np

from ..ops.quadrature import gauss_legendre
from .cubed_sphere import (
    EARTH_RADIUS,
    ROTATION_SPEED,
    cartesian_to_lonlat,
    gnomonic_to_cartesian,
    panel_rotation_params,
    _inverse_wind_jacobian_vec,
    _wind_jacobian_vec,
)


@dataclass(frozen=True)
class CubedSphere3D:
    num_solpts: int
    nel_h: int  # elements per panel edge (horizontal)
    nel_v: int  # vertical elements
    ztop: float
    lambda0: float
    phi0: float
    alpha0: float
    earth_radius: float
    rotation_speed: float
    deep: bool

    delta_x1: float
    delta_x2: float
    delta_eta: float

    lon_p: np.ndarray  # (6,)
    lat_p: np.ndarray
    angle_p: np.ndarray

    x1: np.ndarray  # (nel_h*s,) horizontal solution-point angles
    x1_itf: np.ndarray  # (nel_h+1,)
    eta_1d: np.ndarray  # (nel_v*s,)
    eta_itf_1d: np.ndarray  # (nel_v+1,)

    # Interior grids (6, nk, ny, nx, s^3)
    X: np.ndarray
    Y: np.ndarray
    eta: np.ndarray
    height: np.ndarray
    lon: np.ndarray
    lat: np.ndarray
    coslat: np.ndarray
    sinlat: np.ndarray

    # Interface grids, per interface
    X_itf_i: np.ndarray  # (6, nk, ny, nx+1, s^2)
    Y_itf_i: np.ndarray
    eta_itf_i: np.ndarray
    height_itf_i: np.ndarray
    X_itf_j: np.ndarray  # (6, nk, ny+1, nx, s^2)
    Y_itf_j: np.ndarray
    eta_itf_j: np.ndarray
    height_itf_j: np.ndarray
    X_itf_k: np.ndarray  # (6, nk+1, ny, nx, s^2)
    Y_itf_k: np.ndarray
    eta_itf_k: np.ndarray
    height_itf_k: np.ndarray

    # Floor (2D) fields for topography
    zbot: np.ndarray  # (6, ny, nx, s^2)
    zbot_itf_i: np.ndarray  # (6, ny, nx+1, s)
    zbot_itf_j: np.ndarray  # (6, ny+1, nx, s)

    # lat/lon at the floor interfaces (for building topography there)
    lon_itf_i_floor: np.ndarray = field(default=None, repr=False)  # (6, ny, nx+1, s)
    lat_itf_i_floor: np.ndarray = field(default=None, repr=False)
    lon_itf_j_floor: np.ndarray = field(default=None, repr=False)  # (6, ny+1, nx, s)
    lat_itf_j_floor: np.ndarray = field(default=None, repr=False)

    @property
    def grid_shape(self) -> Tuple[int, ...]:
        return (6, self.nel_v, self.nel_h, self.nel_h, self.num_solpts**3)

    def _bcast(self, a: np.ndarray, ndim: int) -> np.ndarray:
        return a.reshape((6,) + (1,) * (ndim - 1))

    def wind2contra_2d(self, u, v, X=None, Y=None, coslat=None, height=None):
        """Zonal/meridional winds -> horizontal contravariant components
        (reference winds.py:11-86), on the interior grid by default."""
        if X is None:
            X, Y, coslat, height = self.X, self.Y, self.coslat, self.height
        nd = X.ndim
        lat_p = self._bcast(self.lat_p, nd)
        angle_p = self._bcast(self.angle_p, nd)

        radius = self.earth_radius + height if self.deep else self.earth_radius
        lambda_dot = u / (radius * coslat)
        phi_dot = v / radius

        dx1dlon, dx1dlat, dx2dlon, dx2dlat = _wind_jacobian_vec(X, Y, lat_p, angle_p)
        u1 = (dx1dlon * lambda_dot + dx1dlat * phi_dot) * 2.0 / self.delta_x1
        u2 = (dx2dlon * lambda_dot + dx2dlat * phi_dot) * 2.0 / self.delta_x2
        return u1, u2

    def contra2wind_2d(self, u1, u2):
        nd = self.X.ndim
        lat_p = self._bcast(self.lat_p, nd)
        angle_p = self._bcast(self.angle_p, nd)
        u1_r = u1 * self.delta_x1 / 2.0
        u2_r = u2 * self.delta_x2 / 2.0
        dlondx1, dlondx2, dlatdx1, dlatdx2 = _inverse_wind_jacobian_vec(self.X, self.Y, lat_p, angle_p)
        radius = self.earth_radius + self.height if self.deep else self.earth_radius
        u = (dlondx1 * u1_r + dlondx2 * u2_r) * self.coslat * radius
        v = (dlatdx1 * u1_r + dlatdx2 * u2_r) * radius
        return u, v

    def wind2contra_3d(self, u, v, w, metric):
        """(u, v, w) m/s -> contravariant (u1, u2, u3) on the terrain-following
        grid (reference winds.py:88-133)."""
        u1, u2 = self.wind2contra_2d(u, v)
        u3_cov = w / metric.inv_dzdeta
        u1 = u1 + metric.h_contra[0, 2] * u3_cov
        u2 = u2 + metric.h_contra[1, 2] * u3_cov
        u3 = metric.h_contra[2, 2] * u3_cov
        return u1, u2, u3

    def contra2wind_3d(self, u1, u2, u3, metric):
        u, v = self.contra2wind_2d(u1, u2)
        u3_cov = u1 * metric.h_cov[2, 0] + u2 * metric.h_cov[2, 1] + u3 * metric.h_cov[2, 2]
        w = u3_cov * metric.inv_dzdeta
        return u, v, w


def _floor_to_bulk(a_floor: np.ndarray, nel_v: int, s: int) -> np.ndarray:
    """(..., ny, nx, s^2) floor field -> (..., nk, ny, nx, s^3) bulk field,
    constant along the vertical (kz) index."""
    lead = a_floor.shape[:-3]
    ny, nx = a_floor.shape[-3], a_floor.shape[-2]
    out = np.broadcast_to(
        a_floor[..., None, :, :, None, :], lead + (nel_v, ny, nx, s, s * s)
    )
    return out.reshape(lead + (nel_v, ny, nx, s**3)).copy()


def make_cubed_sphere_3d(
    nel_h: int,
    nel_v: int,
    num_solpts: int,
    ztop: float,
    lambda0: float = 0.0,
    phi0: float = 0.0,
    alpha0: float = 0.0,
    deep: bool = False,
    planet_scaling_factor: float = 1.0,
    planet_is_rotating: bool = True,
) -> CubedSphere3D:
    """Build the global 3D cubed-sphere geometry over a smooth sphere
    (zbot = 0). Use apply_topography() afterwards for terrain.

    `planet_scaling_factor` / `planet_is_rotating` implement the DCMIP
    reduced-planet configurations (reference cubed_sphere_3d.py:408-432:
    case 31 -> scale 125 non-rotating, 20 -> non-rotating,
    21/22 -> scale 500 non-rotating)."""
    s = num_solpts
    _, pts, _ = gauss_legendre(s)

    delta_x1 = 0.5 * math.pi / nel_h
    delta_eta = 1.0 / nel_v

    offsets = -0.25 * math.pi + delta_x1 * np.arange(nel_h)
    x1 = (offsets[:, None] + delta_x1 * 0.5 * (pts[None, :] + 1.0)).reshape(-1)
    x1_itf = np.linspace(-0.25 * math.pi, 0.25 * math.pi, nel_h + 1)

    eta_off = delta_eta * np.arange(nel_v)
    eta_1d = (eta_off[:, None] + delta_eta * 0.5 * (pts[None, :] + 1.0)).reshape(-1)
    eta_itf_1d = np.linspace(0.0, 1.0, nel_v + 1)

    lon_p, lat_p, angle_p = panel_rotation_params(lambda0, phi0, alpha0)

    tan_x = np.tan(x1).reshape(nel_h, s)  # (nel_h, s)
    tan_itf = np.tan(x1_itf)  # (nel_h+1,)
    eta_el = eta_1d.reshape(nel_v, s)

    # --- Interior grids: build per-axis index arrays then broadcast.
    # In-element index (kz*s + ky)*s + kx.
    shape = (nel_v, nel_h, nel_h, s, s, s)  # (ek, ey, ex, kz, ky, kx)
    X_b = np.broadcast_to(tan_x[None, None, :, None, None, :], shape)
    Y_b = np.broadcast_to(tan_x[None, :, None, None, :, None], shape)
    eta_b = np.broadcast_to(eta_el[:, None, None, :, None, None], shape)
    flat = (nel_v, nel_h, nel_h, s**3)
    X1 = X_b.reshape(flat)
    Y1 = Y_b.reshape(flat)
    eta1 = eta_b.reshape(flat)

    X = np.broadcast_to(X1, (6,) + flat).copy()
    Y = np.broadcast_to(Y1, (6,) + flat).copy()
    eta = np.broadcast_to(eta1, (6,) + flat).copy()

    # --- Interface grids (per interface).
    # itf_i: face index kz*s + ky; X fixed at the interface angle.
    sh_i = (nel_v, nel_h, nel_h + 1, s, s)  # (ek, ey, m, kz, ky)
    X_i = np.broadcast_to(tan_itf[None, None, :, None, None], sh_i).reshape(nel_v, nel_h, nel_h + 1, s * s)
    Y_i = np.broadcast_to(tan_x[None, :, None, None, :], sh_i).reshape(nel_v, nel_h, nel_h + 1, s * s)
    eta_i = np.broadcast_to(eta_el[:, None, None, :, None], sh_i).reshape(nel_v, nel_h, nel_h + 1, s * s)

    # itf_j: face index kz*s + kx; Y fixed at the interface angle.
    sh_j = (nel_v, nel_h + 1, nel_h, s, s)  # (ek, m, ex, kz, kx)
    X_j = np.broadcast_to(tan_x[None, None, :, None, :], sh_j).reshape(nel_v, nel_h + 1, nel_h, s * s)
    Y_j = np.broadcast_to(tan_itf[None, :, None, None, None], sh_j).reshape(nel_v, nel_h + 1, nel_h, s * s)
    eta_j = np.broadcast_to(eta_el[:, None, None, :, None], sh_j).reshape(nel_v, nel_h + 1, nel_h, s * s)

    # itf_k: face index ky*s + kx; eta fixed at the interface value.
    sh_k = (nel_v + 1, nel_h, nel_h, s, s)  # (m, ey, ex, ky, kx)
    X_k = np.broadcast_to(tan_x[None, None, :, None, :], sh_k).reshape(nel_v + 1, nel_h, nel_h, s * s)
    Y_k = np.broadcast_to(tan_x[None, :, None, :, None], sh_k).reshape(nel_v + 1, nel_h, nel_h, s * s)
    eta_k = np.broadcast_to(eta_itf_1d[:, None, None, None, None], sh_k).reshape(nel_v + 1, nel_h, nel_h, s * s)

    geom = CubedSphere3D(
        num_solpts=s,
        nel_h=nel_h,
        nel_v=nel_v,
        ztop=float(ztop),
        lambda0=lambda0,
        phi0=phi0,
        alpha0=alpha0,
        earth_radius=EARTH_RADIUS / planet_scaling_factor,
        rotation_speed=ROTATION_SPEED * (1.0 if planet_is_rotating else 0.0) / planet_scaling_factor,
        deep=deep,
        delta_x1=delta_x1,
        delta_x2=delta_x1,
        delta_eta=delta_eta,
        lon_p=lon_p,
        lat_p=lat_p,
        angle_p=angle_p,
        x1=x1,
        x1_itf=x1_itf,
        eta_1d=eta_1d,
        eta_itf_1d=eta_itf_1d,
        X=X,
        Y=Y,
        eta=eta,
        height=np.zeros_like(eta),  # filled below
        lon=np.zeros_like(X),
        lat=np.zeros_like(X),
        coslat=np.zeros_like(X),
        sinlat=np.zeros_like(X),
        X_itf_i=np.broadcast_to(X_i, (6,) + X_i.shape).copy(),
        Y_itf_i=np.broadcast_to(Y_i, (6,) + Y_i.shape).copy(),
        eta_itf_i=np.broadcast_to(eta_i, (6,) + eta_i.shape).copy(),
        height_itf_i=np.zeros((6,) + eta_i.shape),
        X_itf_j=np.broadcast_to(X_j, (6,) + X_j.shape).copy(),
        Y_itf_j=np.broadcast_to(Y_j, (6,) + Y_j.shape).copy(),
        eta_itf_j=np.broadcast_to(eta_j, (6,) + eta_j.shape).copy(),
        height_itf_j=np.zeros((6,) + eta_j.shape),
        X_itf_k=np.broadcast_to(X_k, (6,) + X_k.shape).copy(),
        Y_itf_k=np.broadcast_to(Y_k, (6,) + Y_k.shape).copy(),
        eta_itf_k=np.broadcast_to(eta_k, (6,) + eta_k.shape).copy(),
        height_itf_k=np.zeros((6,) + eta_k.shape),
        zbot=np.zeros((6, nel_h, nel_h, s * s)),
        zbot_itf_i=np.zeros((6, nel_h, nel_h + 1, s)),
        zbot_itf_j=np.zeros((6, nel_h + 1, nel_h, s)),
    )

    # lat/lon fields (height does not change lon/lat on the sphere).
    lon = np.empty_like(X)
    lat = np.empty_like(X)
    for p in range(6):
        c = gnomonic_to_cartesian(X[p], Y[p], lon_p[p], lat_p[p], angle_p[p])
        lon[p], lat[p] = cartesian_to_lonlat(*c)

    # Floor-interface lat/lon, used to evaluate topography at interfaces.
    def lonlat_of(Xa, Ya):
        lo = np.empty_like(Xa)
        la = np.empty_like(Xa)
        for p in range(6):
            c = gnomonic_to_cartesian(Xa[p], Ya[p], lon_p[p], lat_p[p], angle_p[p])
            lo[p], la[p] = cartesian_to_lonlat(*c)
        return lo, la

    # Floor slices of the itf grids: kz = 0 plane has the right (X, Y).
    Xi_f = np.broadcast_to(tan_itf[None, None, :, None], (6, nel_h, nel_h + 1, s))
    Yi_f = np.broadcast_to(tan_x[None, :, None, :], (6, nel_h, nel_h + 1, s))
    Xj_f = np.broadcast_to(tan_x[None, None, :, :], (6, nel_h + 1, nel_h, s))
    Yj_f = np.broadcast_to(tan_itf[None, :, None, None], (6, nel_h + 1, nel_h, s))
    lon_i_f, lat_i_f = lonlat_of(Xi_f.copy(), Yi_f.copy())
    lon_j_f, lat_j_f = lonlat_of(Xj_f.copy(), Yj_f.copy())

    geom = replace(
        geom,
        lon=lon,
        lat=lat,
        coslat=np.cos(lat),
        sinlat=np.sin(lat),
        lon_itf_i_floor=lon_i_f,
        lat_itf_i_floor=lat_i_f,
        lon_itf_j_floor=lon_j_f,
        lat_itf_j_floor=lat_j_f,
    )
    return apply_topography(geom, None)


def apply_topography(geom: CubedSphere3D, zbot_fn: Optional[Callable]) -> CubedSphere3D:
    """Return a geometry with the terrain-following heights regenerated for
    the given surface-height function zbot_fn(lon, lat) (None = flat).
    Mirrors the reference's CubedSphere3D.apply_topography (:441-497)."""
    s = geom.num_solpts
    nel_h, nel_v = geom.nel_h, geom.nel_v
    ztop = geom.ztop

    if zbot_fn is None:
        zbot = np.zeros((6, nel_h, nel_h, s * s))
        zbot_i = np.zeros((6, nel_h, nel_h + 1, s))
        zbot_j = np.zeros((6, nel_h + 1, nel_h, s))
    else:
        # Floor lat/lon of the interior: kz=0 slice of any level (lon/lat are
        # height-independent) — extract the (ky, kx) face from the s^3 block.
        lon_floor = geom.lon[:, 0, :, :, : s * s]
        lat_floor = geom.lat[:, 0, :, :, : s * s]
        zbot = zbot_fn(lon_floor, lat_floor)
        zbot_i = zbot_fn(geom.lon_itf_i_floor, geom.lat_itf_i_floor)
        zbot_j = zbot_fn(geom.lon_itf_j_floor, geom.lat_itf_j_floor)

    zbot_bulk = _floor_to_bulk(zbot, nel_v, s)
    height = zbot_bulk + (ztop - zbot_bulk) * geom.eta

    # itf_i: zbot_itf_i (6, ny, nx+1, s[ky]) -> (6, nk, ny, nx+1, s^2[kz,ky])
    zb_i = np.broadcast_to(
        zbot_i[:, None, :, :, None, :], (6, nel_v, nel_h, nel_h + 1, s, s)
    ).reshape(6, nel_v, nel_h, nel_h + 1, s * s)
    height_itf_i = zb_i + (ztop - zb_i) * geom.eta_itf_i

    zb_j = np.broadcast_to(
        zbot_j[:, None, :, :, None, :], (6, nel_v, nel_h + 1, nel_h, s, s)
    ).reshape(6, nel_v, nel_h + 1, nel_h, s * s)
    height_itf_j = zb_j + (ztop - zb_j) * geom.eta_itf_j

    # itf_k: floor zbot (ky, kx face) at the nel_v+1 eta interfaces.
    zb_k = np.broadcast_to(zbot[:, None, :, :, :], (6, nel_v + 1, nel_h, nel_h, s * s))
    height_itf_k = zb_k + (ztop - zb_k) * geom.eta_itf_k

    return replace(
        geom,
        height=height,
        height_itf_i=height_itf_i,
        height_itf_j=height_itf_j,
        height_itf_k=height_itf_k,
        zbot=np.asarray(zbot),
        zbot_itf_i=np.asarray(zbot_i),
        zbot_itf_j=np.asarray(zbot_j),
    )
