"""Closed-form 2D metric of the rotated cubed sphere.

Same code as ``wxfactory_tpu/geometry/metric.py`` (reference
geometry/metric2d.py, Metric2D):
sqrt(g), contravariant/covariant metric tensors at solution points and at
both interface families, Christoffel symbols (including the grid-rotation
time components), Coriolis parameter — all pre-scaled to reference-element
coordinates (the delta_x/2 powers).

Arrays are global, panel-major: (6, nel, nel, s^2) at solution points and
(6, nel, nel+2, 2s) / (6, nel+2, nel, 2s) at interfaces, matching the
geometry. Built once on host in float64 numpy; the RHS copies what it needs
to the device once.
"""

from dataclasses import dataclass

import numpy as np

from .cubed_sphere import CubedSphere2D


@dataclass(frozen=True)
class Metric2D:
    sqrtG: np.ndarray
    inv_sqrtG: np.ndarray
    sqrtG_itf_i: np.ndarray
    sqrtG_itf_j: np.ndarray

    H_contra_11: np.ndarray
    H_contra_12: np.ndarray
    H_contra_21: np.ndarray
    H_contra_22: np.ndarray
    H_contra_11_itf_i: np.ndarray
    H_contra_12_itf_i: np.ndarray
    H_contra_21_itf_i: np.ndarray
    H_contra_22_itf_i: np.ndarray
    H_contra_11_itf_j: np.ndarray
    H_contra_12_itf_j: np.ndarray
    H_contra_21_itf_j: np.ndarray
    H_contra_22_itf_j: np.ndarray

    H_cov_11: np.ndarray
    H_cov_12: np.ndarray
    H_cov_21: np.ndarray
    H_cov_22: np.ndarray

    christoffel_1_01: np.ndarray
    christoffel_1_02: np.ndarray
    christoffel_2_01: np.ndarray
    christoffel_2_02: np.ndarray
    christoffel_1_11: np.ndarray
    christoffel_1_12: np.ndarray
    christoffel_2_12: np.ndarray
    christoffel_2_22: np.ndarray

    coriolis_f: np.ndarray

    # Factored form of the time Christoffels: christoffel_a_0b ==
    # coriolis_factor_a_0b * gridrot, where the factor is identical on all
    # six panels (pure geometry) and ``gridrot`` carries the entire
    # panel/rotation dependence (metric.py:93-99). The SW operator kernel
    # exploits this to read 13 single-panel constants + one full field
    # instead of 13 full fields.
    gridrot: np.ndarray
    coriolis_factor_1_01: np.ndarray
    coriolis_factor_1_02: np.ndarray
    coriolis_factor_2_01: np.ndarray
    coriolis_factor_2_02: np.ndarray


def make_metric_2d(geom: CubedSphere2D) -> Metric2D:
    """All metric quantities in closed form from the gnomonic coordinates
    (reference metric2d.py:7-167), with reference-element scaling applied."""
    r2 = geom.earth_radius**2
    X, Y = geom.X, geom.Y
    d2, d = geom.delta2, geom.delta
    dx1, dx2 = geom.delta_x1, geom.delta_x2

    # Area element and contravariant metric at solution points.
    sqrtG = r2 * (1.0 + X**2) * (1.0 + Y**2) / (d2 * d) * (dx1 * dx2 / 8.0)
    h11 = d2 / (r2 * (1.0 + X**2)) * (4.0 / dx1**2)
    h12 = d2 * X * Y / (r2 * (1.0 + X**2) * (1.0 + Y**2)) * (4.0 / (dx1 * dx2))
    h22 = d2 / (r2 * (1.0 + Y**2)) * (4.0 / dx2**2)

    # Covariant metric.
    fact = r2 / d**4
    cov11 = fact * (1.0 + X**2) ** 2 * (1.0 + Y**2) * (dx1**2 / 4.0)
    cov12 = -fact * X * Y * (1.0 + X**2) * (1.0 + Y**2) * (dx1 * dx2 / 4.0)
    cov22 = fact * (1.0 + X**2) * (1.0 + Y**2) ** 2 * (dx2**2 / 4.0)

    # Interface variants.
    def itf_terms(Xi, Yi, d2i, di):
        sqrtG_i = r2 * (1.0 + Xi**2) * (1.0 + Yi**2) / (d2i * di) * (dx1 * dx2 / 8.0)
        h11_i = d2i / (r2 * (1.0 + Xi**2)) * (4.0 / dx1**2)
        h12_i = d2i * Xi * Yi / (r2 * (1.0 + Xi**2) * (1.0 + Yi**2)) * (4.0 / (dx1 * dx2))
        h22_i = d2i / (r2 * (1.0 + Yi**2)) * (4.0 / dx2**2)
        return sqrtG_i, h11_i, h12_i, h22_i

    sqrtG_i, h11_i, h12_i, h22_i = itf_terms(geom.X_itf_i, geom.Y_itf_i, geom.delta2_itf_i, geom.delta_itf_i)
    sqrtG_j, h11_j, h12_j, h22_j = itf_terms(geom.X_itf_j, geom.Y_itf_j, geom.delta2_itf_j, geom.delta_itf_j)

    # Rotation factor common to the time-Christoffels and Coriolis parameter.
    lat_p = geom.lat_p.reshape(6, 1, 1, 1)
    angle_p = geom.angle_p.reshape(6, 1, 1, 1)
    gridrot = np.sin(lat_p) - X * np.cos(lat_p) * np.sin(angle_p) + Y * np.cos(lat_p) * np.cos(angle_p)
    omega = geom.rotation_speed

    cf_1_01 = omega * X * Y / d2
    cf_1_02 = -omega * (1.0 + Y**2) / d2
    cf_2_01 = omega * (1.0 + X**2) / d2
    cf_2_02 = -omega * X * Y / d2
    chr_1_01 = cf_1_01 * gridrot
    chr_1_02 = cf_1_02 * gridrot
    chr_2_01 = cf_2_01 * gridrot
    chr_2_02 = cf_2_02 * gridrot

    chr_1_11 = 2.0 * X * Y**2 / d2 * (0.5 * dx1)
    chr_1_12 = -(Y + Y**3) / d2 * (0.5 * dx1)
    chr_2_12 = -X * (1.0 + X**2) / d2 * (0.5 * dx2)
    chr_2_22 = 2.0 * X**2 * Y / d2 * (0.5 * dx2)

    coriolis_f = 2.0 * omega / d * gridrot

    return Metric2D(
        sqrtG=sqrtG,
        inv_sqrtG=1.0 / sqrtG,
        sqrtG_itf_i=sqrtG_i,
        sqrtG_itf_j=sqrtG_j,
        H_contra_11=h11,
        H_contra_12=h12,
        H_contra_21=h12.copy(),
        H_contra_22=h22,
        H_contra_11_itf_i=h11_i,
        H_contra_12_itf_i=h12_i,
        H_contra_21_itf_i=h12_i.copy(),
        H_contra_22_itf_i=h22_i,
        H_contra_11_itf_j=h11_j,
        H_contra_12_itf_j=h12_j,
        H_contra_21_itf_j=h12_j.copy(),
        H_contra_22_itf_j=h22_j,
        H_cov_11=cov11,
        H_cov_12=cov12,
        H_cov_21=cov12.copy(),
        H_cov_22=cov22,
        christoffel_1_01=chr_1_01,
        christoffel_1_02=chr_1_02,
        christoffel_2_01=chr_2_01,
        christoffel_2_02=chr_2_02,
        christoffel_1_11=chr_1_11,
        christoffel_1_12=chr_1_12,
        christoffel_2_12=chr_2_12,
        christoffel_2_22=chr_2_22,
        coriolis_f=coriolis_f,
        gridrot=gridrot,
        coriolis_factor_1_01=cf_1_01,
        coriolis_factor_1_02=cf_1_02,
        coriolis_factor_2_01=cf_2_01,
        coriolis_factor_2_02=cf_2_02,
    )
