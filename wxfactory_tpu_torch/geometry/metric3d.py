"""Numerical 3D metric of the terrain-following rotated cubed sphere.

Same code as ``wxfactory_tpu/geometry/metric3d.py`` (reference
geometry/metric3d.py, Metric3DTopo), with two differences that do not change
a result: the panel-edge halo of the height derivatives goes through the
port's torch topology on CPU float64 tensors, and the per-point Christoffel
solve runs in chunks of points to bound host memory at large grids.

Metric tensors and sqrt(g) are computed from the gnomonic coordinates and the
NUMERICAL derivatives of the height field (so topography is handled
exactly as the discretization sees it), time-Christoffel symbols are
analytic (grid rotation), and spatial Christoffel symbols are obtained from the
free-stream-preservation identity (sqrt(g) h^ab)_{;c} = 0 via a per-point
27x27 linear solve (metric3d.py:938-996). Only the reference's "new
layout" half is built; everything is global (panel axis 6) and host-side
float64 numpy, computed once at setup.

Layouts match geometry/cubed_sphere_3d.py: interior (6, nk, ny, nx, s^3),
interfaces per-interface (6, ..., s^2).
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.dfr import DFROperators
from .cubed_sphere_3d import CubedSphere3D

# Deferred: parallel.topology itself imports geometry (panel Jacobians), so a
# module-level import here would make `import wxfactory_tpu_torch.parallel` circular.
EAST, NORTH, SOUTH, WEST = 3, 1, 0, 2  # = parallel.topology constants

# Points per batched 27x27 Christoffel solve (the system matrices take
# 5.8 KB a point: 1.3 M points would otherwise need ~8 GB at once).
_SOLVE_CHUNK = 1 << 16


@dataclass(frozen=True)
class Metric3D:
    # Interior (6, nk, ny, nx, s^3)
    sqrtG: np.ndarray
    inv_sqrtG: np.ndarray
    h_contra: np.ndarray  # (3, 3, 6, nk, ny, nx, s^3)
    h_cov: np.ndarray
    christoffel: np.ndarray  # (3, 9, 6, nk, ny, nx, s^3), rows [c01,c02,c03,c11,c12,c13,c22,c23,c33]
    inv_dzdeta: np.ndarray

    # Interfaces, per-interface layout
    sqrtG_itf_i: np.ndarray  # (6, nk, ny, nx+1, s^2)
    sqrtG_itf_j: np.ndarray
    sqrtG_itf_k: np.ndarray
    h_contra_itf_i: np.ndarray  # (3, 3, 6, nk, ny, nx+1, s^2)
    h_contra_itf_j: np.ndarray
    h_contra_itf_k: np.ndarray
    h_cov_itf_i: np.ndarray
    h_cov_itf_j: np.ndarray
    h_cov_itf_k: np.ndarray


def _faces_from_itf_x(itf: np.ndarray) -> np.ndarray:
    """Per-interface (..., nx+1, s^2) -> element faces (..., nx, 2s^2)."""
    return np.concatenate([itf[..., :-1, :], itf[..., 1:, :]], axis=-1)


def _faces_from_itf_y(itf: np.ndarray) -> np.ndarray:
    """(..., ny+1, nx, s^2) -> (..., ny, nx, 2s^2)."""
    return np.concatenate([itf[..., :-1, :, :], itf[..., 1:, :, :]], axis=-1)


def _faces_from_itf_z(itf: np.ndarray) -> np.ndarray:
    """(..., nk+1, ny, nx, s^2) -> (..., nk, ny, nx, 2s^2)."""
    return np.concatenate([itf[..., :-1, :, :, :], itf[..., 1:, :, :, :]], axis=-1)


def make_metric_3d(geom: CubedSphere3D, ops: DFROperators, topology=None) -> Metric3D:
    if topology is None:
        from ..parallel.topology import CubedSphereTopology

        topology = CubedSphereTopology(geom)
    s = geom.num_solpts
    ss = s * s
    nel_h, nel_v = geom.nel_h, geom.nel_v
    dx, dy, deta = geom.delta_x1, geom.delta_x2, geom.delta_eta
    A = geom.earth_radius
    deep = geom.deep

    Dx, Dy, Dz = ops.derivative_x3, ops.derivative_y3, ops.derivative_z3
    Cx, Cy, Cz = ops.correction_WE3, ops.correction_SN3, ops.correction_DU3
    Ex, Ey, Ez = ops.extrap_x3, ops.extrap_y3, ops.extrap_z3

    H = geom.height  # (6, nk, ny, nx, s^3)

    def d_interior(f, itf_i, itf_j, itf_k):
        """Reference-element derivatives of a continuous field given shared
        interface values (reference metric3d.py:117-124), with 2/delta."""
        fx = (f @ Dx + _faces_from_itf_x(itf_i) @ Cx) * (2.0 / dx)
        fy = (f @ Dy + _faces_from_itf_y(itf_j) @ Cy) * (2.0 / dy)
        fz = (f @ Dz + _faces_from_itf_z(itf_k) @ Cz) * (2.0 / deta)
        return fx, fy, fz

    dRdx1, dRdx2, dRdeta = d_interior(H, geom.height_itf_i, geom.height_itf_j, geom.height_itf_k)

    # --- Interface values of the dR fields: average the extrapolations from
    # both adjacent elements; at panel edges convert the neighbor's
    # (dRdx1, dRdx2) covariantly (metric3d.py:298-505); vertical boundaries
    # are one-sided.
    def itf_values(f):
        ex_i = f @ Ex  # (6, nk, ny, nx, 2s^2)
        ex_j = f @ Ey
        ex_k = f @ Ez
        return ex_i, ex_j, ex_k

    dR1_ex = itf_values(dRdx1)
    dR2_ex = itf_values(dRdx2)
    dRe_ex = itf_values(dRdeta)

    halos = topology.halo_vectors_3d(
        *(torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64))
          for a in (dR1_ex[0], dR1_ex[1], dR2_ex[0], dR2_ex[1], dRe_ex[0], dRe_ex[1])),
        covariant=True,
    )
    halos = {d: tuple(c.numpy() for c in comps) for d, comps in halos.items()}

    def avg_itf_x(ex, halo_w, halo_e):
        """(6,nk,ny,nx,2s^2) faces + west/east halos -> (6,nk,ny,nx+1,s^2)."""
        east_faces = ex[..., ss:]  # (6, nk, ny, nx, s^2)
        west_faces = ex[..., :ss]
        left = np.concatenate([halo_w[..., None, :], east_faces], axis=-2)  # value from the west side
        right = np.concatenate([west_faces, halo_e[..., None, :]], axis=-2)
        return 0.5 * (left + right)

    def avg_itf_y(ex, halo_s, halo_n):
        north_faces = ex[..., ss:]
        south_faces = ex[..., :ss]
        left = np.concatenate([halo_s[..., None, :, :], north_faces], axis=-3)
        right = np.concatenate([south_faces, halo_n[..., None, :, :]], axis=-3)
        return 0.5 * (left + right)

    def avg_itf_z(ex):
        bot_faces = ex[..., :ss]  # (6, nk, ny, nx, s^2)
        top_faces = ex[..., ss:]
        inner = 0.5 * (top_faces[..., :-1, :, :, :] + bot_faces[..., 1:, :, :, :])
        return np.concatenate(
            [bot_faces[..., 0:1, :, :, :], inner, top_faces[..., -1:, :, :, :]], axis=-4
        )

    def itf_all(ex_tuple, comp):
        ex_i, ex_j, ex_k = ex_tuple
        # halos[side][comp]: (6, nk, nh, s^2); reshape for concat slots
        hw, he = halos[WEST][comp], halos[EAST][comp]
        hs, hn = halos[SOUTH][comp], halos[NORTH][comp]
        itf_i = avg_itf_x(ex_i, hw, he)
        itf_j = avg_itf_y(ex_j, hs, hn)
        itf_k = avg_itf_z(ex_k)
        return itf_i, itf_j, itf_k

    dR1_itf = itf_all(dR1_ex, 0)
    dR2_itf = itf_all(dR2_ex, 1)
    dRe_itf = itf_all(dRe_ex, 2)

    # --- Metric tensors (reference metric3d.py compute_metric, :519-660).
    def compute_metric(X, Y, height, dR1, dR2, dRe):
        delsq = 1.0 + X**2 + Y**2
        del4 = delsq**2
        R = (height + A) if deep else None
        r2 = R**2 if deep else A**2
        rr = R if deep else A

        h_cov = np.empty((3, 3) + X.shape)
        h_contra = np.empty((3, 3) + X.shape)

        h_cov[0, 0] = (dx**2 / 4) * (r2 / del4 * (1 + X**2) ** 2 * (1 + Y**2) + dR1**2)
        h_cov[0, 1] = (dx * dy / 4) * (-r2 / del4 * X * Y * (1 + X**2) * (1 + Y**2) + dR1 * dR2)
        h_cov[1, 0] = h_cov[0, 1]
        h_cov[0, 2] = (deta * dx / 4) * dR1 * dRe
        h_cov[2, 0] = h_cov[0, 2]
        h_cov[1, 1] = (dy**2 / 4) * (r2 / del4 * (1 + X**2) * (1 + Y**2) ** 2 + dR2**2)
        h_cov[1, 2] = (deta * dy / 4) * dR2 * dRe
        h_cov[2, 1] = h_cov[1, 2]
        h_cov[2, 2] = (deta**2 / 4) * dRe**2

        h_contra[0, 0] = (4 / dx**2) * (delsq / (r2 * (1 + X**2)))
        h_contra[0, 1] = (4 / (dx * dy)) * (X * Y * delsq / (r2 * (1 + X**2) * (1 + Y**2)))
        h_contra[1, 0] = h_contra[0, 1]
        h_contra[0, 2] = (4 / (dx * deta)) * (
            -(dR1 * delsq / (r2 * (1 + X**2)) + dR2 * delsq * X * Y / (r2 * (1 + X**2) * (1 + Y**2))) / dRe
        )
        h_contra[2, 0] = h_contra[0, 2]
        h_contra[1, 1] = (4 / dy**2) * (delsq / (r2 * (1 + Y**2)))
        h_contra[1, 2] = (4 / (dy * deta)) * (
            -(dR1 * X * Y * delsq / (r2 * (1 + X**2) * (1 + Y**2)) + dR2 * delsq / (r2 * (1 + Y**2))) / dRe
        )
        h_contra[2, 1] = h_contra[1, 2]
        h_contra[2, 2] = (4 / deta**2) * (
            (
                1.0
                + dR1**2 * delsq / (r2 * (1 + X**2))
                + 2 * dR1 * dR2 * X * Y * delsq / (r2 * (1 + X**2) * (1 + Y**2))
                + dR2**2 * delsq / (r2 * (1 + Y**2))
            )
            / dRe**2
        )

        sqrtG = (dx / 2) * (dy / 2) * (deta / 2) * r2 * (1 + X**2) * (1 + Y**2) * np.abs(dRe) / delsq**1.5
        return h_cov, h_contra, sqrtG

    h_cov, h_contra, sqrtG = compute_metric(geom.X, geom.Y, geom.height, dRdx1, dRdx2, dRdeta)
    h_cov_i, h_contra_i, sqrtG_i = compute_metric(geom.X_itf_i, geom.Y_itf_i, geom.height_itf_i, *(
        (dR1_itf[0], dR2_itf[0], dRe_itf[0])
    ))
    h_cov_j, h_contra_j, sqrtG_j = compute_metric(geom.X_itf_j, geom.Y_itf_j, geom.height_itf_j, *(
        (dR1_itf[1], dR2_itf[1], dRe_itf[1])
    ))
    h_cov_k, h_contra_k, sqrtG_k = compute_metric(geom.X_itf_k, geom.Y_itf_k, geom.height_itf_k, *(
        (dR1_itf[2], dR2_itf[2], dRe_itf[2])
    ))

    # --- Christoffel symbols.
    X, Y = geom.X, geom.Y
    delsq = 1.0 + X**2 + Y**2
    Omega = geom.rotation_speed
    lat_p = geom.lat_p.reshape(6, 1, 1, 1, 1)
    ang_p = geom.angle_p.reshape(6, 1, 1, 1, 1)
    sphi, cphi = np.sin(lat_p), np.cos(lat_p)
    salp, calp = np.sin(ang_p), np.cos(ang_p)

    rot1 = sphi - X * cphi * salp + Y * cphi * calp
    rot2 = (1 + X**2) * cphi * calp - Y * sphi + X * Y * cphi * salp
    rot3 = (1 + Y**2) * cphi * salp + X * sphi + X * Y * cphi * calp

    rr = (geom.height + A) if deep else A

    # Time components, analytic (reference metric3d.py:683-705 + 763-810).
    c1_01 = Omega * X * Y / delsq * rot1 + dRdx1 * Omega / (rr * (1 + X**2)) * rot2
    c1_02 = -Omega * (-(1 + Y**2) / delsq) * rot1 + dRdx2 * Omega / (rr * (1 + X**2)) * rot2
    c1_03 = dRdeta * Omega / (rr * (1 + X**2)) * rot2
    c2_01 = Omega * (1 + X**2) / delsq * rot1 + dRdx1 * Omega / (rr * (1 + Y**2)) * rot3
    c2_02 = -Omega * X * Y / delsq * rot2 + dRdx2 * Omega / (rr * (1 + Y**2)) * rot3
    c2_03 = dRdeta * Omega / (rr * (1 + Y**2)) * rot3
    c3_01 = -(dRdeta**-1) * (
        dRdx1 * c1_01 + dRdx2 * c2_01 + rr / delsq * Omega * (1 + X**2) * (cphi * calp - Y * sphi)
    )
    c3_02 = -(dRdeta**-1) * (
        dRdx1 * c1_02 + dRdx2 * c2_02 + rr / delsq * Omega * (1 + Y**2) * (cphi * salp + X * sphi)
    )
    c3_03 = -dRdx1 * Omega / (rr * (1 + X**2)) * rot2 - dRdx2 * Omega / (rr * (1 + Y**2)) * rot3

    # Scale to reference-element index coordinates (metric3d.py:838-868):
    # Gamma^a_0b picks up (2/delta_a) * (delta_b/2).
    c1_01 *= (2 / dx) * (dx / 2)
    c1_02 *= (2 / dx) * (dy / 2)
    c1_03 *= (2 / dx) * (deta / 2)
    c2_01 *= (2 / dy) * (dx / 2)
    c2_02 *= (2 / dy) * (dy / 2)
    c2_03 *= (2 / dy) * (deta / 2)
    c3_01 *= (2 / deta) * (dx / 2)
    c3_02 *= (2 / deta) * (dy / 2)
    c3_03 *= (2 / deta) * (deta / 2)

    # Spatial components: solve (sqrt(g) h^ab)_{,c} =
    # sqrt(g) (h^ab G^d_cd - h^db G^a_dc - h^ad G^b_cd) pointwise
    # (free-stream preservation; metric3d.py:938-996). All quantities are
    # already in reference-element scaling; grad carries no 2/delta factor.
    sgh = h_contra * sqrtG  # (3, 3, 6, nk, ny, nx, s^3)
    sgh_i = h_contra_i * sqrtG_i
    sgh_j = h_contra_j * sqrtG_j
    sgh_k = h_contra_k * sqrtG_k

    grad_c = np.stack(
        [
            sgh @ Dx + _faces_from_itf_x(sgh_i) @ Cx,
            sgh @ Dy + _faces_from_itf_y(sgh_j) @ Cy,
            sgh @ Dz + _faces_from_itf_z(sgh_k) @ Cz,
        ]
    )  # (3[c], 3[a], 3[b], 6, nk, ny, nx, s^3)

    grid_shape = sqrtG.shape
    npts = int(np.prod(grid_shape))
    # rhs[p, a, b, c] ; lhs[p, (a,b,c), (d,e,f)]
    rhs_flat = np.moveaxis(grad_c, (1, 2, 0), (-3, -2, -1)).reshape(npts, 27)

    sg_flat = sqrtG.reshape(npts)
    h_flat = np.moveaxis(h_contra, (0, 1), (-2, -1)).reshape(npts, 3, 3)

    gamma = np.empty((npts, 27))
    for p0 in range(0, npts, _SOLVE_CHUNK):
        sl = slice(p0, min(p0 + _SOLVE_CHUNK, npts))
        sg_c, h_c = sg_flat[sl], h_flat[sl]
        lhs = np.zeros((sg_c.shape[0], 3, 3, 3, 3, 3, 3))
        for a in range(3):
            for b in range(3):
                for c in range(3):
                    for d in range(3):
                        lhs[:, a, b, c, d, c, d] += sg_c * h_c[:, a, b]
                        lhs[:, a, b, c, a, d, c] -= sg_c * h_c[:, d, b]
                        lhs[:, a, b, c, b, c, d] -= sg_c * h_c[:, a, d]
        gamma[sl] = np.linalg.solve(lhs.reshape(-1, 27, 27), rhs_flat[sl, :, None])[..., 0]
    gamma = gamma.reshape(npts, 3, 3, 3)
    gamma = np.moveaxis(gamma, 0, -1).reshape((3, 3, 3) + grid_shape)

    # christoffel[a, row] with rows [c01, c02, c03, c11, c12, c13, c22, c23, c33]
    christoffel = np.empty((3, 9) + grid_shape)
    for a, (t01, t02, t03) in enumerate([(c1_01, c1_02, c1_03), (c2_01, c2_02, c2_03), (c3_01, c3_02, c3_03)]):
        christoffel[a, 0] = t01
        christoffel[a, 1] = t02
        christoffel[a, 2] = t03
        christoffel[a, 3] = gamma[a, 0, 0]
        christoffel[a, 4] = gamma[a, 0, 1]
        christoffel[a, 5] = gamma[a, 0, 2]
        christoffel[a, 6] = gamma[a, 1, 1]
        christoffel[a, 7] = gamma[a, 1, 2]
        christoffel[a, 8] = gamma[a, 2, 2]

    inv_dzdeta = (1.0 / dRdeta) * (2.0 / deta)

    return Metric3D(
        sqrtG=sqrtG,
        inv_sqrtG=1.0 / sqrtG,
        h_contra=h_contra,
        h_cov=h_cov,
        christoffel=christoffel,
        inv_dzdeta=inv_dzdeta,
        sqrtG_itf_i=sqrtG_i,
        sqrtG_itf_j=sqrtG_j,
        sqrtG_itf_k=sqrtG_k,
        h_contra_itf_i=h_contra_i,
        h_contra_itf_j=h_contra_j,
        h_contra_itf_k=h_contra_k,
        h_cov_itf_i=h_cov_i,
        h_cov_itf_j=h_cov_j,
        h_cov_itf_k=h_cov_k,
    )
