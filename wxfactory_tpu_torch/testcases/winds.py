"""The prescribed time-dependent winds of DCMIP 11 and 12 on the state's
device.

The JAX package's step loop overwrites the momenta after every step of
these cases with ``rho * (u1, u2, w)(t + dt)`` from ``dcmip_T11_update_winds``
/ ``dcmip_T12_update_winds`` (its simulation.py:104-127; the port's numpy
copies are in ``testcases/dcmip.py``). ``PrescribedWinds`` moves what those
functions read of the geometry to the device once, in float64 (lon, the
time-independent factors of lat and height, and ``wind2contra_2d``'s
coefficients), and evaluates the same formulas there each step with torch
operations and Python-float time factors: no host-to-device copy of a field
and no host sync a step. DCMIP 11's ``lon - 2 pi t / tau`` sits inside the
sines and cosines, so those are evaluated on the device every step.
"""

import math

import numpy as np
import torch

from ..common.constants import GRAVITY, P0, RD
from ..geometry.cubed_sphere import _wind_jacobian_vec

TAU = {11: 12.0 * 86400.0, 12: 86400.0}


class PrescribedWinds:
    """(u1, u2, w) of DCMIP ``case_number`` (11 or 12) at any time, float64
    on ``device``; ``overwrite(q, t)`` is the post-step hook."""

    def __init__(self, geom, case_number: int, device="cpu"):
        if case_number not in TAU:
            raise ValueError(f"prescribed winds exist for DCMIP 11 and 12, not case {case_number}")
        self.case_number = case_number
        self.tau = TAU[case_number]
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64), device=device)
        T0 = 300.0
        H = RD * T0 / GRAVITY
        a = geom.earth_radius
        lat, height = np.asarray(geom.lat), np.asarray(geom.height)
        cos_lat = np.cos(lat)
        p = P0 * np.exp(-height / H)
        if case_number == 11:
            ptop = P0 * math.exp(-12000.0 / H)
            bs = 0.2
            omega0 = 23000.0 * math.pi / self.tau
            s = (1.0 + math.exp((ptop - P0) / (bs * ptop)) - np.exp((p - P0) / (bs * ptop))
                 - np.exp((ptop - p) / (bs * ptop)))
            self.k0 = 10.0 * a / self.tau
            self.c_ud = (omega0 * a) / (bs * ptop)
            self.planes = {
                "lon": t(geom.lon), "cos_lat": t(cos_lat), "cos_lat2": t(cos_lat**2), "sin_2lat": t(np.sin(2.0 * lat)),
                "u0_cos_lat": t((2.0 * math.pi * a / self.tau) * cos_lat),
                "ud_z": t(-np.exp((p - P0) / (bs * ptop)) + np.exp((ptop - p) / (bs * ptop))),
                "w_z": t(-(RD * T0 / (GRAVITY * p)) * omega0), "s": t(s),
            }
        else:
            w0, K, ztop = 0.15, 5.0, geom.ztop
            rho_ratio = (P0 / (RD * T0)) / (p / (RD * T0))
            self.planes = {
                "u": t(40.0 * cos_lat),
                "v": t(-rho_ratio * (a * w0 * math.pi) / (K * ztop) * cos_lat * np.sin(K * lat)
                       * np.cos(math.pi * height / ztop)),
                "w": t(rho_ratio * (w0 / K) * (-2.0 * np.sin(K * lat) * np.sin(lat) + K * cos_lat * np.cos(K * lat))
                       * np.sin(math.pi * height / ztop)),
            }
        # wind2contra_2d (geometry/cubed_sphere_3d.py) on the interior grid.
        nd = geom.X.ndim
        bcast = lambda v: np.asarray(v).reshape((6,) + (1,) * (nd - 1))
        j11, j12, j21, j22 = _wind_jacobian_vec(geom.X, geom.Y, bcast(geom.lat_p), bcast(geom.angle_p))
        radius = a + height if geom.deep else a
        self.radius = t(radius) if geom.deep else radius
        self.radius_coslat = t(radius * np.asarray(geom.coslat))
        self.jac = (t(j11), t(j12), t(j21), t(j22))
        self.delta_x1, self.delta_x2 = geom.delta_x1, geom.delta_x2

    def __call__(self, time: float) -> torch.Tensor:
        """(u1, u2, w) at ``time`` (s), stacked (3, 6, nk, ny, nx, s^3)."""
        P = self.planes
        tau = self.tau
        if self.case_number == 11:
            ct1, ct2 = math.cos(math.pi * time / tau), math.cos(2.0 * math.pi * time / tau)
            lonp = P["lon"] - 2.0 * math.pi * time / tau
            sin_lonp = torch.sin(lonp)
            ud = self.c_ud * torch.cos(lonp) * P["cos_lat2"] * ct2 * P["ud_z"]
            u = self.k0 * sin_lonp**2 * P["sin_2lat"] * ct1 + P["u0_cos_lat"] + ud
            v = self.k0 * torch.sin(2.0 * lonp) * P["cos_lat"] * ct1
            w = P["w_z"] * sin_lonp * P["cos_lat"] * ct2 * P["s"]
        else:
            ct = math.cos(math.pi * time / tau)
            u, v, w = P["u"], P["v"] * ct, P["w"] * ct
        lambda_dot = u / self.radius_coslat
        phi_dot = v / self.radius
        j11, j12, j21, j22 = self.jac
        u1 = (j11 * lambda_dot + j12 * phi_dot) * 2.0 / self.delta_x1
        u2 = (j21 * lambda_dot + j22 * phi_dot) * 2.0 / self.delta_x2
        return torch.stack([u1, u2, w])

    def overwrite(self, q: torch.Tensor, time: float) -> torch.Tensor:
        """A new state: ``q`` with its momenta set to rho * (u1, u2, w) at
        ``time`` (the JAX package's ``wind_overwrite``, formed in float64
        and cast to q's dtype, as its float64 winds promote there)."""
        mom = (q[0].double() * self(time)).to(q.dtype)
        return torch.cat([q[0:1], mom, q[4:]])
