"""Initial conditions of the 2D Cartesian Euler test lab.

Counterpart of ``wxfactory_tpu/testcases/cartesian.py`` (the reference's
init/initialize.py:205-337, initialize_cartesian2d), the same numpy code: an
isentropic hydrostatic base state with a potential-temperature
perturbation (pill / Gaussian bubble / colliding bubbles / cold density
current).
"""

import numpy as np

from ..common.constants import (
    CPD,
    CVD,
    GRAVITY,
    IDX_2D_RHO,
    IDX_2D_RHO_THETA,
    IDX_2D_RHO_U,
    IDX_2D_RHO_W,
    P0,
    RD,
)
from ..geometry.cartesian import Cartesian2D


def initialize_cartesian2d(geom: Cartesian2D, case_number: int, bubble_theta: float = 303.15,
                           bubble_rad: float = 250.0) -> np.ndarray:
    """Build the initial state ``Q[4, nel_z, nel_x, s^2]`` for the given case.

    Cases: 1 = pill (sharp +0.5K disc), 2 = Gaussian bubble,
    3 = colliding warm/cold bubbles, 4 = cold density current.
    """
    x1, x3 = geom.X1, geom.X3
    theta = np.full_like(x1, float(bubble_theta))
    uu = np.zeros_like(x1)
    ww = np.zeros_like(x1)

    if case_number == 1:
        xc, zc, pert = 500.0, 260.0, 0.5
        r2 = (x1 - xc) ** 2 + (x3 - zc) ** 2
        theta = np.where(r2 < bubble_rad**2, theta + pert, theta)

    elif case_number == 2:
        amp, a, s_width, x0, z0 = 0.5, 50.0, 100.0, 500.0, 260.0
        r = np.sqrt((x1 - x0) ** 2 + (x3 - z0) ** 2)
        theta = np.where(r <= a, theta + amp, theta + amp * np.exp(-(((r - a) / s_width) ** 2)))

    elif case_number == 3:
        for amp, a, s_width, x0, z0 in ((0.5, 150.0, 50.0, 500.0, 300.0), (-0.15, 0.0, 50.0, 560.0, 640.0)):
            r = np.sqrt((x1 - x0) ** 2 + (x3 - z0) ** 2)
            theta = np.where(r <= a, theta + amp, theta + amp * np.exp(-(((r - a) / s_width) ** 2)))

    elif case_number == 4:
        x0, z0, xr, zr, theta_c = 0.0, 3000.0, 4000.0, 2000.0, -15.0
        r = np.sqrt(((x1 - x0) / xr) ** 2 + ((x3 - z0) / zr) ** 2)
        theta = np.where(r <= 1.0, theta + 0.5 * theta_c * (1.0 + np.cos(np.pi * r)), theta)

    else:
        raise ValueError(f"Unknown 2D Cartesian case number: {case_number}")

    # Hydrostatic isentropic base state in Exner-pressure form.
    exner = 1.0 - GRAVITY / (CPD * theta) * x3
    rho = P0 / (RD * theta) * exner ** (CVD / RD)

    q = np.zeros((4,) + x1.shape, dtype=np.float64)
    q[IDX_2D_RHO] = rho
    q[IDX_2D_RHO_U] = rho * uu
    q[IDX_2D_RHO_W] = rho * ww
    q[IDX_2D_RHO_THETA] = rho * theta
    return q
