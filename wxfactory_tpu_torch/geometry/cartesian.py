"""2D Cartesian (x-z slice) tensor-product mesh of DFR elements.

Counterpart of ``wxfactory_tpu/geometry/cartesian.py`` (the reference's
geometry/cartesian_2d_mesh.py, Cartesian2D), the same numpy code.
Coordinates are stored element-blocked, ``X[nel_z, nel_x, s^2]`` with the
in-element index ``kz * s + kx``, matching the state layout so initial
conditions are pure elementwise math.
"""

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..ops.quadrature import gauss_legendre


@dataclass(frozen=True)
class Cartesian2D:
    num_solpts: int
    num_elements_x: int
    num_elements_z: int
    domain_x: Tuple[float, float]
    domain_z: Tuple[float, float]
    delta_x1: float
    delta_x3: float
    X1: np.ndarray  # (nel_z, nel_x, s^2)
    X3: np.ndarray  # (nel_z, nel_x, s^2)
    solution_points: np.ndarray  # (s,)
    xperiodic: bool = False

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        return (self.num_elements_z, self.num_elements_x, self.num_solpts**2)

    def to_single_block(self, a: np.ndarray) -> np.ndarray:
        """Reassemble element-blocked data (..., nel_z, nel_x, s^2) into a
        plottable 2D block (..., nel_z*s, nel_x*s)."""
        s = self.num_solpts
        lead = a.shape[:-3]
        tmp = a.reshape(lead + (self.num_elements_z, self.num_elements_x, s, s))
        tmp = np.swapaxes(tmp, -2, -3)
        return tmp.reshape(lead + (self.num_elements_z * s, self.num_elements_x * s))


def make_cartesian_2d(
    domain_x: Tuple[float, float],
    domain_z: Tuple[float, float],
    num_elements_x: int,
    num_elements_z: int,
    num_solpts: int,
) -> Cartesian2D:
    _, pts, _ = gauss_legendre(num_solpts)
    scaled = 0.5 * (1.0 + pts)  # nodes mapped to [0, 1]

    dx1 = (domain_x[1] - domain_x[0]) / num_elements_x
    dx3 = (domain_z[1] - domain_z[0]) / num_elements_z

    # Element-blocked coordinates: x varies fastest within an element row.
    ex = np.arange(num_elements_x)
    ez = np.arange(num_elements_z)
    x_in_elem = domain_x[0] + dx1 * (ex[:, None] + scaled[None, :])  # (nel_x, s)
    z_in_elem = domain_z[0] + dx3 * (ez[:, None] + scaled[None, :])  # (nel_z, s)

    s = num_solpts
    X1 = np.broadcast_to(x_in_elem[None, :, None, :], (num_elements_z, num_elements_x, s, s))
    X3 = np.broadcast_to(z_in_elem[:, None, :, None], (num_elements_z, num_elements_x, s, s))

    return Cartesian2D(
        num_solpts=num_solpts,
        num_elements_x=num_elements_x,
        num_elements_z=num_elements_z,
        domain_x=tuple(domain_x),
        domain_z=tuple(domain_z),
        delta_x1=dx1,
        delta_x3=dx3,
        X1=np.ascontiguousarray(X1.reshape(num_elements_z, num_elements_x, s * s)),
        X3=np.ascontiguousarray(X3.reshape(num_elements_z, num_elements_x, s * s)),
        solution_points=pts,
    )
