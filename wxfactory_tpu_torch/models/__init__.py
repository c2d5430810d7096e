from .euler_cartesian import EulerCartesianRHS, make_rhs_euler_cartesian
from .euler_cartesian_fv import EulerCartesianFVRHS, make_rhs_euler_cartesian_fv
from .euler_cubesphere import Euler3DAdvectionRHS, Euler3DRHS, RayleighDamping
from .shallow_water import ShallowWaterRHS, Topography, make_rhs_shallow_water

__all__ = ["Euler3DAdvectionRHS", "Euler3DRHS", "EulerCartesianFVRHS", "EulerCartesianRHS", "RayleighDamping",
           "ShallowWaterRHS", "Topography", "make_rhs_euler_cartesian", "make_rhs_euler_cartesian_fv",
           "make_rhs_shallow_water"]
