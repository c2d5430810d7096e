from .euler_cubesphere import Euler3DAdvectionRHS, Euler3DRHS, RayleighDamping
from .shallow_water import ShallowWaterRHS, Topography, make_rhs_shallow_water

__all__ = ["Euler3DAdvectionRHS", "Euler3DRHS", "RayleighDamping", "ShallowWaterRHS", "Topography", "make_rhs_shallow_water"]
