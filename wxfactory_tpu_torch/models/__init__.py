from .euler_cubesphere import Euler3DRHS
from .shallow_water import ShallowWaterRHS, make_rhs_shallow_water

__all__ = ["Euler3DRHS", "ShallowWaterRHS", "make_rhs_shallow_water"]
