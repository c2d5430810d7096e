from .shallow_water import ShallowWaterRHS, make_rhs_shallow_water

__all__ = ["ShallowWaterRHS", "make_rhs_shallow_water"]
