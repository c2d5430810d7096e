"""Initial states of the cases the port runs: Williamson 2 and 6 (shallow
water, ``initial_state``) and DCMIP 31 and 77 (3D Euler,
``initial_state_3d``). Every other case raises ``NotImplementedError`` naming
its ROADMAP item."""

from .dcmip import acoustic_wave, dcmip_gravity_wave, dcmip_planet_params, initial_state_3d
from .shallow_water import (
    Topography,
    height_case2,
    initial_state,
    solid_body_rotation,
    williamson_case2,
    williamson_case6,
)

__all__ = [
    "Topography",
    "acoustic_wave",
    "dcmip_gravity_wave",
    "dcmip_planet_params",
    "height_case2",
    "initial_state",
    "initial_state_3d",
    "solid_body_rotation",
    "williamson_case2",
    "williamson_case6",
]
