"""Initial states of the cases the port runs: every shallow-water case of
the JAX package (Williamson 0, 1, 2, 5, 6, Galewsky 8, Matsuno 9, unsteady
zonal 10; ``initial_state`` returns the state and, for 5 and 10, the bottom
topography) and DCMIP 31 and 77 (3D Euler, ``initial_state_3d``). Every
other 3D case raises ``NotImplementedError`` naming its ROADMAP item."""

from .dcmip import acoustic_wave, dcmip_gravity_wave, dcmip_planet_params, initial_state_3d
from .matsuno import case_matsuno, eval_field
from .shallow_water import (
    Topography,
    case_galewsky,
    case_unsteady_zonal,
    circular_vortex,
    height_case1,
    height_case2,
    height_vortex,
    initial_state,
    solid_body_rotation,
    williamson_case1,
    williamson_case2,
    williamson_case5,
    williamson_case6,
)

__all__ = [
    "Topography",
    "acoustic_wave",
    "case_galewsky",
    "case_matsuno",
    "case_unsteady_zonal",
    "circular_vortex",
    "dcmip_gravity_wave",
    "dcmip_planet_params",
    "eval_field",
    "height_case1",
    "height_case2",
    "height_vortex",
    "initial_state",
    "initial_state_3d",
    "solid_body_rotation",
    "williamson_case1",
    "williamson_case2",
    "williamson_case5",
    "williamson_case6",
]
