"""Initial states of the cases the port runs: the 2D Cartesian cases 1-4
(``initialize_cartesian2d``), every shallow-water case of
the JAX package (Williamson 0, 1, 2, 5, 6, Galewsky 8, Matsuno 9, unsteady
zonal 10; ``initial_state`` returns the state and, for 5 and 10, the bottom
topography) and every DCMIP case of it, 11, 12, 20, 21, 22, 31 and 77 (3D
Euler, ``initial_state_3d``; 11 and 12 with their tracer rows and
prescribed winds, ``PrescribedWinds`` evaluating the winds on the state's
device; 20-22 with their terrain, 21 and 22 with their Rayleigh sponge)."""

from .cartesian import initialize_cartesian2d
from .dcmip import (
    acoustic_wave,
    dcmip_advection_deformation,
    dcmip_advection_hadley,
    dcmip_gravity_wave,
    dcmip_planet_params,
    dcmip_schar_waves,
    dcmip_steady_state_mountain,
    dcmip_T11_update_winds,
    dcmip_T12_update_winds,
    initial_state_3d,
    make_schar_damping,
)
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
from .winds import PrescribedWinds

__all__ = [
    "PrescribedWinds",
    "Topography",
    "acoustic_wave",
    "case_galewsky",
    "case_matsuno",
    "case_unsteady_zonal",
    "circular_vortex",
    "dcmip_T11_update_winds",
    "dcmip_T12_update_winds",
    "dcmip_advection_deformation",
    "dcmip_advection_hadley",
    "dcmip_gravity_wave",
    "dcmip_planet_params",
    "dcmip_schar_waves",
    "dcmip_steady_state_mountain",
    "eval_field",
    "height_case1",
    "height_case2",
    "height_vortex",
    "initial_state",
    "initialize_cartesian2d",
    "initial_state_3d",
    "make_schar_damping",
    "solid_body_rotation",
    "williamson_case1",
    "williamson_case2",
    "williamson_case5",
    "williamson_case6",
]
