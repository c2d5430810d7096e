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
    "height_case2",
    "initial_state",
    "solid_body_rotation",
    "williamson_case2",
    "williamson_case6",
]
