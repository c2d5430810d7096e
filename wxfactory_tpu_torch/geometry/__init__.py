from .cubed_sphere import CubedSphere2D, make_cubed_sphere_2d
from .cubed_sphere_3d import CubedSphere3D, make_cubed_sphere_3d
from .metric import Metric2D, make_metric_2d
from .metric3d import Metric3D, make_metric_3d

__all__ = [
    "CubedSphere2D", "make_cubed_sphere_2d", "CubedSphere3D", "make_cubed_sphere_3d",
    "Metric2D", "make_metric_2d", "Metric3D", "make_metric_3d",
]
