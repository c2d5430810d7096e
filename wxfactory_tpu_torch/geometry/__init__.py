from .cubed_sphere import CubedSphere2D, make_cubed_sphere_2d
from .metric import Metric2D, make_metric_2d

__all__ = ["CubedSphere2D", "make_cubed_sphere_2d", "Metric2D", "make_metric_2d"]
