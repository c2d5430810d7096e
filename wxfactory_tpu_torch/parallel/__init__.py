from .topology import EAST, NORTH, SOUTH, WEST, CubedSphereTopology

__all__ = ["CubedSphereTopology", "SOUTH", "NORTH", "WEST", "EAST"]
