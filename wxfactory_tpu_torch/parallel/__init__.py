from .mesh import ShardMapTvdrk3, TileMesh, is_tile_mesh, tile_index
from .topology import EAST, NORTH, SOUTH, WEST, CubedSphereTopology

__all__ = ["CubedSphereTopology", "SOUTH", "NORTH", "WEST", "EAST", "TileMesh", "ShardMapTvdrk3", "is_tile_mesh",
           "tile_index"]
