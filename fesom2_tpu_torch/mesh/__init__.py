from .tables import MeshTables, build_mesh, build_mesh_from_raw
from .io import RawMesh, read_raw_mesh

__all__ = ["MeshTables", "build_mesh", "build_mesh_from_raw", "RawMesh",
           "read_raw_mesh"]
