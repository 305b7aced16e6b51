# Frozen copy of fesom2_tpu_torch/mesh/__init__.py, lines 1-5 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
from .tables import MeshTables, build_mesh, build_mesh_from_raw
from .io import RawMesh, read_raw_mesh

__all__ = ["MeshTables", "build_mesh", "build_mesh_from_raw", "RawMesh",
           "read_raw_mesh"]
