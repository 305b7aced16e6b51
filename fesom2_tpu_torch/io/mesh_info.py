"""The mesh description file ``fesom.mesh.diag.nc`` for post-processing
(ref ``src/io_mesh_info.F90`` write_mesh_info :37-276: the same
dimensions and variables, 1-based indices, so that the reference's
post-processing tools read it unchanged).

The port's own copy of ``fesom2_tpu/io/mesh_info.py``, reading the port's
MeshTables; ``tests/test_torch_restart.py`` holds its file equal to the
JAX package's.  A partition of the nodes for ``nod_part`` comes from
``parallel/partition.py`` (``partition_nodes``).
"""
from __future__ import annotations

import os

import numpy as np

from ..mesh import MeshTables
from .netcdf import write_dataset


def write_mesh_info(path: str, mesh: MeshTables, nod_part=None,
                    elem_part=None) -> str:
    """Write fesom.mesh.diag.nc into ``path`` (a directory or a file name
    ending in .nc); returns the file's path."""
    if os.path.isdir(path) or not path.endswith(".nc"):
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, "fesom.mesh.diag.nc")
    h = lambda x: x.detach().cpu().numpy()
    N, E, Ed, nl = mesh.n_nodes, mesh.n_elems, mesh.n_edges, mesh.nl
    nie = h(mesh.nod_in_elem)
    geo = h(mesh.geo_coords)
    gsca = h(mesh.gradient_sca).astype(np.float64)
    f64 = np.float64
    dims = {"nod2": N, "edg_n": Ed, "elem": E, "nz": nl, "nz1": nl - 1,
            "n2": 2, "n3": 3, "n4": 4, "N": nie.shape[1]}
    part = lambda p, n: np.zeros(n, np.int32) if p is None \
        else np.asarray(p, np.int32)
    variables = {
        "nz": (("nz",), h(mesh.zbar).astype(f64)),
        "nz1": (("nz1",), h(mesh.Z).astype(f64)),
        "elem_area": (("elem",), h(mesh.elem_area).astype(f64)),
        "nlevels_nod2D": (("nod2",), h(mesh.nlevels_node).astype(np.int32)),
        "nlevels": (("elem",), h(mesh.nlevels_elem).astype(np.int32)),
        "nod_in_elem2D_num": (("nod2",), (nie >= 0).sum(1).astype(np.int32)),
        "nod_part": (("nod2",), part(nod_part, N)),
        "elem_part": (("elem",), part(elem_part, E)),
        "zbar_e_bottom": (("elem",), h(mesh.zbar_e_bot).astype(f64)),
        "zbar_n_bottom": (("nod2",), h(mesh.zbar_n_bot).astype(f64)),
        "lon": (("nod2",), np.degrees(geo[:, 0]).astype(f64)),
        "lat": (("nod2",), np.degrees(geo[:, 1]).astype(f64)),
        "nod_area": (("nz", "nod2"), h(mesh.area).astype(f64)),
        # 1-based connectivity like the Fortran output
        "elements": (("n3", "elem"),
                     (h(mesh.elem_nodes).T + 1).astype(np.int32)),
        "nodes": (("n2", "nod2"), np.degrees(geo).T.astype(f64)),
        "nod_in_elem2D": (("N", "nod2"), (nie.T + 1).astype(np.int32)),
        "edges": (("n2", "edg_n"), (h(mesh.edges).T + 1).astype(np.int32)),
        "edge_tri": (("n2", "edg_n"),
                     (h(mesh.edge_tri).T + 1).astype(np.int32)),
        "edge_cross_dxdy": (("n4", "edg_n"),
                            h(mesh.edge_cross_dxdy).astype(f64).T),
        "gradient_sca_x": (("n3", "elem"), gsca[:, 0:3].T),
        "gradient_sca_y": (("n3", "elem"), gsca[:, 3:6].T),
    }
    write_dataset(path, dims, variables)
    return path
