# Frozen copy of fesom2_tpu_torch/parallel/padding.py, lines 1-104 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""Pad a mesh's entity counts to a multiple of the device count.

The port of ``fesom2_tpu/parallel/padding.py``.  Dummy entities are built
so that every masked formulation ignores them: dummy elements have no
active layer (nlevels 1), dummy edges join a dummy node to itself and
point at a dummy element (both adjacent layer masks false), and dummy
nodes have zero area and one level.  The kernels' tables of the padded
mesh (``mesh/cluster.py``) are built anew from its fields.

The analog of the reference's per-rank halo padding (eDim/eXDim arrays,
``gen_modules_partitioning.F90:62-67``): fixed shapes, inactive entries
masked.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mesh import MeshTables
from ..mesh.cluster import build_cluster_tables


def _pad(arr, n_extra, fill, axis=-1):
    a = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) \
        else np.asarray(arr)
    if n_extra == 0:
        return a.copy()
    pad_shape = list(a.shape)
    pad_shape[axis] = n_extra
    return np.concatenate([a, np.full(pad_shape, fill, a.dtype)], axis=axis)


def pad_mesh(mesh: MeshTables, multiple: int) -> MeshTables:
    """A MeshTables with N, E and Ed rounded up to ``multiple`` (the mesh
    itself where they are multiples already)."""
    def up(n):
        return (-(-n // multiple)) * multiple

    N, E, Ed = mesh.n_nodes, mesh.n_elems, mesh.n_edges
    Np, Ep, Edp = up(N), up(E), up(Ed)
    dn, de, dd = Np - N, Ep - E, Edp - Ed
    if dn == de == dd == 0:
        return mesh

    dummy_node = N          # first padded node
    dummy_elem = E

    r = {}
    # topology
    r["elem_nodes"] = _pad(mesh.elem_nodes, de, dummy_node, axis=0)
    r["edges"] = _pad(mesh.edges, dd, dummy_node, axis=0)
    et = _pad(mesh.edge_tri, dd, -1, axis=0)
    if dd:
        et[Ed:, 0] = dummy_elem if de > 0 else 0   # must be a masked element
    r["edge_tri"] = et
    r["elem_neighbors"] = _pad(mesh.elem_neighbors, de, -1, axis=0)
    r["elem_edges"] = _pad(mesh.elem_edges, de, Ed if dd else 0, axis=0)
    r["nod_in_elem"] = _pad(mesh.nod_in_elem, dn, -1, axis=0)
    r["nod_in_elem_num"] = _pad(mesh.nod_in_elem_num, dn, 0)
    r["nod_in_elem_slot"] = _pad(mesh.nod_in_elem_slot, dn, 0, axis=0)
    r["node_edges"] = _pad(mesh.node_edges, dn, -1, axis=0)
    r["node_edge_sign"] = _pad(mesh.node_edge_sign, dn, 0.0, axis=0)
    r["node_neighbors"] = _pad(mesh.node_neighbors, dn, -1, axis=0)
    # coordinates
    r["coords"] = _pad(mesh.coords, dn, 0.0, axis=0)
    r["geo_coords"] = _pad(mesh.geo_coords, dn, 0.0, axis=0)
    # geometry
    r["elem_area"] = _pad(mesh.elem_area, de, 0.0)
    for name in ("area", "areasvol", "area_inv", "areasvol_inv"):
        r[name] = _pad(getattr(mesh, name), dn, 0.0, axis=1)
    r["resolution"] = _pad(mesh.resolution, dn, 1.0)
    r["edge_dxdy"] = _pad(mesh.edge_dxdy, dd, 0.0, axis=0)
    r["edge_cross_dxdy"] = _pad(mesh.edge_cross_dxdy, dd, 0.0, axis=0)
    r["gradient_sca"] = _pad(mesh.gradient_sca, de, 0.0, axis=0)
    r["gradient_vec"] = _pad(mesh.gradient_vec, de, 0.0, axis=0)
    r["elem_cos"] = _pad(mesh.elem_cos, de, 1.0)
    r["metric_factor"] = _pad(mesh.metric_factor, de, 0.0)
    r["coriolis"] = _pad(mesh.coriolis, de, 0.0)
    r["coriolis_node"] = _pad(mesh.coriolis_node, dn, 0.0)
    # vertical structure
    r["zbar_e_bot"] = _pad(mesh.zbar_e_bot, de, 0.0)
    r["zbar_n_bot"] = _pad(mesh.zbar_n_bot, dn, 0.0)
    r["bottom_elem_thickness"] = _pad(mesh.bottom_elem_thickness, de, 0.0)
    r["bottom_node_thickness"] = _pad(mesh.bottom_node_thickness, dn, 0.0)
    r["nlevels_elem"] = _pad(mesh.nlevels_elem, de, 1)
    r["nlevels_node"] = _pad(mesh.nlevels_node, dn, 1)
    r["ulevels_elem"] = _pad(mesh.ulevels_elem, de, 1)
    r["ulevels_node"] = _pad(mesh.ulevels_node, dn, 1)
    r["elem_layer_mask"] = _pad(mesh.elem_layer_mask, de, False, axis=1)
    r["node_layer_mask"] = _pad(mesh.node_layer_mask, dn, False, axis=1)
    nlm = _pad(mesh.node_level_mask, dn, False, axis=1)
    if dn:
        nlm[0, N:] = True      # one surface level so a gather stays in range
    r["node_level_mask"] = nlm
    r["bc_index_node"] = _pad(mesh.bc_index_node, dn, 0.0)

    dev = mesh.zbar.device
    kw = {k: torch.as_tensor(v, device=dev).to(getattr(mesh, k).dtype)
          for k, v in r.items()}
    padded = dataclasses.replace(mesh, n_nodes=Np, n_elems=Ep, n_edges=Edp,
                                 cluster=None, **kw)
    return dataclasses.replace(padded, cluster=build_cluster_tables(padded))
