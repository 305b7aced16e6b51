# Frozen copy of fesom2_tpu_torch/mesh/refine.py, lines 1-116 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""Uniform 4-way mesh refinement: each triangle split at its edge
midpoints.

The port of ``fesom2_tpu/mesh/refine.py`` (numpy, on the host).  The old
nodes keep their numbers; the midpoints follow in the order of the
sorted unique edges (``np.unique``), and the four children of element e
are e's corner triangles at rows e, E + e, 2 E + e and its central one at
3 E + e.  Nothing is renumbered along the globe's curve: a refined mesh
is numbered as the JAX package numbers it.  A child keeps its parent's
vertex order, so clockwise parents give clockwise children.

Level counts and drafts are carried conservatively: a midpoint takes the
smaller level count of its edge's ends (FESOM's rule that an element's
levels are the minimum over its vertices, ``oce_mesh.F90`` find_levels),
its depth the mean of theirs, and its cavity draft the mean where both
ends lie under the shelf, else 0.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .io import RawMesh, read_raw_mesh
from .tables import MeshTables, build_mesh_from_raw


def _mid_lonlat(a, b, cyclic_rad):
    """Midpoint of two lon/lat pairs [., 2] (radians), across the seam."""
    dlon = np.remainder(b[:, 0] - a[:, 0] + 0.5 * cyclic_rad, cyclic_rad) \
        - 0.5 * cyclic_rad
    lon = a[:, 0] + 0.5 * dlon
    lat = 0.5 * (a[:, 1] + b[:, 1])
    return np.stack([lon, lat], 1)


def subdivide_raw(raw: RawMesh, cyclic_length_deg: float = 360.0) -> RawMesh:
    """One 4-way refinement of a RawMesh."""
    coords = raw.coords
    en = raw.elem_nodes
    N = raw.n_nodes
    cyc = np.deg2rad(cyclic_length_deg)

    # the unique edges of the element list
    pairs = np.concatenate([en[:, [0, 1]], en[:, [1, 2]], en[:, [2, 0]]])
    pairs = np.sort(pairs, axis=1)
    uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
    inv = inv.ravel()
    Ed = uniq.shape[0]
    mid_id = N + np.arange(Ed)

    mid = _mid_lonlat(coords[uniq[:, 0]], coords[uniq[:, 1]], cyc)
    new_coords = np.concatenate([coords, mid])
    mid_deg = _mid_lonlat(np.deg2rad(raw.coords_deg[uniq[:, 0]]),
                          np.deg2rad(raw.coords_deg[uniq[:, 1]]), cyc)
    new_coords_deg = np.concatenate([raw.coords_deg, np.rad2deg(mid_deg)])

    # a midpoint is on the boundary only if its edge is (one element)
    on_boundary = np.bincount(inv, minlength=Ed) == 1
    bflag = raw.node_flag[uniq[:, 0]] * raw.node_flag[uniq[:, 1]]
    new_flag = np.concatenate([raw.node_flag,
                               np.where(on_boundary, np.maximum(bflag, 1),
                                        0).astype(raw.node_flag.dtype)])

    # children: the three corner triangles, then the central one
    E = en.shape[0]
    m01 = mid_id[inv[0 * E:1 * E]]
    m12 = mid_id[inv[1 * E:2 * E]]
    m20 = mid_id[inv[2 * E:3 * E]]
    new_en = np.concatenate([
        np.stack([en[:, 0], m01, m20], 1),
        np.stack([en[:, 1], m12, m01], 1),
        np.stack([en[:, 2], m20, m12], 1),
        np.stack([m01, m12, m20], 1)])

    new_depth = None
    if raw.depth is not None:
        d = raw.depth
        new_depth = np.concatenate([d, 0.5 * (d[uniq[:, 0]] + d[uniq[:, 1]])])

    new_nlev_n = new_nlev_e = None
    if raw.nlevels_node is not None:
        nlev = raw.nlevels_node
        new_nlev_n = np.concatenate(
            [nlev, np.minimum(nlev[uniq[:, 0]], nlev[uniq[:, 1]])])
        new_nlev_e = new_nlev_n[new_en].min(1)

    new_cav = None
    if raw.cavity_depth is not None:
        cav = raw.cavity_depth
        a, b = cav[uniq[:, 0]], cav[uniq[:, 1]]
        new_cav = np.concatenate(
            [cav, np.where((a < 0) & (b < 0), 0.5 * (a + b), 0.0)])

    return dataclasses.replace(
        raw, coords=new_coords, coords_deg=new_coords_deg,
        node_flag=new_flag, elem_nodes=new_en, depth=new_depth,
        nlevels_node=new_nlev_n, nlevels_elem=new_nlev_e,
        edges=None, edge_tri=None, edge2D_in=None, cavity_depth=new_cav,
        path=raw.path + "+refined")


def refined_mesh(path: str, n_refine: int = 1, *, force_rotation=False,
                 cyclic_length_deg: float = 360.0, dtype=torch.float64,
                 device, **kw) -> MeshTables:
    """Read a mesh directory (with its ``cavity_depth.out``, if it has
    one), refine it ``n_refine`` times and build the tables on
    ``device``; ``kw`` go to ``build_mesh_from_raw`` (the partial
    cells)."""
    raw = read_raw_mesh(path, force_rotation=force_rotation)
    for _ in range(n_refine):
        raw = subdivide_raw(raw, cyclic_length_deg)
    return build_mesh_from_raw(raw, force_rotation=force_rotation,
                               cyclic_length_deg=cyclic_length_deg,
                               dtype=dtype, device=device, **kw)
