"""Readers for the FESOM2 ASCII mesh format.

File formats (reference: ``src/oce_mesh.F90:147-697`` read_mesh, ``:699-893``
find_levels, ``:1419-1648`` load_edges; sample data ``test/meshes/pi``):

- ``nod2d.out``:  first line = node count N; then ``idx lon_deg lat_deg flag``.
- ``elem2d.out``: first line = element count E; then 3 one-based node indices.
- ``aux3d.out``:  first line = level count nl; then nl level depths ``zbar``
  (non-positive, descending); then N node depths (may be absent for toy meshes).
- ``elvls.out`` / ``nlvls.out``: per-element / per-node number of active levels.
- ``edgenum.out``: total edge count, then internal edge count.
- ``edges.out``: 2 one-based node indices per edge.
- ``edge_tri.out``: 2 one-based element indices per edge (second <= 0 on boundary).

All indices are converted to 0-based; missing neighbors become -1.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..constants import rad
from .rotation import rotation_matrix, g2r


@dataclass
class RawMesh:
    """Mesh exactly as read from disk (host-side, numpy, global numbering)."""
    coords_deg: np.ndarray          # [N,2] lon/lat in degrees as stored on disk
    coords: np.ndarray              # [N,2] lon/lat radians (rotated frame if force_rotation)
    node_flag: np.ndarray           # [N] boundary index column of nod2d.out
    elem_nodes: np.ndarray          # [E,3] 0-based
    zbar: np.ndarray                # [nl] level depths (<=0, descending)
    depth: Optional[np.ndarray]     # [N] bottom depth at nodes (None for toy meshes)
    nlevels_elem: Optional[np.ndarray]   # [E] number of active levels per element
    nlevels_node: Optional[np.ndarray]   # [N]
    edges: Optional[np.ndarray]          # [Ed,2] 0-based node pairs
    edge_tri: Optional[np.ndarray]       # [Ed,2] 0-based elems, -1 if absent
    edge2D_in: Optional[int]             # number of internal edges
    # ice-shelf cavity draft per node (<0 under a shelf, 0 in open ocean;
    # ref cavity_depth.out read in fvom_init.F90:224-270)
    cavity_depth: Optional[np.ndarray] = None
    path: str = ""

    @property
    def n_nodes(self) -> int:
        return self.coords.shape[0]

    @property
    def n_elems(self) -> int:
        return self.elem_nodes.shape[0]

    @property
    def nl(self) -> int:
        return self.zbar.shape[0]


def _read_table(path: str, skip_first: bool = True) -> np.ndarray:
    with open(path) as fh:
        lines = fh.read().split("\n")
    start = 1 if skip_first else 0
    rows = [ln.split() for ln in lines[start:] if ln.strip()]
    return np.array([[float(v) for v in r] for r in rows])


def read_raw_mesh(path: str, force_rotation: bool = False,
                  alpha: float = 50.0, beta: float = 15.0, gamma: float = -90.0,
                  cyclic_length_deg: float = 360.0) -> RawMesh:
    """Read nod2d/elem2d/aux3d(+elvls/nlvls/edges if present) from `path`."""
    nod = _read_table(os.path.join(path, "nod2d.out"))
    coords_deg = nod[:, 1:3].astype(np.float64)
    node_flag = nod[:, 3].astype(np.int32)
    n_nodes = coords_deg.shape[0]

    elem = _read_table(os.path.join(path, "elem2d.out"))
    elem_nodes = elem[:, 0:3].astype(np.int64) - 1

    # aux3d: nl, zbar(nl), then optionally node depths
    with open(os.path.join(path, "aux3d.out")) as fh:
        tokens = fh.read().split()
    nl = int(tokens[0])
    vals = np.array([float(t) for t in tokens[1:]])
    zbar = vals[:nl]
    if zbar[1] > 0:  # depths may be stored positive-down
        zbar = -zbar
    depth = None
    if vals.size >= nl + n_nodes:
        depth = vals[nl:nl + n_nodes]
        if np.nanmean(depth) > 0:
            depth = -depth

    def _opt_int(name):
        p = os.path.join(path, name)
        if os.path.exists(p):
            return _read_table(p, skip_first=False).astype(np.int64).ravel()
        return None

    nlev_e = _opt_int("elvls.out")
    nlev_n = _opt_int("nlvls.out")

    edges = edge_tri = None
    edge2D_in = None
    epath = os.path.join(path, "edgenum.out")
    if os.path.exists(epath):
        with open(epath) as fh:
            edge2D = int(fh.readline())
            edge2D_in = int(fh.readline())
        edges = _read_table(os.path.join(path, "edges.out"),
                            skip_first=False).astype(np.int64) - 1
        edge_tri = _read_table(os.path.join(path, "edge_tri.out"),
                               skip_first=False).astype(np.int64) - 1
        edge_tri[edge_tri < 0] = -1
        assert edges.shape[0] == edge2D

    # ice-shelf draft (ref read_mesh_cavity, fvom_init.F90:224-270)
    cavity_depth = None
    cpath = os.path.join(path, "cavity_depth.out")
    if os.path.exists(cpath):
        cavity_depth = _read_table(cpath, skip_first=False).astype(
            np.float64).ravel()
        if np.nanmean(cavity_depth) > 0:
            cavity_depth = -cavity_depth

    coords = coords_deg * rad
    if force_rotation:
        m = rotation_matrix(alpha, beta, gamma)
        rlon, rlat = g2r(coords[:, 0], coords[:, 1], m)
        coords = np.stack([rlon, rlat], axis=1)

    return RawMesh(coords_deg=coords_deg, coords=coords, node_flag=node_flag,
                   elem_nodes=elem_nodes, zbar=np.asarray(zbar, np.float64),
                   depth=depth, nlevels_elem=nlev_e, nlevels_node=nlev_n,
                   edges=edges, edge_tri=edge_tri, edge2D_in=edge2D_in,
                   cavity_depth=cavity_depth, path=path)
