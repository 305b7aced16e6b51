# Frozen copy of fesom2_tpu_torch/mesh/channel.py, lines 1-99 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""A periodic zonal channel mesh built in code, in the FESOM ASCII format.

It stands in for the soufflet channel mesh of the reference distribution
(``test/meshes/soufflet``), which is not part of this repository.  The
geometry follows the soufflet configuration: cyclic in longitude over
``cyclic_length`` = 4.5 degrees, latitude from 0 to YSIZE/r_earth
(YSIZE = 2000 km, ``toy/soufflet.py``), a flat bottom at ZSIZE = 4000 m.

Nodes sit on ``ny`` rows of ``nx`` nodes, every other row offset by half a
cell, so the triangles are close to equilateral.  Triangles are stored
CLOCKWISE in (lon, lat), the order of the FESOM mesh files: with
counter-clockwise triangles the assembled SSH operator
(``core/ssh.ssh_dense_matrix``) is indefinite and the step blows up.

The vertical grid (``n_layers`` layers of ``dz`` metres) is a choice of
this constructor: the reference's soufflet levels are not in the repository.
No node depths are written, so every column is full depth.
"""
from __future__ import annotations

import os

import numpy as np

from ..constants import rad, r_earth
from .io import RawMesh

# soufflet channel extent (toy/soufflet.py YSIZE; model.py cyclic_length)
CHANNEL_LAT_EXTENT = 2000000.0 / r_earth       # radians
CHANNEL_WIDTH_DEG = 4.5


def channel_raw_mesh(nx: int = 25, ny: int = 115, n_layers: int = 40,
                     dz: float = 100.0,
                     width_deg: float = CHANNEL_WIDTH_DEG,
                     lat_extent: float = CHANNEL_LAT_EXTENT) -> RawMesh:
    """The channel as a RawMesh (what ``io.read_raw_mesh`` returns for the
    files ``write_mesh`` writes)."""
    dx = width_deg / nx
    dy = lat_extent / rad / (ny - 1)
    j, i = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    lon = (i + 0.5 * (j % 2)) * dx
    lat = j * dy
    coords_deg = np.stack([lon.ravel(), lat.ravel()], axis=1)

    node = lambda ii, jj: jj * nx + (ii % nx)
    tris = []
    for jj in range(ny - 1):
        ii = np.arange(nx)
        if jj % 2 == 0:      # row jj unshifted, row jj+1 shifted right
            tris.append(np.stack([node(ii, jj), node(ii + 1, jj),
                                  node(ii, jj + 1)], 1))
            tris.append(np.stack([node(ii + 1, jj), node(ii + 1, jj + 1),
                                  node(ii, jj + 1)], 1))
        else:                # row jj shifted right, row jj+1 unshifted
            tris.append(np.stack([node(ii, jj), node(ii + 1, jj),
                                  node(ii + 1, jj + 1)], 1))
            tris.append(np.stack([node(ii, jj), node(ii + 1, jj + 1),
                                  node(ii, jj + 1)], 1))
    elem_nodes = np.concatenate(tris, 0).astype(np.int64)

    # make every triangle clockwise in (lon, lat), across the cyclic seam
    def trim(d):
        d = np.where(d > width_deg / 2, d - width_deg, d)
        return np.where(d < -width_deg / 2, d + width_deg, d)
    p = coords_deg[elem_nodes]
    cross = trim(p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1]) \
        - trim(p[:, 2, 0] - p[:, 0, 0]) * (p[:, 1, 1] - p[:, 0, 1])
    ccw = cross > 0
    elem_nodes[ccw] = elem_nodes[ccw][:, [0, 2, 1]]

    node_flag = np.where((j.ravel() == 0) | (j.ravel() == ny - 1), 1,
                         0).astype(np.int32)
    zbar = -dz * np.arange(n_layers + 1, dtype=np.float64) + 0.0  # no -0.0
    return RawMesh(coords_deg=coords_deg, coords=coords_deg * rad,
                   node_flag=node_flag, elem_nodes=elem_nodes, zbar=zbar,
                   depth=None, nlevels_elem=None, nlevels_node=None,
                   edges=None, edge_tri=None, edge2D_in=None)


def write_mesh(raw: RawMesh, path: str) -> str:
    """Write ``nod2d.out``, ``elem2d.out`` and ``aux3d.out`` into ``path``
    (created if missing).  Coordinates are written with 17 significant
    digits, so reading them back gives the same doubles."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "nod2d.out"), "w") as fh:
        fh.write(f"{raw.n_nodes}\n")
        for k, ((lon, lat), flag) in enumerate(zip(raw.coords_deg,
                                                   raw.node_flag)):
            fh.write(f"{k + 1} {lon:.17g} {lat:.17g} {int(flag)}\n")
    with open(os.path.join(path, "elem2d.out"), "w") as fh:
        fh.write(f"{raw.n_elems}\n")
        for a, b, c in raw.elem_nodes + 1:
            fh.write(f"{a} {b} {c}\n")
    with open(os.path.join(path, "aux3d.out"), "w") as fh:
        fh.write(f"{raw.nl}\n")
        for z in raw.zbar:
            fh.write(f"{z:.17g}\n")
    return path
