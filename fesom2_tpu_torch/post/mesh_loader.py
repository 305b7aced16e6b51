"""Post-processing mesh/result loaders (replaces
``view/modules/load_mesh_data.py``: load_mesh :28-160, ind_for_depth :267,
read_fesom_slice :288, cut_region :359).

Reads either a raw FESOM mesh directory (nod2d.out/elem2d.out/aux3d.out) or
the ``fesom.mesh.diag.nc`` a run writes; result data comes from the
per-stream ``{name}.{runid}.{year}.nc`` files.

The port's own copy of ``fesom2_tpu/post/mesh_loader.py`` (host numpy):
files are read through the port's ``io/netcdf.py`` and a raw mesh
directory is built by the port's ``mesh.build_mesh`` on the CPU.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..io.netcdf import read_vars


@dataclass
class PostMesh:
    x2: np.ndarray          # lon (deg, geographic)
    y2: np.ndarray          # lat (deg)
    elem: np.ndarray        # [E,3] 0-based
    zlev: np.ndarray        # [nl] level depths
    zmid: np.ndarray        # [nl-1] layer mid depths
    nlevels_nod2D: np.ndarray
    nlevels_elem: np.ndarray
    area: np.ndarray        # [nl, N] scalar cell areas
    elem_area: np.ndarray

    @property
    def n2d(self):
        return self.x2.shape[0]

    @property
    def e2d(self):
        return self.elem.shape[0]


def load_mesh(path: str, abg=(50, 15, -90)) -> PostMesh:
    """Load a mesh for post-processing.

    `path` may be a run result directory (containing fesom.mesh.diag.nc),
    the diag file itself, or a raw mesh directory (then `abg` Euler angles
    rotate to geographic coordinates, like the reference default 50/15/-90).
    """
    diag = path
    if os.path.isdir(path):
        cand = os.path.join(path, "fesom.mesh.diag.nc")
        if os.path.exists(cand):
            diag = cand
        else:
            return _load_raw(path, abg)
    v = read_vars(diag, ["lon", "lat", "elements", "nz", "nz1",
                         "nlevels_nod2D", "nlevels", "nod_area", "elem_area"])
    return PostMesh(x2=v["lon"], y2=v["lat"],
                    elem=v["elements"].T.astype(np.int64) - 1,
                    zlev=v["nz"], zmid=v["nz1"],
                    nlevels_nod2D=v["nlevels_nod2D"],
                    nlevels_elem=v["nlevels"],
                    area=v["nod_area"], elem_area=v["elem_area"])


def _load_raw(path: str, abg):
    from ..mesh import build_mesh
    m = build_mesh(path, force_rotation=True, device="cpu")
    h = lambda x: x.numpy()
    geo = np.degrees(h(m.geo_coords))
    return PostMesh(x2=geo[:, 0], y2=geo[:, 1],
                    elem=h(m.elem_nodes),
                    zlev=h(m.zbar), zmid=h(m.Z),
                    nlevels_nod2D=h(m.nlevels_node),
                    nlevels_elem=h(m.nlevels_elem),
                    area=h(m.area),
                    elem_area=h(m.elem_area))


def ind_for_depth(depth: float, mesh: PostMesh) -> int:
    """Index of the model layer closest to `depth` (positive metres;
    ref ind_for_depth :267-287)."""
    return int(np.argmin(np.abs(np.abs(mesh.zmid) - abs(depth))))


def read_stream(result_path: str, name: str, year: int, runid: str = "fesom",
                records="mean", how: str = "mean"):
    """Read a stream file; `records`='mean'/'all'/index/slice
    (ref read_fesom_slice :288-320)."""
    path = os.path.join(result_path, f"{name}.{runid}.{year}.nc")
    data = read_vars(path, [name])[name]
    if records == "all":
        return data
    if records == "mean" or (records is None):
        sel = data
    elif isinstance(records, (int, slice)):
        sel = data[records]
        if isinstance(records, int):
            return sel
    else:
        sel = data[np.asarray(records)]
    if how == "mean":
        return sel.mean(0)
    if how == "max":
        return sel.max(0)
    if how == "min":
        return sel.min(0)
    raise ValueError(how)


def cut_region(mesh: PostMesh, box=(13, 30, 53, 66)):
    """Element indices fully inside [lonmin, lonmax, latmin, latmax]
    (ref cut_region :359-…)."""
    lomin, lomax, lamin, lamax = box
    xe = mesh.x2[mesh.elem]
    ye = mesh.y2[mesh.elem]
    keep = ((xe >= lomin) & (xe <= lomax)
            & (ye >= lamin) & (ye <= lamax)).all(-1)
    return np.nonzero(keep)[0]
