"""FPost-equivalent batch post-processor (replaces ``fpost2/``).

The reference tool (``fpost2/do_work.F90`` driven by
``fpost2/namelist.interp``) reads a run's yearly output, computes the
requested diagnostics on the native grid, interpolates them onto a
regular lon-lat grid, and writes one netCDF product per diagnostic:

- do_TS3      -> TS3: per-level T/S on the regular grid
  (``make_diag_ts3.F90:25-65``)
- do_UVnorm   -> uv_norm.nc: element speed, volume-averaged to nodes,
  regridded per level (``make_diag_uv_norm3.F90:27-79``)
- do_UVcurl   -> uv_curl.nc: relative vorticity at nodes, regridded
  (``make_diag_uv_curl3.F90``)
- do_MOC      -> moc.nc: meridional overturning from w binned by latitude
  (``make_diag_moc_w.F90``)
- make_grid_info -> grid_info.nc: regular-grid land/sea masks, cell
  areas and layer depths (``make_grid_info.F90:23-85``)

This is an offline host tool, plain numpy (kNN interpolants from
post/regrid.py), as the JAX package's ``fesom2_tpu/post/fpost.py`` of
which it is the port; the model writes levels-major [nl-1, N] streams
which map 1:1 onto the per-level loop of the reference.  It differs from
that module where the module fails:

- ``run_fpost`` reads every record of a stream and the stream's ``time``
  variable (``read_records``); the JAX driver unpacks the time mean of
  ``read_stream`` as if it were (records, times), which raises on any
  stream of more than two levels.  The products are those the product
  functions give on all records.
- ``moc.nc`` holds ``moc`` as [lat_moc, nz], the shape ``moc_z`` returns
  (the JAX writer declares it [nz = lat bins, lat_moc] and raises unless
  the mesh has as many levels as latitude bins); a product's leading axes
  are named by position (time, then depth), not by their sizes.
- Each product function searches the mesh's nearest nodes once and
  regrids every level and record with that search (the JAX functions
  search again for each level); the values are the same.

``do_UVcurl`` is parsed but not dispatched by ``run_fpost``, as in the
JAX driver; ``do_uv_curl`` regrids a curl the caller gives.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .mesh_loader import PostMesh, load_mesh
from .regrid import create_indexes_and_distances, fesom2regular, \
    regular_grid
from .moc import moc_z
from ..io.netcdf import read_vars, write_dataset

r_earth = 6371000.0


@dataclass
class FpostConfig:
    """namelist.interp analog (``fpost2/namelist.interp``)."""
    runid: str = "fesom"
    datapath: str = "./result_pi"
    outpath: str = "./result_pi"
    year_start: int = 1948
    year_end: int = 1948
    # todo
    do_TS3: bool = False
    do_UVnorm: bool = False
    do_UVcurl: bool = False
    do_MOC: bool = False
    do_grid_info: bool = False
    # regular_mesh
    LonMin: float = -180.0
    LonMax: float = 180.0
    LatMin: float = -81.0
    LatMax: float = 90.0
    RegDx: float = 2.0
    RegDy: float = 2.0


def parse_interp_namelist(path: str) -> FpostConfig:
    """Parse an fpost2-style namelist.interp (&config, &todo,
    &regular_mesh groups; mask/fesom_mesh entries are accepted and
    ignored — the mesh comes from the run's fesom.mesh.diag.nc)."""
    cfg = FpostConfig()
    with open(path) as f:
        for raw in f:
            line = raw.split("!")[0].strip().rstrip(",")
            if "=" not in line:
                continue
            key, val = (s.strip() for s in line.split("=", 1))
            tgt = {"do_mesh": None, "o2r_filename": None,
                   "use_mask": None, "mask_file": None,
                   "meshpath": None, "snap_per_year": None,
                   "rotated_grid": None, "rotated_rslt": None,
                   "alphaEuler": None, "betaEuler": None,
                   "gammaEuler": None}
            if key in tgt:
                continue
            if not hasattr(cfg, key):
                continue
            cur = getattr(cfg, key)
            if isinstance(cur, bool):
                setattr(cfg, key, val.lower() in (".true.", "t", "true"))
            elif isinstance(cur, int):
                setattr(cfg, key, int(val))
            elif isinstance(cur, float):
                setattr(cfg, key, float(val))
            else:
                setattr(cfg, key, val.strip("'\""))
    return cfg


def _reg_grid(cfg: FpostConfig):
    nx = int(round((cfg.LonMax - cfg.LonMin) / cfg.RegDx))
    ny = int(round((cfg.LatMax - cfg.LatMin) / cfg.RegDy))
    return regular_grid(nx=nx, ny=ny,
                        box=(cfg.LonMin, cfg.LonMax, cfg.LatMin, cfg.LatMax))


def _write_product(path, lons, lats, fields, zmid=None, times=None):
    """fields: {name: [.., ny, nx]} arrays; the leading axes are time
    (where ``times`` is given), then depth (where ``zmid`` is given and
    the size matches), then axes of their own."""
    dims = {"lon": lons.shape[1], "lat": lats.shape[0]}
    variables = {"lon": (("lon",), lons[0, :]),
                 "lat": (("lat",), lats[:, 0])}
    if zmid is not None:
        dims["depth"] = len(zmid)
        variables["depth"] = (("depth",), np.asarray(zmid))
    if times is not None:
        dims["time"] = len(times)
        variables["time"] = (("time",), np.asarray(times, np.float64))
    for name, arr in fields.items():
        arr = np.asarray(arr)
        lead = list(arr.shape[:-2])
        dn = []
        if times is not None and lead and lead[0] == len(times):
            dn.append("time")
            lead.pop(0)
        if zmid is not None and lead and lead[0] == len(zmid):
            dn.append("depth")
            lead.pop(0)
        for k, n in enumerate(lead):
            dims[f"{name}_d{k}"] = n
            dn.append(f"{name}_d{k}")
        variables[name] = (tuple(dn) + ("lat", "lon"), arr)
    write_dataset(path, dims, variables)


def _nearest(mesh: PostMesh, lons, lats):
    """The nearest mesh node of each grid point (one search for all the
    levels and records of a product)."""
    return create_indexes_and_distances(mesh.x2, mesh.y2, lons, lats, k=1)


def _regrid_rows(a, mesh: PostMesh, lons, lats, dist_ind):
    """Nearest-neighbour regrid of every row of a [.., N] field:
    [.., ny, nx], NaN beyond the influence radius."""
    a = np.asarray(a)
    lead = a.shape[:-1]
    flat = a.reshape(-1, a.shape[-1])
    out = np.stack([np.ma.filled(fesom2regular(f, mesh, lons, lats,
                                               how="nn", dist_ind=dist_ind),
                                 np.nan) for f in flat])
    return out.reshape(lead + lons.shape)


def elem_to_node_volume_mean(field_e, mesh: PostMesh):
    """Element field [.., E] -> node field [.., N] by triangle-volume
    weighting (the vol accumulation of make_diag_uv_norm3.F90:43-48)."""
    en = mesh.elem
    w = mesh.elem_area
    vol = np.zeros(mesh.n2d)
    np.add.at(vol, en[:, 0], w)
    np.add.at(vol, en[:, 1], w)
    np.add.at(vol, en[:, 2], w)
    out = np.zeros(field_e.shape[:-1] + (mesh.n2d,))
    wf = field_e * w
    for v in range(3):
        np.add.at(out, (..., en[:, v]), wf)
    return out / np.maximum(vol, 1e-30)


def make_grid_info(mesh: PostMesh, cfg: FpostConfig,
                   out: Optional[str] = None):
    """Regular-grid land/sea masks, areas, mid depths
    (``make_grid_info.F90:23-85``): 2D mask from regridding 1, 3D mask
    from regridding per-level wet indicators, area2 = dx*dy*cos(lat),
    area3 = area2*layer thickness, deps3 = layer mid depth."""
    lons, lats = _reg_grid(cfg)
    di = _nearest(mesh, lons, lats)
    ones = np.ones(mesh.n2d)
    r = fesom2regular(ones, mesh, lons, lats, how="nn", dist_ind=di)
    mask2 = (np.ma.filled(r, 0.0) > 0.5).astype(np.int32)

    nl = len(mesh.zlev)
    mask3 = np.zeros((nl - 1,) + lons.shape, np.int32)
    for k in range(2, nl + 1):
        wet = (mesh.nlevels_nod2D >= k).astype(np.float64)
        rk = fesom2regular(wet, mesh, lons, lats, how="nn", dist_ind=di)
        mask3[k - 2] = (np.ma.filled(rk, 0.0) > 0.9).astype(np.int32)

    scos = np.cos(np.deg2rad(lats))
    dx = np.deg2rad(cfg.RegDx) * r_earth
    dy = np.deg2rad(cfg.RegDy) * r_earth
    area2 = (dx * dy * scos) * mask2
    zlev = np.abs(np.asarray(mesh.zlev))
    deps3 = 0.5 * (zlev[1:] + zlev[:-1])[:, None, None] * mask3
    area3 = area2[None] * np.abs(zlev[1:] - zlev[:-1])[:, None, None] * mask3

    fields = dict(mask2=mask2, mask3=mask3, area2=area2, area3=area3,
                  deps3=deps3)
    if out:
        _write_product(os.path.join(out, "grid_info.nc"), lons, lats,
                       fields, zmid=mesh.zmid)
    return fields


def do_ts3(mesh: PostMesh, cfg: FpostConfig, T, S,
           out: Optional[str] = None, times=None):
    """Per-level regrid of hydrography [.., nl-1, N]
    (``make_diag_ts3.F90:25-65``)."""
    lons, lats = _reg_grid(cfg)
    di = _nearest(mesh, lons, lats)
    per_level = lambda a: _regrid_rows(a, mesh, lons, lats, di)
    fields = {"temp": per_level(T), "salt": per_level(S)}
    if out:
        _write_product(os.path.join(out, "TS3.nc"), lons, lats, fields,
                       zmid=mesh.zmid, times=times)
    return fields


def do_uv_norm(mesh: PostMesh, cfg: FpostConfig, u, v,
               out: Optional[str] = None, times=None):
    """|u| on elements -> volume-weighted node mean -> regrid
    (``make_diag_uv_norm3.F90:27-79``)."""
    lons, lats = _reg_grid(cfg)
    speed_e = np.sqrt(np.asarray(u) ** 2 + np.asarray(v) ** 2)
    speed_n = elem_to_node_volume_mean(speed_e, mesh)
    reg = _regrid_rows(speed_n, mesh, lons, lats, _nearest(mesh, lons, lats))
    if out:
        _write_product(os.path.join(out, "uv_norm.nc"), lons, lats,
                       {"uv_norm": reg}, zmid=mesh.zmid, times=times)
    return reg


def do_uv_curl(mesh: PostMesh, cfg: FpostConfig, curl_n,
               out: Optional[str] = None, times=None):
    """Regrid node relative vorticity [.., nl-1, N]
    (``make_diag_uv_curl3.F90``; the native-grid curl itself is the
    model diagnostic core/diagnostics.curl_vel3)."""
    lons, lats = _reg_grid(cfg)
    reg = _regrid_rows(curl_n, mesh, lons, lats, _nearest(mesh, lons, lats))
    if out:
        _write_product(os.path.join(out, "uv_curl.nc"), lons, lats,
                       {"uv_curl": reg}, zmid=mesh.zmid, times=times)
    return reg


def do_moc(mesh: PostMesh, cfg: FpostConfig, w,
           out: Optional[str] = None):
    """MOC streamfunction from w (``make_diag_moc_w.F90``), via the
    latitude-binned area integral (post/moc.moc_z)."""
    lat_bins = np.arange(cfg.LatMin, cfg.LatMax + 1e-9, cfg.RegDy)
    area_surf = mesh.area[0] if mesh.area.ndim == 2 else mesh.area
    lats, mocv = moc_z(np.asarray(w), area_surf, mesh.y2,
                       lat_bins=lat_bins)
    if out:
        dims = {"lat_moc": len(lats), "nz": mocv.shape[1]}
        variables = {"lat_moc": (("lat_moc",), lats),
                     "moc": (("lat_moc", "nz"), mocv)}
        if mocv.shape[1] == len(mesh.zlev):
            variables["nz"] = (("nz",), np.asarray(mesh.zlev, np.float64))
        write_dataset(os.path.join(out, "moc.nc"), dims, variables)
    return lats, mocv


def read_records(result_path: str, name: str, year: int,
                 runid: str = "fesom"):
    """Every record of a stream file and its time axis:
    (data [T, ...], time [T])."""
    path = os.path.join(result_path, f"{name}.{runid}.{year}.nc")
    v = read_vars(path, [name, "time"])
    return v[name], v["time"]


def run_fpost(cfg: FpostConfig, mesh: Optional[PostMesh] = None) -> List[str]:
    """The do_work.F90 driver: read yearly streams, run the enabled
    diagnostics, write products into cfg.outpath.  Returns the written
    product names."""
    if mesh is None:
        mesh = load_mesh(cfg.datapath)
    os.makedirs(cfg.outpath, exist_ok=True)
    written = []
    if cfg.do_grid_info:
        make_grid_info(mesh, cfg, out=cfg.outpath)
        written.append("grid_info.nc")
    for year in range(cfg.year_start, cfg.year_end + 1):
        if cfg.do_TS3:
            T, t = read_records(cfg.datapath, "temp", year, cfg.runid)
            S, _ = read_records(cfg.datapath, "salt", year, cfg.runid)
            do_ts3(mesh, cfg, T, S, out=cfg.outpath, times=t)
            written.append("TS3.nc")
        if cfg.do_UVnorm:
            u, t = read_records(cfg.datapath, "u", year, cfg.runid)
            v, _ = read_records(cfg.datapath, "v", year, cfg.runid)
            do_uv_norm(mesh, cfg, u, v, out=cfg.outpath, times=t)
            written.append("uv_norm.nc")
        if cfg.do_MOC:
            w, _ = read_records(cfg.datapath, "w", year, cfg.runid)
            do_moc(mesh, cfg, w.mean(0), out=cfg.outpath)
            written.append("moc.nc")
    return written


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="FPost-equivalent regridding "
                                            "post-processor")
    p.add_argument("namelist", help="namelist.interp-style config")
    args = p.parse_args(argv)
    cfg = parse_interp_namelist(args.namelist)
    written = run_fpost(cfg)
    print("fpost products:", ", ".join(written))


if __name__ == "__main__":
    main()
