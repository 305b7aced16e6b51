"""Climatology loading + model-vs-climatology comparison (replaces
``view/modules/climatology.py`` climatology class :59-155 and
regriding.fesom2clim :120-158).

The port's own copy of ``fesom2_tpu/post/climatology.py``, reading through
the port's ``io/netcdf.py``.
"""
from __future__ import annotations

import numpy as np

from ..io.netcdf import read_vars, list_vars
from .regrid import create_indexes_and_distances, fesom2regular


class Climatology:
    """WOA-style gridded T/S climatology ([depth, lat, lon] netCDF)."""

    def __init__(self, path: str, t_name=None, s_name=None):
        names = list_vars(path)
        def pick(cands):
            for c in cands:
                if c in names:
                    return c
            return None
        t_name = t_name or pick(["t00an1", "temperature", "temp", "T"])
        s_name = s_name or pick(["s00an1", "salinity", "salt", "S"])
        lon_n = pick(["lon", "longitude", "x"])
        lat_n = pick(["lat", "latitude", "y"])
        dep_n = pick(["depth", "lev", "z"])
        v = read_vars(path, [n for n in (t_name, s_name, lon_n, lat_n, dep_n)
                             if n])
        self.T = np.squeeze(v.get(t_name))
        self.S = np.squeeze(v.get(s_name))
        self.x = v[lon_n]
        self.y = v[lat_n]
        self.z = v[dep_n]
        for f in ("T", "S"):
            a = getattr(self, f)
            if a is not None:
                a = np.where(np.abs(a) > 1e10, np.nan, a)
                setattr(self, f, a)


def fesom2clim(data3d, mesh, clim: Climatology, field="T", how="nn",
               radius_of_influence=500000.0):
    """Interpolate model layers onto the climatology grid at the
    climatology's depths and return (model_on_clim, clim_field, bias)
    (ref fesom2clim :120-158)."""
    glon, glat = np.meshgrid(clim.x, clim.y)
    di = create_indexes_and_distances(mesh.x2, mesh.y2, glon, glat, k=1)
    cf = getattr(clim, field)
    out_model = np.full_like(cf, np.nan, dtype=float)
    zmid = np.abs(mesh.zmid)
    for k, d in enumerate(np.abs(clim.z)):
        il = int(np.argmin(np.abs(zmid - d)))
        lay = np.asarray(data3d[il], float).copy()
        lay[mesh.nlevels_nod2D - 1 <= il] = np.nan
        out_model[k] = fesom2regular(lay, mesh, glon, glat, dist_ind=di,
                                     radius_of_influence=radius_of_influence)
    bias = out_model - cf
    return out_model, cf, bias
