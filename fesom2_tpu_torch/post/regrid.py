"""Unstructured-mesh -> regular-grid interpolation (replaces
``view/modules/regriding.py``: lon_lat_to_cartesian :12, fesom2regular :59
— kNN inverse-distance on the unit sphere via scipy cKDTree — and
``fpost2/g_oce_2_reg.F90``'s offline interpolation).

The port's own copy of ``fesom2_tpu/post/regrid.py`` (numpy and scipy
on the host, as there).
"""
from __future__ import annotations

import numpy as np


def lon_lat_to_cartesian(lon, lat, R=6371000.0):
    """ref lon_lat_to_cartesian :12-23."""
    lon_r = np.radians(lon)
    lat_r = np.radians(lat)
    x = R * np.cos(lat_r) * np.cos(lon_r)
    y = R * np.cos(lat_r) * np.sin(lon_r)
    z = R * np.sin(lat_r)
    return x, y, z


def regular_grid(nx=360, ny=180, box=(-180.0, 180.0, -90.0, 90.0)):
    lons = np.linspace(box[0], box[1], nx, endpoint=False) \
        + (box[1] - box[0]) / nx / 2.0
    lats = np.linspace(box[2], box[3], ny, endpoint=False) \
        + (box[3] - box[2]) / ny / 2.0
    return np.meshgrid(lons, lats)


def create_indexes_and_distances(mesh_x, mesh_y, lons, lats, k=1):
    """kNN search from target grid points into the mesh nodes
    (ref create_indexes_and_distances :25-57)."""
    from scipy.spatial import cKDTree
    xs, ys, zs = lon_lat_to_cartesian(np.asarray(mesh_x).ravel(),
                                      np.asarray(mesh_y).ravel())
    xt, yt, zt = lon_lat_to_cartesian(np.asarray(lons).ravel(),
                                      np.asarray(lats).ravel())
    tree = cKDTree(np.stack([xs, ys, zs], 1))
    distances, inds = tree.query(np.stack([xt, yt, zt], 1), k=k)
    return distances, inds


def fesom2regular(data, mesh, lons, lats, how="nn", k=5,
                  radius_of_influence=100000.0, dist_ind=None):
    """Interpolate nodal `data` [N] to the lon/lat grid
    (ref fesom2regular :59-118: 'nn' nearest neighbour or 'idist'
    inverse-distance over k neighbours, masked beyond the influence radius).
    """
    if dist_ind is None:
        kk = 1 if how == "nn" else k
        distances, inds = create_indexes_and_distances(
            mesh.x2, mesh.y2, lons, lats, k=kk)
    else:
        distances, inds = dist_ind
    data = np.asarray(data).ravel()
    if how == "nn" or (distances.ndim == 1):
        out = data[inds]
        out = np.where(distances > radius_of_influence, np.nan, out)
    else:
        w = 1.0 / np.maximum(distances, 1.0) ** 2
        out = (data[inds] * w).sum(-1) / w.sum(-1)
        out = np.where(distances.min(-1) > radius_of_influence, np.nan, out)
    return out.reshape(np.shape(lons))


def fesom3d_to_regular(data3d, mesh, lons, lats, levels=None, **kw):
    """Per-level regridding of [nl-1, N] data with below-bottom masking
    (the fpost2 make_diag_ts3 product)."""
    nlay = data3d.shape[0]
    levels = range(nlay) if levels is None else levels
    kk = 1 if kw.get("how", "nn") == "nn" else kw.get("k", 5)
    dist_ind = create_indexes_and_distances(mesh.x2, mesh.y2, lons, lats, k=kk)
    out = []
    for il in levels:
        d = np.asarray(data3d[il], float).copy()
        d[mesh.nlevels_nod2D - 1 <= il] = np.nan     # below-bottom
        out.append(fesom2regular(d, mesh, lons, lats, dist_ind=dist_ind, **kw))
    return np.stack(out)
