"""Geometric partition of the mesh nodes (host numpy).

Copies of ``_sphere_xyz`` and ``_partition_numpy`` from
``fesom2_tpu/parallel/partition.py:71-75, :139-160``: that module imports
the JAX package's mesh code, which imports jax.  ``ssh.build_block_schwarz``
cuts its preconditioner blocks with this plain weighted recursive
coordinate bisection (the JAX builder calls the same numpy function, not
the native partitioner), so both give the same blocks.
"""
from __future__ import annotations

import numpy as np


def _sphere_xyz(mesh):
    """Unit-sphere coordinates [N, 3] of the nodes' geographic lon/lat."""
    geo = mesh.geo_coords.detach().cpu().numpy()
    lon, lat = geo[:, 0], geo[:, 1]
    return np.stack([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
                     np.sin(lat)], axis=1).copy()


def _partition_numpy(xyz, w, nparts):
    """Plain weighted recursive coordinate bisection: part id per node."""
    N = xyz.shape[0]
    part = np.zeros(N, np.int32)

    def bisect(idx, p0, np_):
        if np_ == 1:
            part[idx] = p0
            return
        np_left = np_ // 2
        frac = np_left / np_
        ext = xyz[idx].max(0) - xyz[idx].min(0)
        axis = int(np.argmax(ext))
        order = idx[np.argsort(xyz[idx, axis], kind="stable")]
        cw = np.cumsum(w[order])
        cut = int(np.searchsorted(cw, cw[-1] * frac)) + 1
        cut = max(1, min(cut, len(order) - 1))
        bisect(order[:cut], p0, np_left)
        bisect(order[cut:], p0 + np_left, np_ - np_left)

    bisect(np.arange(N), 0, nparts)
    return part
