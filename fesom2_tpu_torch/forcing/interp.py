"""Bilinear interpolation from regular lon-lat forcing grids to mesh nodes.

Reference: coefficient precompute ``gen_surface_forcing.F90:598-720``
(getcoeffld) and the generic regular->mesh interpolation
``gen_interpolation.F90:3-437``.  Weights are computed once per grid.

The port's own copy of ``fesom2_tpu/forcing/interp.py``, kept
line for line (the port imports nothing of the JAX package;
``tests/test_torch_forcing_files.py`` holds the two equal).
"""
from __future__ import annotations

import numpy as np


def bilinear_weights(lon_grid: np.ndarray, lat_grid: np.ndarray,
                     lon_pts: np.ndarray, lat_pts: np.ndarray,
                     cyclic: bool = True):
    """Return (idx[4, P], w[4, P]) such that field_at_pts = sum w*field.flat[idx].

    lon_grid ascending in degrees [0,360); lat_grid ascending; points in
    degrees.  Latitudes outside the grid clamp to the edge rows.
    """
    nx = lon_grid.size
    ny = lat_grid.size
    lon = np.mod(lon_pts, 360.0)
    dx = lon_grid[1] - lon_grid[0]
    i0 = np.floor((lon - lon_grid[0]) / dx).astype(np.int64)
    i0 = np.clip(i0, 0, nx - 1)
    i1 = (i0 + 1) % nx if cyclic else np.clip(i0 + 1, 0, nx - 1)
    x0 = lon_grid[0] + i0 * dx
    wx = np.clip((lon - x0) / dx, 0.0, 1.0)

    j0 = np.searchsorted(lat_grid, lat_pts) - 1
    j0 = np.clip(j0, 0, ny - 2)
    j1 = j0 + 1
    wy = (lat_pts - lat_grid[j0]) / (lat_grid[j1] - lat_grid[j0])
    wy = np.clip(wy, 0.0, 1.0)

    def flat(j, i):
        return j * nx + i

    idx = np.stack([flat(j0, i0), flat(j0, i1), flat(j1, i0), flat(j1, i1)])
    w = np.stack([(1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx), wy * wx])
    return idx, w


def apply_weights(field2d: np.ndarray, idx: np.ndarray, w: np.ndarray):
    """field2d [ny, nx] (or [T, ny, nx]) -> values at points [P] (or [T, P])."""
    flat = field2d.reshape(field2d.shape[:-2] + (-1,))
    return (flat[..., idx] * w).sum(axis=-2)
