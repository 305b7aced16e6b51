# Frozen copy of fesom2_tpu_torch/mesh/rotation.py, lines 1-53 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""Rotated-pole grid transforms (Euler angles), vectorised over node arrays.

Reference: ``src/gen_modules_rotate_grid.F90:30-120`` (set_mesh_transform_matrix,
r2g, g2r).  Convention: rotate by alpha around z, beta around new x, gamma
around new z; angles in radians inside, degrees at the API boundary.
"""
from __future__ import annotations

import numpy as np

from ..constants import rad


def rotation_matrix(alpha_deg: float, beta_deg: float, gamma_deg: float) -> np.ndarray:
    """3x3 rotated->geographic matrix (row-major, matches r2g_matrix layout)."""
    al, be, ga = alpha_deg * rad, beta_deg * rad, gamma_deg * rad
    m = np.empty((3, 3))
    m[0, 0] = np.cos(ga) * np.cos(al) - np.sin(ga) * np.cos(be) * np.sin(al)
    m[0, 1] = np.cos(ga) * np.sin(al) + np.sin(ga) * np.cos(be) * np.cos(al)
    m[0, 2] = np.sin(ga) * np.sin(be)
    m[1, 0] = -np.sin(ga) * np.cos(al) - np.cos(ga) * np.cos(be) * np.sin(al)
    m[1, 1] = -np.sin(ga) * np.sin(al) + np.cos(ga) * np.cos(be) * np.cos(al)
    m[1, 2] = np.cos(ga) * np.sin(be)
    m[2, 0] = np.sin(be) * np.sin(al)
    m[2, 1] = -np.sin(be) * np.cos(al)
    m[2, 2] = np.cos(be)
    return m


def r2g(rlon: np.ndarray, rlat: np.ndarray, matrix: np.ndarray):
    """Rotated (mesh) -> geographical coordinates, radians in/out."""
    xr = np.cos(rlat) * np.cos(rlon)
    yr = np.cos(rlat) * np.sin(rlon)
    zr = np.sin(rlat)
    xg = matrix[0, 0] * xr + matrix[1, 0] * yr + matrix[2, 0] * zr
    yg = matrix[0, 1] * xr + matrix[1, 1] * yr + matrix[2, 1] * zr
    zg = matrix[0, 2] * xr + matrix[1, 2] * yr + matrix[2, 2] * zr
    glat = np.arcsin(np.clip(zg, -1.0, 1.0))
    glon = np.where((yg == 0.0) & (xg == 0.0), 0.0, np.arctan2(yg, xg))
    return glon, glat


def g2r(glon: np.ndarray, glat: np.ndarray, matrix: np.ndarray):
    """Geographical -> rotated (mesh) coordinates, radians in/out."""
    xg = np.cos(glat) * np.cos(glon)
    yg = np.cos(glat) * np.sin(glon)
    zg = np.sin(glat)
    xr = matrix[0, 0] * xg + matrix[0, 1] * yg + matrix[0, 2] * zg
    yr = matrix[1, 0] * xg + matrix[1, 1] * yg + matrix[1, 2] * zg
    zr = matrix[2, 0] * xg + matrix[2, 1] * yg + matrix[2, 2] * zg
    rlat = np.arcsin(np.clip(zr, -1.0, 1.0))
    rlon = np.where((yr == 0.0) & (xr == 0.0), 0.0, np.arctan2(yr, xr))
    return rlon, rlat
