"""Plotting helpers for unstructured FESOM-style output (replaces
``view/modules/fesom_plot_tools.py``: ftriplot :6, wplot_xy :91,
wplot_yz :150, movingaverage :163).

Pure matplotlib — the reference uses Basemap for map projections, which is
not a baked-in dependency here; ``ftriplot`` draws in plate-carree
(lon/lat) coordinates for the global view and in polar azimuthal
coordinates for the 'np'/'sp' views (so the element ring around each pole
renders without a hole, matching the reference's polar projections).

The port's own copy of ``fesom2_tpu/post/plot.py``; matplotlib is
imported inside the functions, so the module imports without it.
"""
from __future__ import annotations

import numpy as np

from .mesh_loader import PostMesh


def _non_cyclic_elems(mesh: PostMesh, max_span_deg: float = 100.0):
    """Triangles that do not wrap the periodic seam (the reference
    precomputes ``mesh.no_cyclic_elem`` in load_mesh; we derive it here).

    Only meaningful for plate-carree drawing; polar views transform to
    azimuthal coordinates where the seam does not exist."""
    x = mesh.x2[mesh.elem]
    span = x.max(axis=1) - x.min(axis=1)
    return np.nonzero(span < max_span_deg)[0]


def _default_contours(ref):
    """41 levels over the finite range of ``ref``; robust to empty or
    all-NaN input (falls back to [0, 1])."""
    ref = np.asarray(ref, dtype=float)
    if ref.size == 0:
        return np.linspace(0.0, 1.0, 41)
    finite = ref[np.isfinite(ref)]
    if finite.size == 0:
        return np.linspace(0.0, 1.0, 41)
    lo, hi = float(finite.min()), float(finite.max())
    if lo == hi:
        lo, hi = lo - 1.0, hi + 1.0
    return np.linspace(lo, hi, 41)


def ftriplot(mesh: PostMesh, data, contours=None, cmap=None, oce="global",
             do_cbar=True, extend="both", data_on_elem=False, ax=None):
    """Filled plot of a nodal (or element) field on the triangular mesh.

    ``oce``: 'global' (plate-carree), 'np' (lat>45N, polar azimuthal),
    'sp' (lat<-45S, polar azimuthal).
    ``contours``: array of levels; default 41 levels over the finite range.
    Returns (fig, ax, artist).
    """
    import matplotlib.pyplot as plt

    data = np.asarray(data, dtype=float).copy()
    polar = oce in ("np", "sp")
    if polar:
        # azimuthal coordinates: r = colatitude, theta = lon — no periodic
        # seam, so the pole ring is kept intact (the reference draws these
        # views in a Basemap polar projection for the same reason)
        lam = np.deg2rad(mesh.x2)
        if oce == "np":
            r = 90.0 - mesh.y2
            lat_sel_nodes = mesh.y2 > 45.0
        else:
            r = 90.0 + mesh.y2
            lat_sel_nodes = mesh.y2 < -45.0
        px = r * np.cos(lam)
        py = r * np.sin(lam)
        elem2 = mesh.elem
        sel = lat_sel_nodes[elem2].all(axis=1)
        elem2 = elem2[sel]
        if data_on_elem:
            data = data[sel]
    else:
        px, py = mesh.x2, mesh.y2
        keep = _non_cyclic_elems(mesh)
        elem2 = mesh.elem[keep]
        if data_on_elem:
            data = data[keep]

    if data_on_elem:
        finite_e = np.isfinite(data)
        elem2, data = elem2[finite_e], data[finite_e]
    else:
        finite_e = np.isfinite(data[elem2]).all(axis=1)
        elem2 = elem2[finite_e]

    if elem2.shape[0] == 0:
        raise ValueError(
            "ftriplot: no drawable elements remain (data all-NaN on every "
            "element, or the selected view contains no elements)")
    if contours is None:
        ref = data if data_on_elem else data[np.unique(elem2)]
        contours = _default_contours(ref)
    contours = np.asarray(contours, dtype=float)

    if ax is None:
        fig, ax = plt.subplots(figsize=(10, 5) if not polar else (6, 6))
    else:
        fig = ax.figure
    cmap = cmap or plt.cm.viridis

    if data_on_elem:
        im = ax.tripcolor(px, py, elem2, facecolors=data,
                          cmap=cmap, vmin=contours.min(), vmax=contours.max())
    else:
        # clamp into the contour range like the reference (ftriplot :34-37)
        eps = (contours.max() - contours.min()) / 50.0
        d = np.clip(data, contours.min() + eps, contours.max() - eps)
        im = ax.tricontourf(px, py, elem2, d, levels=contours,
                            cmap=cmap, extend=extend)
    if polar:
        ax.set_aspect("equal")
        ax.set_xlabel("x (deg from pole)")
        ax.set_ylabel("y (deg from pole)")
    else:
        ax.set_xlabel("lon")
        ax.set_ylabel("lat")
    if do_cbar:
        fig.colorbar(im, ax=ax, orientation="horizontal", pad=0.08,
                     fraction=0.05)
    return fig, ax, im


def _masked_default_contours(zz):
    """Default levels for a masked array; raise a clear error when every
    value is masked (e.g. a fully-NaN regrid)."""
    if zz.count() == 0:
        raise ValueError(
            "cannot derive default contour levels: all values are "
            "masked/NaN (regrid produced no valid points — try a larger "
            "radius_of_influence, or pass explicit contours=)")
    lo, hi = float(zz.min()), float(zz.max())
    if lo == hi:
        lo, hi = lo - 1.0, hi + 1.0
    return np.linspace(lo, hi, 41)


def wplot_xy(xx, yy, zz, contours=None, cmap=None, do_cbar=True, ax=None):
    """Filled-contour plot of a regular-grid (regridded) field
    (reference wplot_xy :91); masks NaN."""
    import matplotlib.pyplot as plt

    zz = np.ma.masked_invalid(np.asarray(zz, dtype=float))
    if contours is None:
        contours = _masked_default_contours(zz)
    if ax is None:
        fig, ax = plt.subplots(figsize=(10, 5))
    else:
        fig = ax.figure
    im = ax.contourf(xx, yy, zz, levels=contours,
                     cmap=cmap or plt.cm.viridis, extend="both")
    if do_cbar:
        fig.colorbar(im, ax=ax, orientation="horizontal", pad=0.08,
                     fraction=0.05)
    return fig, ax, im


def wplot_yz(y, z, v, contours=None, cmap=None, ax=None):
    """Meridional-section plot (lat x depth), e.g. for MOC streamfunctions
    (reference wplot_yz :150); depth axis increases downward."""
    import matplotlib.pyplot as plt

    v = np.ma.masked_invalid(np.asarray(v, dtype=float))
    if contours is None:
        contours = _masked_default_contours(v)
    if ax is None:
        fig, ax = plt.subplots(figsize=(8, 4))
    else:
        fig = ax.figure
    im = ax.contourf(y, z, v, levels=contours, cmap=cmap or plt.cm.viridis,
                     extend="both")
    if np.asarray(z).ndim == 1 and np.asarray(z).max() > 0:
        ax.invert_yaxis()
    ax.set_xlabel("lat")
    ax.set_ylabel("depth")
    fig.colorbar(im, ax=ax, orientation="vertical", fraction=0.05)
    return fig, ax, im


def moving_average(series, window_size: int):
    """Centered running mean (reference movingaverage :163).

    Edge-pads the series before convolving so the first/last half-window
    values are not biased toward zero (np.convolve mode='same' zero-pads,
    which damps the ends; the reference pads with the edge value)."""
    series = np.asarray(series, dtype=float)
    w = int(window_size)
    if w <= 1 or series.size == 0:
        return series.copy()
    w = min(w, series.size)
    half = w // 2
    padded = np.pad(series, (half, w - 1 - half), mode="edge")
    window = np.ones(w) / float(w)
    return np.convolve(padded, window, mode="valid")
