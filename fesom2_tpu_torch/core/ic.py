"""3D tracer initial conditions from climatology NetCDF, on the host.

The port of ``fesom2_tpu/core/ic.py``, in numpy as there; the mesh's
tables are read to the host.  Reference: ``src/gen_ic3d.F90:1-656``
(trilinear interpolation with nearest extrapolation into unfilled cells)
and the in-situ -> potential temperature conversion insitu2pot / ptheta /
atg (``src/oce_ale_pressure_bv.F90:2930-2731``).
"""
from __future__ import annotations

import numpy as np

from ..constants import rad
from ..io.netcdf import read_vars
from ..utils.support import extrap_nod, host


def atg(s, t, p):
    """Adiabatic temperature gradient [C/dbar] (Bryden 1973; ref :2704-2731)."""
    ds = s - 35.0
    return (((-2.1687e-16 * t + 1.8676e-14) * t - 4.6206e-13) * p
            + ((2.7759e-12 * t - 1.1351e-10) * ds
               + ((-5.4481e-14 * t + 8.733e-12) * t - 6.7795e-10) * t
               + 1.8741e-8)) * p \
        + (-4.2393e-8 * t + 1.8932e-6) * ds \
        + ((6.6228e-10 * t - 6.836e-8) * t + 8.5258e-6) * t + 3.5803e-5


def ptheta(s, t, p, pr=0.0):
    """Potential temperature via RK4 (ref ptheta :2659-2699), vectorised."""
    t = np.array(t, dtype=np.float64, copy=True)
    p = np.array(p, dtype=np.float64, copy=True)
    h = pr - p
    xk = h * atg(s, t, p)
    t = t + 0.5 * xk
    q = xk
    p = p + 0.5 * h
    xk = h * atg(s, t, p)
    t = t + 0.29289322 * (xk - q)
    q = 0.58578644 * xk + 0.121320344 * q
    xk = h * atg(s, t, p)
    t = t + 1.707106781 * (xk - q)
    q = 3.414213562 * xk - 4.121320344 * q
    p = p + 0.5 * h
    xk = h * atg(s, t, p)
    return t + (xk - 2.0 * q) / 6.0


def _fill_missing(field, missing_mask, n_pass=60):
    """Iterative nearest-neighbor fill of masked cells (lateral + vertical)."""
    f = np.where(missing_mask, np.nan, field)
    for _ in range(n_pass):
        if not np.isnan(f).any():
            break
        shifted = []
        for ax, sh in ((2, 1), (2, -1), (1, 1), (1, -1), (0, 1)):
            s = np.roll(f, sh, axis=ax)
            if ax == 1:   # latitude: do not wrap
                if sh == 1:
                    s[:, 0, :] = np.nan
                else:
                    s[:, -1, :] = np.nan
            if ax == 0:   # depth: only fill downward from above
                s[0, :, :] = np.nan
            shifted.append(s)
        stack = np.stack(shifted)
        # explicit all-NaN handling (nanmean would warn on empty slices):
        # cells with no filled neighbor this pass stay NaN for the next pass
        cnt = (~np.isnan(stack)).sum(axis=0)
        tot = np.nansum(np.where(np.isnan(stack), 0.0, stack), axis=0)
        fill = np.where(cnt > 0, tot / np.maximum(cnt, 1), np.nan)
        f = np.where(np.isnan(f), fill, f)
    # cells unreachable by the flood fill (enclosed basins below the deepest
    # data level): fill with the horizontal mean of their depth level, which
    # is a physically sane stand-in for T/S (0.0 was not)
    if np.isnan(f).any():
        lvl_cnt = (~np.isnan(f)).sum(axis=(1, 2))
        lvl_tot = np.nansum(np.where(np.isnan(f), 0.0, f), axis=(1, 2))
        glob = lvl_tot.sum() / max(lvl_cnt.sum(), 1)
        lvl_mean = np.where(lvl_cnt > 0, lvl_tot / np.maximum(lvl_cnt, 1),
                            glob)
        f = np.where(np.isnan(f), lvl_mean[:, None, None], f)
    return f


DUMMY = 1.0e20   # ref g_config dummy


def _interp_field_gen_ic3d(mesh, lon, lat, dep, F):
    """EXACT re-derivation of the reference interpolation chain
    (``gen_ic3d.F90`` getcoeffld :364-466 + do_ic3d :471-527):

    1. bilinear in (lon, lat) per file level; a node whose 4 surrounding
       SURFACE points include a missing value — or that falls outside the
       grid — gets a DUMMY column (:391); levels with any missing corner
       get DUMMY (:401-404);
    2. linear in depth at the model mid-depths; model depths beyond the
       file's last depth stay DUMMY (binarysearch returns len -> neither
       branch assigns, :443-459); intervals with a missing endpoint stay
       DUMMY; depths above the first file depth take data1d(1);
    3. extrap_nod: iterative horizontal neighbor-mean flood per layer,
       then vertical copy-down (``gen_support.F90:315-418``) — this is
       what extends the profile below the data and into coastal columns.

    Returns [nl-1, N] with DUMMY nowhere (after extrapolation) except
    fully-unreachable basins.
    """
    N = mesh.n_nodes
    nl1 = mesh.nl - 1
    F = np.where(np.isfinite(F) & (np.abs(F) < 0.99 * DUMMY), F, DUMMY)

    glon = host(mesh.geo_coords)[:, 0] / rad
    glat = host(mesh.geo_coords)[:, 1] / rad
    if lon.min() < -1.0:      # grid frame [-180, 180)
        x = (glon + 180.0) % 360.0 - 180.0
    else:                     # grid frame [0, 360)
        x = glon % 360.0
    y = glat

    nx, ny = lon.size, lat.size
    i = np.searchsorted(lon, x, side="right") - 1     # lon[i] <= x < lon[i+1]
    j = np.searchsorted(lat, y, side="right") - 1
    inside = (i >= 0) & (i <= nx - 2) & (j >= 0) & (j <= ny - 2)
    i_s = np.clip(i, 0, nx - 2)
    j_s = np.clip(j, 0, ny - 2)
    x1, x2 = lon[i_s], lon[i_s + 1]
    y1, y2 = lat[j_s], lat[j_s + 1]
    denom = (x2 - x1) * (y2 - y1)
    c00 = (x2 - x) * (y2 - y) / denom
    c10 = (x - x1) * (y2 - y) / denom
    c01 = (x2 - x) * (y - y1) / denom
    c11 = (x - x1) * (y - y1) / denom
    f00 = F[:, j_s, i_s]                              # [nzf, N]
    f10 = F[:, j_s, i_s + 1]
    f01 = F[:, j_s + 1, i_s]
    f11 = F[:, j_s + 1, i_s + 1]
    data = f00 * c00 + f10 * c10 + f01 * c01 + f11 * c11
    lev_missing = (f00 > 0.99 * DUMMY) | (f10 > 0.99 * DUMMY) \
        | (f01 > 0.99 * DUMMY) | (f11 > 0.99 * DUMMY)
    data = np.where(lev_missing, DUMMY, data)
    # a missing SURFACE corner (or out-of-grid) voids the whole column
    col_bad = lev_missing[0] | ~inside
    data = np.where(col_bad[None, :], DUMMY, data)

    # vertical linear interpolation at model mid-depths
    Z = -host(mesh.Z)                           # positive [nl-1]
    nzf = dep.size
    ind = np.searchsorted(dep, Z, side="right")       # == ref binarysearch
    out = np.full((nl1, N), DUMMY)
    for k in range(nl1):
        if ind[k] >= nzf:                             # below data: stay DUMMY
            continue
        if ind[k] == 0:                               # above first depth
            out[k] = data[0]
            continue
        a, b = ind[k] - 1, ind[k]
        d1, d2 = data[a], data[b]
        ok = (d1 < 0.99 * DUMMY) & (d2 < 0.99 * DUMMY)
        val = d1 + (d2 - d1) / (dep[b] - dep[a]) * (Z[k] - dep[a])
        out[k] = np.where(ok, val, DUMMY)

    # partial bottom cells: the bottom-layer mid depth differs per node
    # (ref gen_ic3d.F90:441 interpolates at Z_3d_n) — redo that layer
    # pointwise.  With full cells this reproduces the per-level result.
    nln = host(mesh.nlevels_node)
    zb = host(mesh.zbar)
    zmid_bot = -0.5 * (zb[nln - 2] + host(mesh.zbar_n_bot))  # [N] > 0
    indb = np.searchsorted(dep, zmid_bot, side="right")
    cols = np.arange(N)
    a = np.clip(indb - 1, 0, nzf - 1)
    b = np.clip(indb, 0, nzf - 1)
    d1, d2 = data[a, cols], data[b, cols]
    ok = (d1 < 0.99 * DUMMY) & (d2 < 0.99 * DUMMY) & (indb > 0)
    dz = np.where(b > a, dep[b] - dep[a], 1.0)
    valb = np.where(indb >= nzf, DUMMY,
                    np.where(indb == 0, data[0, cols],
                             np.where(ok, d1 + (d2 - d1) / dz
                                      * (zmid_bot - dep[a]), DUMMY)))
    out[nln - 2, cols] = valb

    out = extrap_nod(out, mesh, dummy=DUMMY)
    return out


def climatology_ic(mesh, path: str,
                   temp_var="temp", salt_var="salt", t_insitu=True):
    """T/S initial conditions from a WOA-style [depth, lat, lon] file,
    following the reference gen_ic3d chain exactly (see
    :func:`_interp_field_gen_ic3d`; dummy->0 and Kelvin handling per
    ``gen_ic3d.F90:505-530``).

    Returns (T, S) as [nl-1, N] numpy arrays (potential temperature),
    zero below the bottom."""
    d = read_vars(path, ["lon", "lat", "depth", temp_var, salt_var])
    lon = d["lon"].astype(np.float64)
    lat = d["lat"].astype(np.float64)
    dep = np.abs(d["depth"].astype(np.float64))
    T = d[temp_var].astype(np.float64)
    S = d[salt_var].astype(np.float64)

    Tn = _interp_field_gen_ic3d(mesh, lon, lat, dep, T)
    Sn = _interp_field_gen_ic3d(mesh, lon, lat, dep, S)
    # unreachable cells -> 0; Kelvin -> Celsius (ref :505-516)
    Tn = np.where(Tn > 0.9 * DUMMY, 0.0, Tn)
    Sn = np.where(Sn > 0.9 * DUMMY, 0.0, Sn)
    Tn = np.where(Tn > 100.0, Tn - 273.15, Tn)

    mask = host(mesh.node_layer_mask)
    Tn = np.where(mask, Tn, 0.0)
    Sn = np.where(mask, Sn, 0.0)
    if t_insitu:
        Z = -host(mesh.Z)
        Tn = np.where(mask, ptheta(Sn, Tn, Z[:, None] * np.ones_like(Tn)),
                      0.0)
    return Tn, Sn
