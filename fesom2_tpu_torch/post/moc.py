"""Meridional overturning diagnostics (replaces ``fpost2/make_diag_moc_w.F90``
and the density-MOC reconstruction fed by gen_modules_diag's std_dens
binning).

The port's own copy of ``fesom2_tpu/post/moc.py`` (host numpy, as
there); ``moc_dens`` reads the ``std_dens_VDZ`` stream that
``core/diagnostics.py``'s ``diag_dens_moc`` (the ``dens_moc_bin`` kernel)
writes.
"""
from __future__ import annotations

import numpy as np


def moc_z(w, area, lat_nodes, lat_bins=None):
    """z-space MOC from the vertical velocity (the moc_w method): at each
    level, psi(phi) = integral of w over the area south of phi, in Sv.

    w [nl, N] m/s, area [nl, N] m^2, lat_nodes [N] degrees.
    Returns (lat_bin_centers, psi [n_bins, nl]).
    """
    w = np.asarray(w)
    area = np.asarray(area)
    lat = np.asarray(lat_nodes)
    if lat_bins is None:
        lat_bins = np.arange(-89.5, 90.0, 1.0)
    edges = np.concatenate([[-90.0], 0.5 * (lat_bins[1:] + lat_bins[:-1]),
                            [90.0]])
    ib = np.clip(np.digitize(lat, edges) - 1, 0, lat_bins.size - 1)
    wA = w * area                                        # [nl, N]
    binned = np.zeros((lat_bins.size, w.shape[0]))
    np.add.at(binned, ib, wA.T)
    psi = np.cumsum(binned, axis=0) / 1.0e6              # Sv
    return lat_bins, psi


def moc_dens(std_dens_VDZ, elem_area, lat_elems, std_dens, lat_bins=None):
    """Density-space MOC from the binned meridional transports
    (std_dens_VDZ [S, E] = v*h overlap-deposited per density class,
    gen_modules_diag.F90 diag_densMOC).  psi(phi, sigma) accumulates the
    zonally-integrated transport below each density class, in Sv.
    """
    VDZ = np.asarray(std_dens_VDZ)
    A = np.asarray(elem_area)
    lat = np.asarray(lat_elems)
    if lat_bins is None:
        lat_bins = np.arange(-89.5, 90.0, 1.0)
    edges = np.concatenate([[-90.0], 0.5 * (lat_bins[1:] + lat_bins[:-1]),
                            [90.0]])
    ib = np.clip(np.digitize(lat, edges) - 1, 0, lat_bins.size - 1)
    dy = np.diff(edges) * 111194.93                      # deg -> m
    # zonal integral of v*h per (lat bin, density class)
    vint = np.zeros((lat_bins.size, VDZ.shape[0]))
    np.add.at(vint, ib, (VDZ * A[None, :]).T)
    vint /= dy[:, None]
    # overturning: accumulate from the densest class upward
    psi = -np.cumsum(vint[:, ::-1], axis=1)[:, ::-1] / 1.0e6
    return lat_bins, np.asarray(std_dens), psi
