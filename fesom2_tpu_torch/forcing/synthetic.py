"""Forcing and climatology files made from a seed, for runs without the
reference data set.

``write_ncep_test_set`` writes NetCDF3 files in the layout of the NCEP-1948
test set that ``atmos.ncep_test_sbc`` names (``u_10.<year>.nc``,
``v_10.``, ``t_10.`` in Kelvin, ``q_10.``, ``ncar_rad.``, ``ncar_precip.``
and ``runoff.nc``) on the NCEP T62 grid's shape (192 x 94 by default,
latitudes descending as in the shipped files); ``write_woa18`` writes
``woa18_netcdf_5deg.nc`` (in-situ temperature and salinity on 72 x 36
columns and the given depths, with missing values over "land" (the polar
rows and seeded columns) and below a seeded floor in some columns).  The fields are smooth functions of
latitude with seeded noise: plausible values, not observations.
"""
from __future__ import annotations

import os

import numpy as np

FILL = 9.96921e36        # NetCDF's default float fill value


def _write(path, dims: dict, variables: dict) -> str:
    """A NetCDF3 file: dims {name: size}, variables {name: (dims, array,
    attrs)}."""
    from scipy.io import netcdf_file
    nc = netcdf_file(path, "w")
    try:
        for d, n in dims.items():
            nc.createDimension(d, n)
        for name, (dn, arr, attrs) in variables.items():
            arr = np.asarray(arr)
            v = nc.createVariable(name, arr.dtype, dn)
            v[:] = arr
            for k, val in (attrs or {}).items():
                setattr(v, k, val)
    finally:
        nc.close()
    return path


def t62_grid(nlon: int = 192, nlat: int = 94):
    """Longitudes [nlon] from 0 east, evenly spaced, and latitudes [nlat]
    descending from about 88.5 N to 88.5 S (the T62 grid's span)."""
    lon = np.arange(nlon) * (360.0 / nlon)
    lat = np.linspace(88.542, -88.542, nlat)
    return lon, lat


def write_ncep_test_set(path: str, seed: int = 0, year: int = 1948,
                        nlon: int = 192, nlat: int = 94, n_wind: int = 8,
                        n_rad: int = 2, n_prec: int = 2,
                        cf_units: bool = True) -> str:
    """The NCEP test set of ``year`` under ``path`` (made if missing);
    returns ``path``.  Wind, air temperature and humidity are six-hourly
    (``n_wind`` records), radiation daily and precipitation monthly
    (``n_rad``, ``n_prec`` records).  With ``cf_units`` each time axis has
    a CF ``units`` string ('hours since <year>-01-01 00:00:00', ...);
    without, the radiation and precipitation axes have none, and the
    loader takes the namelist's convention for them."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed + 7919 * (year - 1948))
    lon, lat = t62_grid(nlon, nlat)
    la = np.radians(lat)[:, None] * np.ones((1, nlon))
    lo = np.radians(lon)[None, :] * np.ones((nlat, 1))
    dims = lambda nt: {"TIME": nt, "LAT": nlat, "LON": nlon}
    coords = lambda nt, units, step: {
        "LON": (("LON",), lon, {"units": "degrees_east"}),
        "LAT": (("LAT",), lat, {"units": "degrees_north"}),
        "TIME": (("TIME",), np.arange(nt, dtype=np.float64) * step,
                 {"units": units} if units else {})}

    def series(nt, base, amp, noise):
        out = np.empty((nt, nlat, nlon))
        for k in range(nt):
            phase = 2.0 * np.pi * k / max(nt, 1)
            out[k] = base(la, lo, phase) + amp * rng.standard_normal(
                (nlat, nlon)) * noise
        return out

    hours = f"hours since {year}-01-01 00:00:00"
    u = series(n_wind, lambda a, o, p: 8.0 * np.cos(2 * a) * np.cos(p)
               + 2.0 * np.sin(o), 1.0, 1.0)
    v = series(n_wind, lambda a, o, p: 3.0 * np.sin(2 * a) * np.sin(o + p),
               1.0, 1.0)
    t = series(n_wind, lambda a, o, p: 273.15 + 32.0 * np.cos(a) ** 2 - 20.0
               + 2.0 * np.sin(p), 0.5, 1.0)
    q = np.clip(series(n_wind, lambda a, o, p: 2e-2 * np.cos(a) ** 3,
                       1e-3, 1.0), 1e-4, None)
    for stem, var, data in (("u_10", "U_10_MOD", u), ("v_10", "V_10_MOD", v),
                            ("t_10", "T_10_MOD", t), ("q_10", "Q_10_MOD", q)):
        _write(os.path.join(path, f"{stem}.{year}.nc"), dims(n_wind),
               {**coords(n_wind, hours, 6.0),
                var: (("TIME", "LAT", "LON"), data, {})})
    sw = np.clip(series(n_rad, lambda a, o, p: 320.0 * np.cos(a), 10.0, 1.0),
                 0.0, None)
    lw = series(n_rad, lambda a, o, p: 200.0 + 160.0 * np.cos(a), 5.0, 1.0)
    _write(os.path.join(path, f"ncar_rad.{year}.nc"), dims(n_rad),
           {**coords(n_rad, f"days since {year}-01-01 12:00:00"
                     if cf_units else None, 1.0),
            "SWDN_MOD": (("TIME", "LAT", "LON"), sw, {}),
            "LWDN_MOD": (("TIME", "LAT", "LON"), lw, {})})
    rain = np.clip(series(n_prec, lambda a, o, p: 4e-5 * np.cos(a) ** 2,
                          1e-5, 1.0), 0.0, None)
    snow = np.clip(series(n_prec, lambda a, o, p: 1e-5 * np.sin(a) ** 4,
                          2e-6, 1.0), 0.0, None)
    _write(os.path.join(path, f"ncar_precip.{year}.nc"), dims(n_prec),
           {**coords(n_prec, f"days since {year}-01-16 12:00:00"
                     if cf_units else None, 30.0),
            "RAIN": (("TIME", "LAT", "LON"), rain, {}),
            "SNOW": (("TIME", "LAT", "LON"), snow, {})})
    # runoff [1, lat, lon] on a grid of its own, ascending latitudes, land
    # carrying fill values
    rlon = np.arange(2 * nlon // 3) * (360.0 / (2 * nlon // 3))
    rlat = np.linspace(-89.0, 89.0, 2 * nlat // 3)
    roff = np.abs(rng.standard_normal((1, rlat.size, rlon.size))) * 1e-5
    roff[:, rng.uniform(size=(rlat.size, rlon.size)) < 0.2] = 1e20
    _write(os.path.join(path, "runoff.nc"),
           {"time": 1, "lat": rlat.size, "lon": rlon.size},
           {"lon": (("lon",), rlon, {}), "lat": (("lat",), rlat, {}),
            "Foxx_o_roff": (("time", "lat", "lon"), roff, {})})
    return path


def write_woa18(path: str, seed: int = 0, depths=None, nlon: int = 72,
                nlat: int = 36) -> str:
    """``woa18_netcdf_5deg.nc`` under ``path`` (made if missing): in-situ
    temperature [C] and salinity on 5-degree columns (longitudes from
    -177.5, latitudes from -87.5) at ``depths`` [m, positive down], with
    fill values over land (whole columns: the rows at 87.5 degrees and 2 %
    of the columns, seeded) and below a seeded floor in 10 % of the
    columns.  Returns the file's path."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    if depths is None:
        depths = np.concatenate([np.arange(0.0, 100.0, 10.0),
                                 np.arange(100.0, 1000.0, 100.0),
                                 np.arange(1000.0, 7001.0, 500.0)])
    depths = np.asarray(depths, np.float64)
    lon = -177.5 + 5.0 * np.arange(nlon)
    lat = -87.5 + 5.0 * np.arange(nlat)
    la = np.radians(lat)[None, :, None]
    z = depths[:, None, None]
    temp = (30.0 * np.cos(la) ** 2 - 4.0) * np.exp(-z / 700.0) + 1.2 \
        * (1.0 - np.exp(-z / 700.0)) + 0.3 * rng.standard_normal(
            (depths.size, nlat, nlon))
    temp = np.maximum(temp, -1.8)
    salt = 34.7 + 0.8 * np.cos(2 * la) * np.exp(-z / 1000.0) \
        + 0.05 * rng.standard_normal((depths.size, nlat, nlon))
    # land: the polar rows (87.5 degrees) and 2 % of the columns;
    # a floor above the deepest depth in 10 % of the columns
    land = (np.abs(lat)[:, None] > 85.0) \
        | (rng.uniform(size=(nlat, nlon)) < 0.02)
    floor = np.where(rng.uniform(size=(nlat, nlon)) < 0.1,
                     rng.integers(3 * depths.size // 4, depths.size,
                                  (nlat, nlon)), depths.size)
    below = np.arange(depths.size)[:, None, None] >= floor[None]
    missing = land[None] | below
    temp = np.where(missing, FILL, temp).astype(np.float32)
    salt = np.where(missing, FILL, salt).astype(np.float32)
    return _write(os.path.join(path, "woa18_netcdf_5deg.nc"),
                  {"depth": depths.size, "lat": nlat, "lon": nlon},
                  {"lon": (("lon",), lon, {}), "lat": (("lat",), lat, {}),
                   "depth": (("depth",), depths, {}),
                   "temp": (("depth", "lat", "lon"), temp, {}),
                   "salt": (("depth", "lat", "lon"), salt, {})})
