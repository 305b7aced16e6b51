"""Atmospheric forcing: the file loaders on the host, and on the device the
nodal time series, their interpolation to the model time, bulk
coefficients and wind stresses.

The port of ``fesom2_tpu/forcing/atmos.py``.  Reference:
``src/gen_surface_forcing.F90`` (module g_sbf: sbc_ini :877, sbc_do :1040,
data_timeinterp :851) and the standalone branch of update_atm_forcing
(``src/gen_forcing_couple.F90:255-325``).

At setup every record of each forcing file of the active year is read and
interpolated to the mesh nodes in numpy (``load_sbc_forcing``: the
``&nam_sbc`` layout, or the NCEP test set of ``ncep_test_sbc``;
``load_core_forcing``: that set's fixed file names), then copied to the
model's device and dtype once as ``AtmData`` [T, N]; the step only
interpolates in time on the device.  ``SbcProvider`` switches years with
the next year read on a host thread (numpy only; the copy to the device
happens on the caller's thread).  Files are NetCDF3, read with scipy;
``io/netcdf.py`` reads HDF5 through ``h5py`` where it is installed.
Without files the series are built in code (``model.globe_atm_data``) or
carried over from numpy arrays (``convert.atm_from_numpy``).
"""
from __future__ import annotations

import dataclasses
import os
import re
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import rad
from ..io.netcdf import read_vars
from ..ice.state import IceForcing, rhoair, tmelt
from ..mesh.rotation import rotation_matrix
from ..utils.support import host
from .bulk import ncar_ocean_fluxes
from .interp import apply_weights, bilinear_weights

Cd_atm_ice = 1.32e-3     # gen_modules_forcing.F90:19


@dataclass(frozen=True)
class AtmData:
    """Nodal time series of atmospheric state + per-file time axes [s]."""
    u_wind: torch.Tensor     # [T, N] (rotated frame)
    v_wind: torch.Tensor
    tair: torch.Tensor       # [T, N] Celsius
    shum: torch.Tensor
    t_wind: torch.Tensor     # [T] seconds since year start
    swdn: torch.Tensor       # [Tr, N]
    lwdn: torch.Tensor
    t_rad: torch.Tensor
    prec: torch.Tensor       # [Tp, N] m/s water
    snow: torch.Tensor       # [Tp, N] m/s water-equivalent
    t_prec: torch.Tensor
    runoff: torch.Tensor     # [N] climatological, m/s


ATM_FIELDS = ("u_wind", "v_wind", "tair", "shum", "t_wind", "swdn", "lwdn",
              "t_rad", "prec", "snow", "t_prec", "runoff")


@dataclass(frozen=True)
class MeshGeometry:
    """What the loaders read of a mesh, as numpy on the host: geographic
    longitude and latitude [N] in degrees, the mesh frame's coordinates
    [N] in radians, and whether the mesh is cartesian."""
    glon: np.ndarray
    glat: np.ndarray
    rlon: np.ndarray
    rlat: np.ndarray
    cartesian: bool


def mesh_geometry(mesh) -> MeshGeometry:
    geo, crd = host(mesh.geo_coords), host(mesh.coords)
    return MeshGeometry(glon=geo[:, 0] / rad, glat=geo[:, 1] / rad,
                        rlon=crd[:, 0], rlat=crd[:, 1],
                        cartesian=bool(mesh.cartesian))


def atm_from_arrays(arrays: dict, dtype=torch.float64,
                    device="cpu") -> AtmData:
    """``AtmData`` from the loaders' numpy series: one copy each to
    ``device`` in ``dtype``."""
    return AtmData(**{k: torch.from_numpy(np.asarray(arrays[k], np.float64))
                      .to(device=device, dtype=dtype) for k in ATM_FIELDS})


def _interp_series(path, varnames, mesh_lon_deg, mesh_lat_deg):
    data = read_vars(path, ["LON", "LAT", "TIME"] + varnames)
    idx, w = bilinear_weights(data["LON"].astype(np.float64),
                              data["LAT"].astype(np.float64),
                              mesh_lon_deg, mesh_lat_deg)
    out = [apply_weights(data[v].astype(np.float64), idx, w) for v in varnames]
    return out, data["TIME"].astype(np.float64)


def _core_runoff(path, glon, glat):
    """CORE-style runoff: kg/m^2/s on its own grid, constant in time, land
    fill values to 0, -> m/s at the nodes."""
    ro = read_vars(path, ["lon", "lat", "Foxx_o_roff"])
    idx, w = bilinear_weights(ro["lon"].astype(np.float64),
                              ro["lat"].astype(np.float64), glon, glat)
    roff = ro["Foxx_o_roff"][0].astype(np.float64)
    roff = np.where(np.abs(roff) > 1e10, 0.0, roff)
    return apply_weights(roff, idx, w) / 1000.0


def core_forcing_arrays(geom: MeshGeometry, path: str) -> dict:
    """The numpy series of ``load_core_forcing``
    (``fesom2_tpu/forcing/atmos.py:63-130``)."""
    glon, glat = geom.glon, geom.glat
    (u10,), t_wind = _interp_series(os.path.join(path, "u_10.1948.nc"),
                                    ["U_10_MOD"], glon, glat)
    (v10,), _ = _interp_series(os.path.join(path, "v_10.1948.nc"),
                               ["V_10_MOD"], glon, glat)
    (t10,), _ = _interp_series(os.path.join(path, "t_10.1948.nc"),
                               ["T_10_MOD"], glon, glat)
    (q10,), _ = _interp_series(os.path.join(path, "q_10.1948.nc"),
                               ["Q_10_MOD"], glon, glat)
    (sw, lw), t_rad = _interp_series(os.path.join(path, "ncar_rad.1948.nc"),
                                     ["SWDN_MOD", "LWDN_MOD"], glon, glat)
    (pr, snow), t_prec = _interp_series(
        os.path.join(path, "ncar_precip.1948.nc"), ["RAIN", "SNOW"], glon,
        glat)
    runoff = _core_runoff(os.path.join(path, "runoff.nc"), glon, glat)
    if not geom.cartesian:
        # wind vectors into the mesh frame (ref gen_surface_forcing:1094)
        m = rotation_matrix(50.0, 15.0, -90.0)
        u10, v10 = _vector_g2r(m, glon * rad, glat * rad, geom.rlon,
                               geom.rlat, u10, v10)
    # time axes: u/t/q 6-hourly "hours since 1948-01-01 03:00"; rad daily
    # "days since 1948-01-01 12:00"; precip monthly "hours since
    # 1948-01-16 12:00"
    return dict(u_wind=u10, v_wind=v10, tair=t10 - tmelt, shum=q10,
                t_wind=t_wind * 3600.0 + 3.0 * 3600.0, swdn=sw, lwdn=lw,
                t_rad=t_rad * 86400.0 + 12.0 * 3600.0, prec=pr / 1000.0,
                snow=snow / 1000.0, t_prec=t_prec * 3600.0 + 15.5 * 86400.0,
                runoff=runoff)


def load_core_forcing(mesh, path: str, dtype=torch.float64) -> AtmData:
    """The NCEP/CORE test forcing of ``path`` (``test/input/global``'s
    fixed file names of 1948), on the mesh's device in ``dtype``."""
    return atm_from_arrays(core_forcing_arrays(mesh_geometry(mesh), path),
                           dtype, mesh.zbar.device)


def _read_grid_var(path, varname):
    """Read (lon, lat, time, units, data) with the reference's coordinate-
    name alternatives (nc_readTimeGrid, gen_surface_forcing.F90:181-467:
    LON/lon/longitude/LON1, same for lat, TIME/time); latitudes come back
    ascending (ref :453 "FLIP lat and data")."""
    from scipy.io import netcdf_file
    nc = netcdf_file(path, "r", mmap=False)
    try:
        def pick(*names):
            for n in names:
                if n in nc.variables:
                    return nc.variables[n]
            raise KeyError(f"none of {names} in {path}")
        lon = np.array(pick("LON", "lon", "longitude", "LON1")[:],
                       np.float64)
        lat = np.array(pick("LAT", "lat", "latitude", "LAT1")[:], np.float64)
        tv = pick("TIME", "time")
        t = np.array(tv[:], np.float64)
        units = getattr(tv, "units", b"")
        if isinstance(units, bytes):
            units = units.decode()
        data = np.array(nc.variables[varname][:], np.float64)
        if lat.size > 1 and lat[0] > lat[-1]:
            lat = lat[::-1].copy()
            data = data[:, ::-1].copy()
        return lon, lat, t, units, data
    finally:
        nc.close()


_MDAYS = [0, 31, 59, 90, 120, 151, 181, 212, 243, 273, 304, 334]


def _time_axis_seconds(t, units, year, sbc):
    """A raw NetCDF time axis as seconds since Jan 1 of ``year``.

    A CF-like units string ('hours since 1948-01-16 12:00:00') is used
    exactly (the shipped NCEP test files).  Otherwise the reference's
    namelist convention (``nc_time/nm_nc_freq + julday(nm_nc_iyear, imm,
    idd)``, gen_surface_forcing.F90:433), with the stamps moved to the
    interval mid-points unless ``nm_nc_tmid``; as the reference updates in
    place, the last stamp is extrapolated from the already moved one
    before it: a quarter interval past the last raw stamp, not a half."""
    m = re.match(r"\s*(\w+)\s+since\s+(\d+)-(\d+)-(\d+)[T ]?(\d+)?:?(\d+)?",
                 units or "")
    if m:
        scale = {"seconds": 1.0, "hours": 3600.0, "days": 86400.0,
                 "months": 86400.0 * 30.42}[m.group(1).lower()]
        ey, em, ed = int(m.group(2)), int(m.group(3)), int(m.group(4))
        eh = int(m.group(5) or 0)
        emin = int(m.group(6) or 0)
        off = ((ey - year) * 365.0 + _MDAYS[em - 1] + (ed - 1)) * 86400.0 \
            + eh * 3600.0 + emin * 60.0
        return t * scale + off
    off = ((sbc.nm_nc_iyear - year) * 365.0 + _MDAYS[sbc.nm_nc_imm - 1]
           + (sbc.nm_nc_idd - 1)) * 86400.0
    tt = t / max(sbc.nm_nc_freq, 1) * 86400.0 + off
    if not sbc.nm_nc_tmid and tt.size > 1:
        tt = np.concatenate([0.5 * (tt[:-1] + tt[1:]),
                             [tt[-1] + 0.25 * (tt[-1] - tt[-2])]])
    return tt


def ncep_test_sbc(path: str):
    """The ``SbcConfig`` of the NCEP-1948 test set (``test/input/global``)
    under ``path``: the layout ``load_core_forcing`` reads, as data."""
    from ..config import SbcConfig
    j = lambda p: os.path.join(path, p)
    return SbcConfig(
        nm_xwind_file=j("u_10."), nm_xwind_var="U_10_MOD",
        nm_ywind_file=j("v_10."), nm_ywind_var="V_10_MOD",
        nm_tair_file=j("t_10."), nm_tair_var="T_10_MOD",
        nm_humi_file=j("q_10."), nm_humi_var="Q_10_MOD",
        nm_qsr_file=j("ncar_rad."), nm_qsr_var="SWDN_MOD",
        nm_qlw_file=j("ncar_rad."), nm_qlw_var="LWDN_MOD",
        nm_prec_file=j("ncar_precip."), nm_prec_var="RAIN",
        nm_snow_file=j("ncar_precip."), nm_snow_var="SNOW",
        nm_runoff_file=j("runoff.nc"), runoff_data_source="CORE2",
        nm_sss_data_file=j("PHC2_salx.nc"), sss_data_source="CORE2")


def sbc_forcing_arrays(geom: MeshGeometry, sbc, year: int = 1948) -> dict:
    """The numpy series of ``load_sbc_forcing`` for ``year``
    (``fesom2_tpu/forcing/atmos.py:199-262``): host only, so that a
    thread can run it."""
    glon, glat = geom.glon, geom.glat
    wcache = {}

    def load(prefix, varname):
        path = f"{prefix}{year}.nc"
        lon, lat, t, units, data = _read_grid_var(path, varname)
        key = (lon.tobytes(), lat.tobytes())
        if key not in wcache:
            wcache[key] = bilinear_weights(lon, lat, glon, glat)
        idx, w = wcache[key]
        return apply_weights(data, idx, w), _time_axis_seconds(t, units, year,
                                                               sbc)

    u10, t_wind = load(sbc.nm_xwind_file, sbc.nm_xwind_var)
    v10, _ = load(sbc.nm_ywind_file, sbc.nm_ywind_var)
    t10, _ = load(sbc.nm_tair_file, sbc.nm_tair_var)
    q10, _ = load(sbc.nm_humi_file, sbc.nm_humi_var)
    sw, t_rad = load(sbc.nm_qsr_file, sbc.nm_qsr_var)
    lw, _ = load(sbc.nm_qlw_file, sbc.nm_qlw_var)
    if sbc.l_prec:
        pr, t_prec = load(sbc.nm_prec_file, sbc.nm_prec_var)
    else:
        pr, t_prec = np.zeros((2, glon.size)), np.array([0.0, 86400.0])
    if sbc.l_snow:
        sn, _ = load(sbc.nm_snow_file, sbc.nm_snow_var)
    else:
        sn = np.zeros_like(pr)
    runoff = np.zeros(glon.size)
    if sbc.nm_runoff_file and sbc.runoff_data_source in ("CORE1", "CORE2"):
        runoff = _core_runoff(sbc.nm_runoff_file, glon, glat)
    if not geom.cartesian:
        m = rotation_matrix(50.0, 15.0, -90.0)
        u10, v10 = _vector_g2r(m, glon * rad, glat * rad, geom.rlon,
                               geom.rlat, u10, v10)
    if np.nanmean(t10) > 100.0:          # Kelvin-coded air temperature
        t10 = t10 - tmelt
    return dict(u_wind=u10, v_wind=v10, tair=t10, shum=q10, t_wind=t_wind,
                swdn=sw, lwdn=lw, t_rad=t_rad, prec=pr / 1000.0,
                snow=sn / 1000.0, t_prec=t_prec, runoff=runoff)


def load_sbc_forcing(mesh, sbc, year: int = 1948,
                     dtype=torch.float64) -> AtmData:
    """The ``&nam_sbc`` forcing load (``gen_surface_forcing.F90:877-1040``):
    per variable a file prefix and a name, file = prefix + year + '.nc'
    (nc_sbc_ini_fillnames :469), bilinear interpolation to the nodes, the
    wind turned into the mesh frame; tair Kelvin -> Celsius, prec and snow
    kg/m^2/s -> m/s, CORE2 runoff constant in time (sbc_ini :1031-1037).
    ``l_mslp`` is accepted but no pressure series is carried (press_air
    stays zero, as in the JAX package).  On the mesh's device in
    ``dtype``."""
    return atm_from_arrays(sbc_forcing_arrays(mesh_geometry(mesh), sbc, year),
                           dtype, mesh.zbar.device)


class SbcProvider:
    """Year-switching forcing source with background prefetch (the
    forcing_provider_async_module analog at year granularity): while year
    Y steps, year Y+1 is read and interpolated on a host thread, in numpy
    only, and copied to the device on the caller's thread by ``get``."""

    def __init__(self, mesh, sbc, dtype=torch.float64):
        self.geom = mesh_geometry(mesh)
        self.device = mesh.zbar.device
        self.sbc = sbc
        self.dtype = dtype
        self._cache = {}         # year -> numpy series or AtmData
        self._threads = {}
        self._lock = threading.Lock()

    def _load(self, year):
        arrays = sbc_forcing_arrays(self.geom, self.sbc, year=year)
        with self._lock:
            self._cache[year] = arrays

    def prefetch(self, year):
        with self._lock:
            if year in self._cache or year in self._threads:
                return
            t = threading.Thread(target=self._load, args=(year,),
                                 daemon=True)
            self._threads[year] = t
        t.start()

    def get(self, year) -> AtmData:
        with self._lock:
            t = self._threads.pop(year, None)
        if t is not None:
            t.join()
        with self._lock:
            hit = self._cache.get(year)
        if hit is None:
            self._load(year)
            hit = self._cache[year]
        if isinstance(hit, dict):
            hit = atm_from_arrays(hit, self.dtype, self.device)
            with self._lock:
                self._cache[year] = hit
        return hit

    def evict(self, year):
        with self._lock:
            self._cache.pop(year, None)


def _vector_g2r(m, glon, glat, rlon, rlat, u, v):
    """Geographic vector components (u, v) [T, N] or [N] turned into the
    rotated frame (gen_modules_rotate_grid.F90 vector_g2r, flag=0):
    through 3D Cartesian components, rotated, projected back."""
    tg = np.array([-np.sin(glon), np.cos(glon), np.zeros_like(glon)])
    ng = np.array([-np.sin(glat) * np.cos(glon), -np.sin(glat) * np.sin(glon),
                   np.cos(glat)])
    if u.ndim == 2:
        V = u[:, None, :] * tg[None] + v[:, None, :] * ng[None]   # [T, 3, N]
    else:
        V = u * tg + v * ng
    Vr = np.einsum("ij,tjn->tin", m, V) if V.ndim == 3 else m @ V
    tr = np.array([-np.sin(rlon), np.cos(rlon), np.zeros_like(rlon)])
    nr = np.array([-np.sin(rlat) * np.cos(rlon), -np.sin(rlat) * np.sin(rlon),
                   np.cos(rlat)])
    if Vr.ndim == 3:
        return np.einsum("tin,in->tn", Vr, tr), np.einsum("tin,in->tn", Vr,
                                                          nr)
    return (Vr * tr).sum(0), (Vr * nr).sum(0)


def atm_window(atm: AtmData, t0: float, t1: float) -> AtmData:
    """Restrict the preloaded series to the model-time window [t0, t1] s.

    Keeps one bracketing row each side so _time_interp is exact inside the
    window (and clamps outside, as it already does at the series edges): a
    run segment only ever reads a few rows of a year's series."""
    def cut(series, taxis):
        t = taxis.detach().cpu().numpy()
        if len(t) < 2:
            raise ValueError("forcing series needs >= 2 time rows")
        # clamp i0 so the slice always keeps two bracketing rows even when
        # [t0, t1] lies at/after the end of the series
        i0 = min(max(0, int(t.searchsorted(t0)) - 1), len(t) - 2)
        i1 = min(len(t), int(t.searchsorted(t1)) + 1)
        i1 = max(i1, i0 + 2)                # >= 2 rows for interp
        return series[i0:i1], taxis[i0:i1]

    u, tw = cut(atm.u_wind, atm.t_wind)
    v, _ = cut(atm.v_wind, atm.t_wind)
    ta, _ = cut(atm.tair, atm.t_wind)
    q, _ = cut(atm.shum, atm.t_wind)
    sw, tr = cut(atm.swdn, atm.t_rad)
    lw, _ = cut(atm.lwdn, atm.t_rad)
    pr, tp = cut(atm.prec, atm.t_prec)
    sn, _ = cut(atm.snow, atm.t_prec)
    return dataclasses.replace(atm, u_wind=u, v_wind=v, tair=ta, shum=q,
                               t_wind=tw, swdn=sw, lwdn=lw, t_rad=tr,
                               prec=pr, snow=sn, t_prec=tp)


def _device_time(t, taxis: torch.Tensor) -> torch.Tensor:
    """The time as a 0-d tensor beside the axis.  A number is written by a
    fill kernel, not copied from host memory: such a copy would first wait
    for everything queued on the stream, once per step."""
    if isinstance(t, torch.Tensor):
        return t.to(dtype=taxis.dtype, device=taxis.device)
    return torch.full((), float(t), dtype=taxis.dtype, device=taxis.device)


def _bracket(taxis: torch.Tensor, t: torch.Tensor):
    """(rows [2] long, weight) of the linear interpolation at time t, a
    0-d tensor on the axis' device; the record index is found on the
    device (``torch.searchsorted``), with no host read."""
    T = taxis.shape[0]
    i = torch.clamp(torch.searchsorted(taxis, t) - 1, 0, T - 2)
    rows = torch.stack([i, i + 1])
    t01 = taxis[rows]
    w = torch.clamp((t - t01[0]) / torch.clamp_min(t01[1] - t01[0], 1.0),
                    0.0, 1.0)
    return rows, w


def _interp_rows(series: torch.Tensor, rows: torch.Tensor, w: torch.Tensor):
    pair = series.index_select(0, rows)
    return (1.0 - w) * pair[0] + w * pair[1]


def _time_interp(series, taxis, t):
    """Linear interpolation of [T, N] series at scalar time t [s] (clamped);
    ``t`` is a number or a 0-d tensor."""
    return _interp_rows(series, *_bracket(taxis, _device_time(t, taxis)))


def atm_state_at(atm: AtmData, t_sec):
    """Atmospheric state at model time t_sec; one bracket per time axis."""
    t = _device_time(t_sec, atm.t_wind)
    wind = _bracket(atm.t_wind, t)
    rad = _bracket(atm.t_rad, t)
    prec = _bracket(atm.t_prec, t)
    return dict(
        u_wind=_interp_rows(atm.u_wind, *wind),
        v_wind=_interp_rows(atm.v_wind, *wind),
        tair=_interp_rows(atm.tair, *wind),
        shum=_interp_rows(atm.shum, *wind),
        shortwave=_interp_rows(atm.swdn, *rad),
        longwave=_interp_rows(atm.lwdn, *rad),
        prec=_interp_rows(atm.prec, *prec),
        snow=_interp_rows(atm.snow, *prec),
        runoff=atm.runoff,
    )


def update_atm_forcing(atm: AtmData, t_sec, ice_u, ice_v, ocean_u_w,
                       ocean_v_w, sst, base: IceForcing) -> IceForcing:
    """Standalone-forcing path of update_atm_forcing (ref :255-325):
    interp to time -> NCAR bulk coefficients -> wind stresses."""
    s = atm_state_at(atm, t_sec)
    cd, ch, ce = ncar_ocean_fluxes(s["tair"], sst, s["shum"], s["u_wind"],
                                   s["v_wind"], ocean_u_w, ocean_v_w)
    # ref :305-307 uses (1-Swind)*u_w with default Swind=0 => relative wind
    dux = s["u_wind"] - ocean_u_w
    dvy = s["v_wind"] - ocean_v_w
    aux = torch.sqrt(dux ** 2 + dvy ** 2) * rhoair
    sox = cd * aux * dux
    soy = cd * aux * dvy
    dux = s["u_wind"] - ice_u
    dvy = s["v_wind"] - ice_v
    aux = torch.sqrt(dux ** 2 + dvy ** 2) * rhoair
    six = Cd_atm_ice * aux * dux
    siy = Cd_atm_ice * aux * dvy
    return dataclasses.replace(
        base, shortwave=s["shortwave"], longwave=s["longwave"],
        Tair=s["tair"], shum=s["shum"], prec_rain=s["prec"],
        prec_snow=s["snow"], runoff=s["runoff"],
        u_wind=s["u_wind"], v_wind=s["v_wind"],
        stress_atmoce_x=sox, stress_atmoce_y=soy,
        stress_atmice_x=six, stress_atmice_y=siy,
        Ch_atm_oce=ch, Ce_atm_oce=ce)
