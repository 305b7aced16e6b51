"""Atmospheric forcing on the device: nodal time series, their
interpolation to the model time, bulk coefficients and wind stresses.

The port of the device side of ``fesom2_tpu/forcing/atmos.py`` (``AtmData``,
``atm_window``, ``_time_interp``, ``atm_state_at``, ``update_atm_forcing``;
reference: the standalone branch of update_atm_forcing,
``src/gen_forcing_couple.F90:255-325``, and data_timeinterp,
``src/gen_surface_forcing.F90:851``).  The file readers of that module
(``load_core_forcing``, ``load_sbc_forcing``, ``SbcProvider``) are not
ported: no forcing files come with the repository, and a series is built
in code (``run.globe_atm_data``) or carried over from numpy arrays
(``convert.atm_from_numpy``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..ice.state import IceForcing, rhoair
from .bulk import ncar_ocean_fluxes

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
