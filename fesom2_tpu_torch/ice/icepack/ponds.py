"""Melt ponds (CESM scheme) and the simple aux tracers (age, first-year
area, level-ice partition).

The port of ``fesom2_tpu/ice/icepack/ponds.py``.  Reference behavior: the
pond/tracer options of the Icepack library selected by
``config/namelist.icepack.cesm.ponds`` (trpnd=1, tr_pond_cesm=.true.) and
the tracer_nml switches tr_iage / tr_FY / tr_lvl
(``config/namelist.icepack:31-38``).  The CESM pond parameterization
follows Holland et al. 2012: a fraction r = rfracmin + (rfracmax -
rfracmin) * aice of each category's surface melt water is retained in
ponds; the pond volume decays exponentially when the surface temperature
drops below Tp = -Td_pond; pond geometry follows a fixed aspect ratio
h_p = pndaspect * a_p; ponds are removed on thin ice and the depth is
capped at dpthhi * h_i.  Pond water is "virtual" (l_mpond_fresh=.false.):
it never alters the freshwater budget, only the surface albedo.
"""
from __future__ import annotations

import torch

from . import constants as c


def compute_ponds_cesm(ipc, aicen, vicen, Tsfcn, meltt, melts, apnd, hpnd):
    """Advance the per-category pond tracers one step.

    meltt/melts: per-category top ice / snow melt this step [m per unit
    category area]; apnd: pond area fraction OF the category area;
    hpnd: pond depth [m].  Returns (apnd, hpnd)."""
    has = aicen > c.puny
    hi = torch.where(has, vicen / torch.clamp_min(aicen, c.puny), 0.0)
    aice = torch.clamp(aicen.sum(0), 0.0, 1.0)

    # retained surface melt water [m over category area]
    rfrac = ipc.rfracmin + (ipc.rfracmax - ipc.rfracmin) * aice
    dvol = rfrac[None, :] * (meltt * c.rhoi + melts * c.rhos) / c.rhow

    volp = apnd * hpnd + dvol
    # exponential refreezing below Tp (Tp = Timelt - Td < 0, factor <= 1)
    Tp = -ipc.Td_pond
    dTs = torch.clamp_min(Tp - Tsfcn, 0.0)
    volp = volp * torch.exp(ipc.rexp_pond * dTs / Tp)

    # geometry: V = pndaspect * a_p^2  =>  a_p = sqrt(V / pndaspect)
    apnd_new = torch.sqrt(torch.clamp_min(volp, 0.0) / ipc.pndaspect)
    apnd_new = torch.clamp(apnd_new, 0.0, 1.0)
    hpnd_new = ipc.pndaspect * apnd_new
    # cap the depth at a fraction of the ice thickness (excess drains)
    hcap = ipc.dpthhi * hi
    apnd_new = torch.where(hpnd_new > hcap,
                           torch.where(hcap > c.puny,
                                       volp / torch.clamp_min(hcap, c.puny),
                                       0.0),
                           apnd_new)
    apnd_new = torch.clamp(apnd_new, 0.0, 1.0)
    hpnd_new = torch.minimum(hpnd_new, hcap)

    # ponds only on substantial ice
    ok = has & (hi >= ipc.hi_min_pond)
    apnd_new = torch.where(ok, apnd_new, 0.0)
    hpnd_new = torch.where(ok, hpnd_new, 0.0)
    return apnd_new, hpnd_new


def advance_age(iage, aicen, dt):
    """Ice age tracer: existing ice ages by dt each step (volume-weighted
    transport handles mixing)."""
    return torch.where(aicen > c.puny, iage + dt, 0.0)


def reset_first_year(FY, lat, yday):
    """Zero the first-year area tracer once a year at the end of the melt
    season: NH on day 258 (Sept 15), SH on day 74 (March 15) — the CICE
    convention.  yday: day-of-year, a number or a 0-d tensor; lat [N]
    radians."""
    if isinstance(yday, torch.Tensor):
        yday = yday.to(lat.device, lat.dtype)
        near = lambda day: (yday - day).abs() < 0.5
    else:
        near = lambda day: abs(yday - day) < 0.5
    north = lat > 0.0
    hit = ((north & near(258.0)) | (~north & near(74.0)))[None, :]
    return torch.where(hit, 0.0, FY)


def new_ice_values(ipc) -> tuple:
    """({area tracer: value}, {volume tracer: value}) of new frazil ice:
    first-year and level, no ponds, age 0; FSD area in the smallest bin
    under a wave field (pancakes), else the largest (consolidated growth);
    the mixed-layer nutrients and the algal seed trapped."""
    new_val_a = {"apnd": 0.0, "hpnd": 0.0, "FY": 1.0, "alvl": 1.0}
    if getattr(ipc, "tr_fsd", False):
        tgt = 0 if ipc.wave_spec else ipc.nfsd - 1
        new_val_a.update({f"fsd{k:02d}": (1.0 if k == tgt else 0.0)
                          for k in range(ipc.nfsd)})
    if getattr(ipc, "tr_bgc", False):
        from .bgc import bgc_defaults
        new_val_a.update(bgc_defaults(ipc))
    return new_val_a, {"vlvl": 1.0, "iage": 0.0}


def dilute_on_new_ice(ipc, ta, tv, a_before, a_after, v_before, v_after):
    """Aux-tracer update when frazil adds (a_after - a_before) of new ice
    area / volume to a category: intensive area tracers dilute; new ice is
    first-year and level (FY/alvl mix toward 1), ponds toward 0, age
    toward 0, new volume is level (vlvl toward 1)."""
    new_val_a, new_val_v = new_ice_values(ipc)
    if ta.shape[1]:
        da = torch.clamp_min(a_after - a_before, 0.0)
        aw = torch.clamp_min(a_after, c.puny)
        vals = torch.tensor([new_val_a[n] for n in ipc.area_tracers],
                            dtype=ta.dtype, device=ta.device)[None, :, None]
        ta = torch.where(a_after[:, None, :] > c.puny,
                         (ta * a_before[:, None, :] + vals * da[:, None, :])
                         / aw[:, None, :], ta)
    if tv.shape[1]:
        dv = torch.clamp_min(v_after - v_before, 0.0)
        vw = torch.clamp_min(v_after, c.puny)
        vals = torch.tensor([new_val_v[n] for n in ipc.vol_tracers],
                            dtype=tv.dtype, device=tv.device)[None, :, None]
        tv = torch.where(v_after[:, None, :] > c.puny,
                         (tv * v_before[:, None, :] + vals * dv[:, None, :])
                         / vw[:, None, :], tv)
    return ta, tv


def pond_albedo_adjust(ipc, albedo, fswsfc, apnd, hpnd, hs, sw):
    """Pond-aware surface albedo adjustment (the role dEdd shortwave plays
    for the CESM ponds; a parameterized fit in the spirit of Briegleb &
    Light 2007).  The ponded fraction of the (snow-free part of the)
    category has albedo relaxing from the bare-ice value to a deep-pond
    albedo with e-folding depth h_e.  Returns (albedo, fswsfc) with the
    extra absorbed shortwave deposited at the surface."""
    alb_deep = 0.20          # broadband deep-pond albedo
    h_e = 0.10               # e-folding pond depth [m]
    snow_free = torch.exp(-hs / max(ipc.snowpatch, 1e-6))  # pond visibility
    ap_eff = apnd * snow_free
    alb_p = alb_deep + (albedo - alb_deep) * torch.exp(-hpnd / h_e)
    alb_new = (1.0 - ap_eff) * albedo \
        + ap_eff * torch.minimum(alb_p, albedo)
    fswsfc_new = fswsfc + (albedo - alb_new) * sw
    return alb_new, fswsfc_new
