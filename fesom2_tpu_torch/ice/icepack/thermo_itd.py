"""ITD thermodynamics: frazil new-ice formation and lateral melt.

The port of ``fesom2_tpu/ice/icepack/thermo_itd.py`` (step_therm2 of the
reference driver, icedrv_step.F90:296-384; physics of icepack_therm_itd).
"""
from __future__ import annotations

import math

import torch

from . import constants as c
from .state import enthalpy_ice, salinity_profile


def add_new_ice(cfg, aicen, vicen, vsnon, Tsfcn, qin, qsn, frzmlt, Tf, dt):
    """Frazil ice formation from the ocean freezing potential.

    frzmlt [W/m^2] >= 0: energy the ocean must shed to return to its
    freezing point.  New ice forms at Tf with the BL99 salinity profile,
    first filling open water at ``hfrazilmin`` thickness, any surplus
    volume thickening category 1.

    Returns (arrays..., vi0new [m ice/s·dt], heat released to the ocean
    [W/m^2])."""
    sal = torch.as_tensor(salinity_profile(cfg.nilyr),
                          device=aicen.device).to(aicen.dtype)
    Tfc = torch.clamp_max(Tf, -c.mu_liq * c.saltmax - 0.05)
    qi0 = enthalpy_ice(Tfc[None, :], sal[:, None])        # [nilyr, N] (<0)
    qi0bar = qi0.mean(0)
    vi0new = torch.clamp_min(frzmlt, 0.0) * dt \
        / torch.clamp_min(-qi0bar, c.puny)
    fhocn_frazil = vi0new * (-qi0bar) / dt                # == max(frzmlt,0)

    aice0 = torch.clamp(1.0 - aicen.sum(0), 0.0, 1.0)
    ai0new = torch.minimum(vi0new / c.hfrazilmin, aice0)

    a1, v1 = aicen[0], vicen[0]
    a_new = a1 + ai0new
    v_new = v1 + vi0new
    qin1 = torch.where(v_new[None] > c.puny,
                       (qin[0] * v1[None] + qi0 * vi0new[None])
                       / torch.clamp_min(v_new[None], c.puny), qin[0])
    Tsf1 = torch.where(a_new > c.puny,
                       (Tsfcn[0] * a1 + Tfc * ai0new)
                       / torch.clamp_min(a_new, c.puny), Tsfcn[0])

    aicen = torch.cat([a_new[None], aicen[1:]])
    vicen = torch.cat([v_new[None], vicen[1:]])
    qin = torch.cat([qin1[None], qin[1:]])
    Tsfcn = torch.cat([Tsf1[None], Tsfcn[1:]])
    return aicen, vicen, vsnon, Tsfcn, qin, qsn, vi0new / dt, fhocn_frazil


def lateral_melt(cfg, aicen, vicen, vsnon, Tsfcn, qin, qsn, sst, Tf,
                 melt_pot, dt, rside_scale=None):
    """Lateral (floe-edge) melt, Steele (1992) closure.

    melt_pot [W/m^2] >= 0: available ocean melting potential.  Each
    category loses the fraction rside of both area and volume; the melt
    energy demand is capped by melt_pot.

    rside_scale [ncat, N] (optional): per-category multiplier on rside —
    the FSD feedback replacing the constant floediam with the resolved
    mean inverse floe diameter (fsd.fsd_lateral_melt_scale).

    Returns (arrays..., dfresh [kg/m^2/s], dfsalt [kg/m^2/s],
    dfhocn [W/m^2, negative: heat drawn from the ocean])."""
    nilyr, nslyr = qin.shape[1], qsn.shape[1]
    deltaT = torch.clamp_min(sst - Tf, 0.0)
    wlat = c.m1_lat * deltaT ** c.m2_lat
    rside = torch.clamp(wlat * dt * math.pi / (c.alpha_floe * c.floediam),
                        0.0, 1.0)[None, :] * torch.ones_like(aicen)
    if rside_scale is not None:
        rside = torch.clamp(rside * rside_scale, 0.0, 1.0)

    ei = (qin * (vicen / nilyr)[:, None, :]).sum(1)       # J/m^2 (<0)
    es = (qsn * (vsnon / nslyr)[:, None, :]).sum(1)
    demand = (rside * -(ei + es)).sum(0)                  # J/m^2 needed
    avail = torch.clamp_min(melt_pot, 0.0) * dt
    scale = torch.where(demand > c.puny,
                        torch.clamp_max(avail
                                        / torch.clamp_min(demand, c.puny),
                                        1.0), 1.0)
    rside = rside * scale[None, :]

    dfresh = (rside * (c.rhoi * vicen + c.rhos * vsnon)).sum(0) / dt
    dfsalt = (rside * c.rhoi * vicen).sum(0) * c.ice_ref_salinity * 1e-3 / dt
    dfhocn = (rside * (ei + es)).sum(0) / dt              # negative

    keep = 1.0 - rside
    return (aicen * keep, vicen * keep, vsnon * keep, Tsfcn, qin, qsn,
            dfresh, dfsalt, dfhocn)
