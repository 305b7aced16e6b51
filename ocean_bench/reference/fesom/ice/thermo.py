# Frozen copy of fesom2_tpu_torch/ice/thermo.py, lines 1-207 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""0-layer sea-ice thermodynamics (Parkinson-Washington / Semtner).

The port of ``fesom2_tpu/ice/thermo.py``.  Reference:
``src/ice_thermo_oce.F90`` - thermodynamics :76-219, therm_ice :223-449,
budget :453-554 (Newton iteration for ice surface temperature), obudget
:558-624, flooding :628-644, TFrez :648-657.

Vectorised over nodes and over the 7 ice-thickness classes, which are
independent of each other (each starts its Newton iteration from the same
surface temperature): ``budget`` takes the classes' thicknesses as
[7, N] and is called once, where the JAX package unrolls seven calls; the
classes' growth rates are then added in class order, as there.  The 5
Newton iterations are a small Python loop of elementwise ops.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from ..mesh import MeshTables
from .state import (IceState, IceForcing, OceanSurface, rhoair, inv_rhoair,
                    inv_rhowat, rhoice, inv_rhoice, rhosno, inv_rhosno,
                    cpair, cc, cl, clhw, clhi, tmelt, boltzmann, Sice,
                    iclasses, hmin, Armin, Ch_atm_ice, Ce_atm_ice)


def tfrez(S):
    """Freezing temperature of sea water (Millero 1978)."""
    return -0.0575 * S + 1.7105e-3 * torch.sqrt(torch.clamp_min(S, 0.0) ** 3) \
        - 2.155e-4 * S * S


def obudget(qa, fsh, flo, t, ug, ta, ch, ce, emiss_wat, albw):
    """Open-water growth rate (ref obudget :558-624)."""
    c1, c4, c5 = 3.8e-3, 17.27, 237.3
    b = c1 * torch.exp(c4 * t / (t + c5))
    hflwrdout = -emiss_wat * boltzmann * (t + tmelt) ** 4
    hfradow = (1.0 - albw) * fsh + flo + hflwrdout
    hfsenow = rhoair * cpair * ch * ug * (ta - t)
    evap = rhoair * ce * ug * (qa - b)
    hflatow = clhw * evap
    hftotow = hfradow + hfsenow + hflatow
    fh = -hftotow / cl
    evap = evap * inv_rhowat
    return fh, evap, hflatow, hfsenow, hflwrdout


def budget(hice, hsn, t, ta, qa, fsh, flo, ug, S_oc, emiss_ice,
           albsn, albsnm, albi, albim, con):
    """Thick-ice growth rate with Newton iteration for the surface T
    (ref budget :453-554). Returns (fh, t_new, subli).  ``hice`` may carry
    leading axes ([classes, N]); the other fields broadcast against it."""
    q1, q2 = 11637800.0, -5897.8
    freezing = t < 0.0
    snow = hsn > 0.0
    const = lambda value: torch.full_like(t, value)
    alb = torch.where(freezing, torch.where(snow, const(albsn), const(albi)),
                      torch.where(snow, const(albsnm), const(albim)))
    d1 = rhoair * cpair * Ch_atm_ice
    d2 = rhoair * Ce_atm_ice
    d3 = d2 * clhi
    A1 = (1.0 - alb) * fsh + flo + d1 * ug * ta + d3 * ug * qa
    tf = tfrez(S_oc)
    hice_s = torch.clamp_min(hice, 1e-6)
    for _ in range(5):
        B = q1 * inv_rhoair * torch.exp(q2 / (t + tmelt))
        A2 = -d1 * ug * t - d3 * ug * B - emiss_ice * boltzmann * (t + tmelt) ** 4
        A3 = -d3 * ug * B * q2 / ((t + tmelt) ** 2)
        C = con / hice_s
        A3 = A3 + C + d1 * ug + 4.0 * emiss_ice * boltzmann * (t + tmelt) ** 3
        C = C * (tf - t)
        t = t + (A1 + A2 + C) / A3
    t = torch.clamp_max(t, 0.0)
    B = q1 * inv_rhoair * torch.exp(q2 / (t + tmelt))
    hfrad = (1.0 - alb) * fsh + flo - emiss_ice * boltzmann * (t + tmelt) ** 4
    hfsen = d1 * ug * (ta - t)
    subli = d2 * ug * (qa - B)
    hflat = clhi * subli
    hftot = hfrad + hfsen + hflat
    fh = -hftot / cl
    subli = subli * inv_rhowat
    return fh, t, subli


def thermodynamics(ice: IceState, mesh: MeshTables, forcing: IceForcing,
                   ocean: OceanSurface, cfg, use_virt_salt: bool,
                   ref_sss: float = 34.0, ref_sss_local: bool = False
                   ) -> IceState:
    """Vectorised therm_ice over all nodes (ref :76-449)."""
    icfg = cfg.ice
    ice_dt = cfg.dt * icfg.ice_ave_steps
    h = ice.m_ice
    hsn = ice.m_snow
    A = ice.a_ice
    a_old = A

    ustar = torch.sqrt(((ice.u_ice - ocean.u_w) ** 2
                        + (ice.v_ice - ocean.v_w) ** 2) * icfg.Cd_oce_ice)
    ug = torch.sqrt(forcing.u_wind ** 2 + forcing.v_wind ** 2)
    T_oc, S_oc = ocean.T_oc, ocean.S_oc
    rsss = S_oc if ref_sss_local else ref_sss
    h_ml = 2.5
    lid_clo = 0.5          # ref :176-180 (h0 overridden to 0.5 both hemis)
    t = ice.t_skin
    Ta = forcing.Tair

    # rain/snow split when no snow file (ref :143-157)
    rain = torch.where(Ta >= 0.0, forcing.prec_rain, 0.0)
    snow = torch.where(Ta >= 0.0, 0.0, forcing.prec_rain)

    dhgrowth = h
    thick = hsn * (icfg.con / icfg.consn) / torch.clamp_min(A, Armin)
    thick = thick + h / torch.clamp_min(A, Armin)

    # open-water growth
    rhow, evap, _, _, _ = obudget(
        forcing.shum, forcing.shortwave, forcing.longwave, T_oc, ug, Ta,
        forcing.Ch_atm_oce, forcing.Ce_atm_oce, icfg.emiss_wat, icfg.albw)

    # ice-covered growth over 7 thickness classes (ref :302-314)
    odd = torch.arange(1, 2 * iclasses, 2, dtype=h.dtype, device=h.device)
    thact = odd[:, None] * thick / iclasses               # [7, N]
    shice, t_k, subli_k = budget(thact, hsn, t, Ta, forcing.shum,
                                 forcing.shortwave, forcing.longwave, ug,
                                 S_oc, icfg.emiss_ice, icfg.albsn,
                                 icfg.albsnm, icfg.albi, icfg.albim,
                                 icfg.con)
    rhice, subli = shice[0], subli_k[0]
    for k in range(1, iclasses):
        rhice = rhice + shice[k]
        subli = subli + subli_k[k]
    t_new = t_k[-1]      # last class's Newton temperature becomes t (ref t inout)
    has_thick = thick > hmin
    rhice = torch.where(has_thick, rhice / iclasses, 0.0)
    subli = torch.where(has_thick, subli / iclasses, 0.0)
    t = torch.where(has_thick, t_new, t)

    rhow = rhow * ice_dt
    rhice = rhice * ice_dt
    show = rhow * (1.0 - A)
    shice = rhice * A
    sh = show + shice
    ahf = -cl * sh / ice_dt
    prec = rain + forcing.runoff + snow * (1.0 - A)
    hsn = hsn + snow * ice_dt * A * 1000.0 * inv_rhosno
    dhsngrowth = hsn
    evap = evap * (1.0 - A)
    subli = subli * A

    hsntmp = torch.minimum(-torch.clamp_max(sh, 0.0) * rhoice * inv_rhosno, hsn)
    hsn = hsn - hsntmp
    rh = sh + hsntmp * rhosno * inv_rhoice
    h = torch.clamp_min(h, 0.0)

    # ocean-to-ice heat flux (ref :386-389)
    tf = tfrez(S_oc)
    o2ihf = (T_oc - tf) * 0.006 * ustar * cc * A \
        + (T_oc - tf) * h_ml / ice_dt * cc * (1.0 - A)
    rh = rh - o2ihf * ice_dt / cl
    qhst = h + rh

    sn = torch.clamp_min(hsn + torch.clamp_max(qhst, 0.0) * rhoice * inv_rhosno,
                         0.0)
    hsn = sn
    h = torch.clamp_min(qhst, 0.0)
    h = torch.where(h < 1e-6, 0.0, h)

    dhgrowth = (h - dhgrowth) / ice_dt
    dhsngrowth = (hsn - dhsngrowth) / ice_dt
    ehf = ahf + cl * (dhgrowth + (rhosno / rhoice) * dhsngrowth)

    if not use_virt_salt:
        fw = prec + evap - dhgrowth * rhoice * inv_rhowat \
            - dhsngrowth * rhosno * inv_rhowat
        rsf = -dhgrowth * rhoice * inv_rhowat * Sice
    else:
        fw = prec + evap \
            - dhgrowth * rhoice * inv_rhowat * (rsss - Sice) / rsss \
            - dhsngrowth * rhosno * inv_rhowat
        rsf = torch.zeros_like(fw)

    # compactness update (ref :424-432)
    rh = -torch.minimum(h, -rh)
    rA = rhow - o2ihf * ice_dt / cl
    A = A + 0.5 * torch.clamp_max(rh, 0.0) * A / torch.clamp_min(h, hmin) \
        + torch.clamp_min(rA, 0.0) * (1.0 - A) / lid_clo
    A = torch.minimum(A, h * 1.0e6)
    A = torch.clamp(A, 0.0, 1.0)

    # flooding (ref :434-445)
    iflice = h
    hdraft = (rhosno * hsn + h * rhoice) * inv_rhowat
    hflood = hdraft - torch.minimum(hdraft, h)
    h = h + hflood
    hsn = hsn - hflood * rhoice * inv_rhosno
    iflice = (h - iflice) / ice_dt
    if not use_virt_salt:
        rsf = rsf - iflice * rhoice * inv_rhowat * Sice
    else:
        fw = fw + iflice * rhoice * inv_rhowat * Sice / rsss

    evap = evap + subli
    return replace(ice, m_ice=h, m_snow=hsn, a_ice=A, t_skin=t,
                   fresh_wa_flux=fw, net_heat_flux=ehf, evaporation=evap,
                   thdgr=dhgrowth, thdgrsn=dhsngrowth, flice=iflice,
                   real_salt_flux=rsf, a_ice_old=a_old)
