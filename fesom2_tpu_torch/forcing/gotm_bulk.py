"""GOTM-derived bulk formulae, alternatives to the NCAR fluxes
(ref ``src/gen_surface_forcing.F90``: fairall :1328-1621 (COARE-style),
psi :1749-1812, humidity :1628-1741, back_radiation :1824-1929,
solar_zenith_angle :1941-1995, short_wave_radiation :2007-2104).

The port of ``fesom2_tpu/forcing/gotm_bulk.py``: pointwise torch functions
over node tensors; the COARE iteration is a fixed 20-sweep loop (the
reference's itermax) with its Ri <= 0.25, delw == 0 and Reynolds-range
guards folded into masks.  The coupled step wires none of them, in the
JAX package either.
"""
from __future__ import annotations

import math

import numpy as np
import torch

KELVIN = 273.16
CONST06 = 0.62198
RGAS = 287.1
CPA = 1008.0
CPW = 3985.0
KAPPA = 0.41
G = 9.81
RHO0 = 1025.0

_ES_A = (6.107799961, 4.436518521e-1, 1.428945805e-2, 2.650648471e-4,
         3.031240396e-6, 2.034080948e-8, 6.136820929e-11)

# Liu et al. roughness-Reynolds tables (ref :1340-1355)
_LIU_A = np.array([[0.177, 1.376, 1.026, 1.625, 4.661, 34.904, 1667.19,
                    588000.0],
                   [0.292, 1.808, 1.393, 1.956, 4.994, 30.709, 1448.68,
                    298000.0]])
_LIU_B = np.array([[0.0, 0.929, -0.599, -1.018, -1.475, -2.067, -2.907,
                    -3.935],
                   [0.0, 0.826, -0.528, -0.870, -1.297, -1.845, -2.682,
                    -3.616]])
_LIU_RR = np.array([0.0, 0.11, 0.825, 3.0, 10.0, 30.0, 100.0, 300.0, 1000.0])

# per-degree-latitude cloud correction (ref back_radiation :1838-1857)
_CCF = np.linspace(0.497202, 0.918668, 91)


def _esat(t_c):
    """Saturation vapor pressure [Pa] from the 7-term polynomial in deg C."""
    a1, a2, a3, a4, a5, a6, a7 = _ES_A
    es = a1 + t_c * (a2 + t_c * (a3 + t_c * (a4 + t_c
                     * (a5 + t_c * (a6 + t_c * a7)))))
    return es * 100.0


def humidity(hum_method: int, hum, airp, tw, ta):
    """(qa, qs, rhoa, ea, es); tw/ta in deg C, airp in Pa
    (ref humidity :1628-1741)."""
    es = 0.98 * _esat(tw)
    qs = CONST06 * es / (airp - 0.377 * es)
    if hum_method == 1:            # relative humidity [%]
        ea = 0.01 * hum * _esat(ta)
        qa = CONST06 * ea / (airp - 0.377 * ea)
    elif hum_method == 2:          # wet-bulb temperature
        twet = torch.where(hum < 100.0, hum, hum - KELVIN)
        ea = _esat(twet) - 6.6e-4 * (1 + 1.15e-3 * twet) * airp * (ta - twet)
        qa = CONST06 * ea / (airp - 0.377 * ea)
    elif hum_method == 3:          # dew-point temperature
        dew = torch.where(hum < 100.0, hum, hum - KELVIN)
        ea = _esat(dew)
        qa = CONST06 * ea / (airp - 0.377 * ea)
    elif hum_method == 4:          # specific humidity given
        qa = hum
        ea = qa * airp / (CONST06 + 0.378 * qa)
    else:
        raise ValueError(f"hum_method {hum_method}")
    rhoa = airp / (RGAS * (ta + KELVIN) * (1.0 + CONST06 * qa))
    return qa, qs, rhoa, ea, es


def psi(iflag: int, ZoL):
    """Stability function for wind (iflag=1) / scalar (2) profiles
    (ref psi :1749-1812)."""
    r3 = 1.0 / 3.0
    sqr3 = 1.7320508
    chik = torch.clamp_min(1.0 - 16.0 * ZoL, 1e-12) ** 0.25
    if iflag == 1:
        psik = (2.0 * torch.log(0.5 * (1.0 + chik))
                + torch.log(0.5 * (1.0 + chik * chik))
                - 2.0 * torch.atan(chik) + 0.5 * math.pi)
    else:
        psik = 2.0 * torch.log(0.5 * (1.0 + chik * chik))
    chic = torch.clamp_min(1.0 - 12.87 * ZoL, 1e-12) ** r3
    psic = (1.5 * torch.log(r3 * (1.0 + chic + chic * chic))
            - sqr3 * torch.atan((1.0 + 2.0 * chic) / sqr3) + math.pi / sqr3)
    Fw = 1.0 / (1.0 + ZoL * ZoL)
    unstable = Fw * psik + (1.0 - Fw) * psic
    return torch.where(ZoL < 0.0, unstable,
                       torch.where(ZoL > 0.0, -4.7 * ZoL, 0.0))


def fairall(sst, airt, u10, v10, precip, qs, qa, rhoa,
            rain_impact: bool = True, calc_evaporation: bool = True):
    """COARE-style bulk fluxes (ref fairall :1328-1621).

    Returns (evap [m/s], taux, tauy [N/m^2], qe sensible, qh latent [W/m^2]).
    Temperatures accepted in deg C or K.
    """
    zt = zq = 2.0
    zw = 10.0
    beta, Zabl, fdg = 1.2, 600.0, 1.0
    tw = torch.where(sst < 100.0, sst, sst - KELVIN)
    ta = torch.where(airt < 100.0, airt, airt - KELVIN)
    ta_k = ta + KELVIN

    w = torch.sqrt(u10 * u10 + v10 * v10)
    delw = torch.clamp_min(w, 1e-8)
    vis_air = 1.326e-5 * (1.0 + ta * (6.542e-3
                                      + ta * (8.301e-6 - 4.84e-9 * ta)))
    L = (2.501 - 0.00237 * tw) * 1.0e6
    delq = qa - qs
    delt = ta - tw
    Wstar = 0.04 * delw
    Tstar = 0.04 * delt
    Qstar = 0.04 * delq
    TVstar = Tstar * (1.0 + 0.61 * qa) + 0.61 * ta_k * Qstar
    ri = G * zw * (delt + 0.61 * ta_k * delq) / (ta_k * delw * delw)

    f = lambda a: torch.as_tensor(a, dtype=w.dtype, device=w.device)
    liu_rr, liu_a, liu_b = f(_LIU_RR), f(_LIU_A), f(_LIU_B)
    wgus = torch.zeros_like(w)
    for _ in range(20):
        oL = G * KAPPA * TVstar / (ta_k * (1.0 + 0.61 * qa)
                                   * torch.clamp_min(Wstar * Wstar, 1e-12))
        wpsi = psi(1, zw * oL)
        tpsi = psi(2, zt * oL)
        qpsi = psi(2, zq * oL)
        ZoW = 0.011 * Wstar * Wstar / G \
            + 0.11 * vis_air / torch.clamp_min(Wstar, 1e-12)
        Wstar = delw * KAPPA / (torch.log(zw / ZoW) - wpsi)
        rr = torch.clamp(ZoW * Wstar / vis_air, 1e-12, 999.999)
        k = torch.clamp(torch.searchsorted(liu_rr, rr, right=True) - 1, 0, 7)
        rt = liu_a[0, k] * rr ** liu_b[0, k]
        rq = liu_a[1, k] * rr ** liu_b[1, k]
        cff = vis_air / torch.clamp_min(Wstar, 1e-12)
        Tstar = delt * KAPPA * fdg / (torch.log(zt / (rt * cff)) - tpsi)
        Qstar = delq * KAPPA * fdg / (torch.log(zq / (rq * cff)) - qpsi)
        TVstar = Tstar * (1.0 + 0.61 * qa) + 0.61 * ta_k * Qstar
        bf = -G / ta_k * Wstar * TVstar
        wgus = torch.where(bf > 0.0, beta * (bf * Zabl) ** (1.0 / 3.0), 0.0)
        delw = torch.sqrt(w * w + wgus * wgus)

    Wspeed = torch.sqrt(w * w + wgus * wgus)
    Cd = Wstar * Wstar / torch.clamp_min(Wspeed * Wspeed, 1e-12)
    qe = CPA * rhoa * Wstar * Tstar
    rainfall = precip * 1000.0
    if rain_impact:
        x1 = 2.11e-5 * (ta_k / KELVIN) ** 1.94
        x2 = 0.02411 * (1.0 + ta * (3.309e-3 - 1.44e-6 * ta)) / (rhoa * CPA)
        x3 = qa * L / (RGAS * ta_k * ta_k)
        cd_rain = 1.0 / (1.0 + CONST06 * (x3 * L * x1) / (CPA * x2))
        cd_rain = cd_rain * CPW * ((tw - ta) + (qs - qa) * L / CPA)
        qe = qe - rainfall * cd_rain
    qh = L * rhoa * Wstar * Qstar
    upvel = -1.61 * Wstar * Qstar \
        - (1.0 + 1.61 * qa) * Wstar * Tstar / ta_k
    qh = qh - rhoa * L * upvel * qa
    evap = rhoa / RHO0 * Wstar * Qstar \
        if (rain_impact and calc_evaporation) else torch.zeros_like(w)
    cff = rhoa * Cd * Wspeed
    taux = cff * u10
    tauy = cff * v10
    if rain_impact:
        taux = taux + 0.85 * rainfall * u10
        tauy = tauy + 0.85 * rainfall * v10

    # reference guards: calm winds or Ri>0.25 -> no fluxes
    ok = (w > 0.0) & (ri <= 0.25)
    z = torch.zeros_like(w)
    return (torch.where(ok, evap, z), torch.where(ok, taux, z),
            torch.where(ok, tauy, z), torch.where(ok, qe, z),
            torch.where(ok, qh, z))


def back_radiation(method: int, dlat, tw_k, ta_k, cloud, ea, qa):
    """Net longwave back radiation [W/m^2], negative up
    (ref back_radiation :1824-1929). tw_k/ta_k in Kelvin, dlat degrees."""
    emiss, bolz = 0.97, 5.67e-8
    ccf = torch.as_tensor(_CCF, dtype=tw_k.dtype, device=tw_k.device)[
        torch.clamp(torch.round(torch.abs(dlat)).long(), 0, 90)]
    if method == 1:       # Clark et al. 1974
        x1 = (1.0 - ccf * cloud * cloud) * tw_k ** 4
        x2 = 0.39 - 0.05 * torch.sqrt(ea * 0.01)
        x3 = 4.0 * tw_k ** 3 * (tw_k - ta_k)
        return -emiss * bolz * (x1 * x2 + x3)
    if method == 2:       # Hastenrath & Lamb 1978
        x1 = (1.0 - ccf * cloud * cloud) * tw_k ** 4
        x2 = 0.39 - 0.056 * torch.sqrt(1000.0 * qa)
        x3 = 4.0 * tw_k ** 3 * (tw_k - ta_k)
        return -emiss * bolz * (x1 * x2 + x3)
    if method == 3:       # Bignami et al. 1995
        x1 = (1.0 + 0.1762 * cloud * cloud) * ta_k ** 4
        x2 = 0.653 + 0.00535 * (ea * 0.01)
        x3 = emiss * tw_k ** 4
        return -bolz * (-x1 * x2 + x3)
    if method == 4:       # Berliand & Berliand 1952
        x1 = (1.0 - 0.6823 * cloud * cloud) * ta_k ** 4
        x2 = 0.39 - 0.05 * torch.sqrt(0.01 * ea)
        x3 = 4.0 * ta_k ** 3 * (tw_k - ta_k)
        return -emiss * bolz * (x1 * x2 + x3)
    raise ValueError(f"back_radiation method {method}")


def solar_zenith_angle(yday, hh, dlon, dlat):
    """Solar zenith angle [deg] (ref :1941-1995)."""
    rlon = torch.deg2rad(dlon)
    rlat = torch.deg2rad(dlat)
    th0 = 2.0 * math.pi * yday / 365.25
    sundec = (0.006918 - 0.399912 * torch.cos(th0) + 0.070257 * torch.sin(th0)
              - 0.006758 * torch.cos(2 * th0) + 0.000907 * torch.sin(2 * th0)
              - 0.002697 * torch.cos(3 * th0) + 0.001480 * torch.sin(3 * th0))
    thsun = (hh - 12.0) * 15.0 * math.pi / 180.0 + rlon
    coszen = torch.clamp_min(torch.sin(rlat) * torch.sin(sundec)
                             + torch.cos(rlat) * torch.cos(sundec)
                             * torch.cos(thsun), 0.0)
    return torch.rad2deg(torch.acos(coszen))


def short_wave_radiation(zenith_angle, yday, dlon, dlat, cloud):
    """Net clear-sky+cloud shortwave [W/m^2] (Rosati & Miyakoda style,
    ref :2007-2104)."""
    solar, tau, aozone, eclips = 1350.0, 0.7, 0.09, math.radians(23.439)
    coszen = torch.cos(torch.deg2rad(zenith_angle))
    qatten = torch.where(coszen <= 0.0, 0.0,
                         tau ** (1.0 / torch.clamp_min(coszen, 1e-12)))
    coszen = torch.clamp_min(coszen, 0.0)
    qzer = coszen * solar
    qdir = qzer * qatten
    qdiff = ((1.0 - aozone) * qzer - qdir) * 0.5
    qtot = qdir + qdiff
    rlat = torch.deg2rad(dlat)
    eqnx = (yday - 81.0) / 365.0 * 2.0 * math.pi
    sunbet = torch.rad2deg(torch.asin(
        torch.sin(rlat) * torch.sin(eclips * torch.sin(eqnx))
        + torch.cos(rlat) * torch.cos(eclips * torch.sin(eqnx))))
    qshort = qtot * (1.0 - 0.62 * cloud + 0.0019 * sunbet)
    return torch.minimum(qshort, qtot)
