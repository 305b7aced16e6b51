# Frozen copy of fesom2_tpu_torch/ice/thermo_cpl.py, lines 1-162 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""Coupled-mode ice thermodynamics (Dorn et al. 2009).

The port of ``fesom2_tpu/ice/thermo_cpl.py``.  Reference:
``src/ice_thermo_cpl.F90`` (__oasis build): ``thermodynamics`` :1-175 and
the contained ``ice_growth`` :182-448.  It replaces the bulk-formula
0-layer scheme where an atmosphere model provides the heat and freshwater
fluxes over ice and open water separately, through a coupler.  Column
local: plain torch, vectorised over nodes.  ``ice.step.ice_timestep_cpl``
calls it on the fluxes ``coupler.CplDriver.recv`` builds.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from .state import IceState, OceanSurface, rhowat, rhoice, rhosno, cc, cl, \
    Sice

# Dorn 2009 scheme parameters (ref :88-232)
AIMIN = 0.001
HIMIN = 0.005
HCUTOFF = 1.0e-6
BIGVAL = 1.0e10
GAMMA_T = 10.0 / 86400.0    # mixed-layer heat transfer rate [m/s]
RHOFWT = 1000.0


@dataclass
class CoupledAtmFluxes:
    """The surface fluxes an atmosphere model provides, per node: the
    cpl_recv set of ``cpl_driver.F90:401-426`` mapped onto forcing arrays
    (``gen_forcing_couple.F90:99-170``)."""
    oce_heat_flux: torch.Tensor   # heat_oce: net heat into open water [W/m2]
    ice_heat_flux: torch.Tensor   # heat_ico: net heat over ice [W/m2]
    shortwave: torch.Tensor       # heat_swo
    evap_no_ifrac: torch.Tensor   # evap_oce (potential, <= 0) [m/s]
    sublimation: torch.Tensor     # subl_oce [m/s]
    prec_rain: torch.Tensor       # prec_oce [m/s]
    prec_snow: torch.Tensor       # snow_oce [m/s]
    runoff: torch.Tensor          # hydr_oce [m/s]


def thermodynamics_cpl(ice: IceState, atm: CoupledAtmFluxes,
                       ocean: OceanSurface, cfg, use_virt_salt: bool,
                       ref_sss: float = 34.0, ref_sss_local: bool = False,
                       h0min: float = 0.5, h0max: float = 1.5) -> IceState:
    """One thermodynamic step of the Dorn 2009 scheme (ref ice_growth).
    The lead-closing parameters default to the non-OIFS branch (h0min =
    0.5, h0max = 1.5, ref :91)."""
    dt = cfg.dt
    ic = cfg.ice
    A0 = ice.a_ice
    A, h, hsn = ice.a_ice, ice.m_ice, ice.m_snow

    # total evaporation for the salt balance (ref :100)
    evaporation = atm.evap_no_ifrac * (1.0 - A0) + atm.sublimation * A0

    T_oc, S_oc = ocean.T_oc, ocean.S_oc
    rsss = S_oc if ref_sss_local else torch.full_like(S_oc, ref_sss)

    a2ohf = atm.oce_heat_flux + atm.shortwave
    a2ihf = atm.ice_heat_flux

    # freezing point of seawater (ref :229)
    Tfrezs = -0.0575 * S_oc + 1.7105e-3 * S_oc ** 1.5 - 2.155e-4 * S_oc ** 2

    Amax = torch.clamp_min(A, AIMIN)
    heff = (h + hsn * ic.con / ic.consn) / Amax
    Qicecon = Tfrezs * ic.con / torch.clamp_min(heff, HIMIN)

    Qatmice = -a2ihf
    Qatmocn = -a2ohf
    Qocnice = (T_oc - Tfrezs) * GAMMA_T * cc
    Qocnatm = torch.minimum(Qocnice, Qatmocn)

    # grid-cell-average atmospheric heat flux (ref :419-421)
    ahf = A * Qatmice + (1.0 - A) * Qatmocn

    s = dt / cl
    Qicecon, Qatmice, Qatmocn = Qicecon * s, Qatmice * s, Qatmocn * s
    Qocnice, Qocnatm = Qocnice * s, Qocnatm * s

    # freshwater fluxes -> growth per step [m] (ref :270-277)
    PmEice = (A * atm.prec_snow + A * atm.sublimation) * dt
    PmEocn = (atm.prec_rain + atm.runoff + (1.0 - A) * atm.prec_snow
              + (1.0 - A) * atm.evap_no_ifrac) * dt

    hsn = hsn + PmEice * RHOFWT / rhosno
    PmEice = torch.clamp_max(hsn, 0.0) * rhosno / RHOFWT
    hsn = torch.clamp_min(hsn, 0.0)
    h = h + PmEice * RHOFWT / rhoice
    PmEice = torch.clamp_max(h, 0.0) * rhoice / RHOFWT
    h = torch.clamp_min(h, 0.0)
    PmEocn = PmEocn + PmEice

    hsnold, hold = hsn, h

    # atmospheric snow melt over ice (ref :311-319)
    dsnow = A * torch.clamp_max(Qatmice - Qicecon, 0.0)
    dsnow = torch.maximum(dsnow * rhoice / rhosno, -hsn)
    hsn = hsn + dsnow

    # ice growth and melt over ice and open water (ref :325-349)
    dhice = A * (Qatmice - Qocnice) - dsnow * rhosno / rhoice
    dhiow = (1.0 - A) * torch.clamp_min(Qatmocn - Qocnatm, 0.0)
    htmp = h + dhice + dhiow
    hsn = torch.where(htmp < 0.0,
                      hsn + torch.maximum(htmp * rhoice / rhosno, -hsn), hsn)
    h = torch.clamp_min(htmp, 0.0)
    h = torch.where(h < HCUTOFF, 0.0, h)

    # concentration changes (ref :354-399)
    htmp0 = torch.clamp_min(hold, HCUTOFF)
    dcice = 0.5 * A * torch.clamp_max(dhice, 0.0) / htmp0
    dslat = torch.where(A <= 0.0, -hsn, torch.maximum(torch.clamp_max(
        dcice * hsnold / Amax - dsnow, 0.0), -hsn))
    hsn = hsn + dslat

    h0cur = torch.clamp(hold, max=h0max).clamp_min(h0min)
    if h0max <= 0.0:       # Mellor & Kantha (1989) alternative (ref :384)
        h0cur = torch.clamp_min(hold / Amax, HIMIN) / h0min
    dciow = torch.clamp_min(dhiow, 0.0) / h0cur

    A = A + dcice + dciow
    A = torch.minimum(A, h * BIGVAL)
    A = torch.clamp(A, 0.0, 1.0)

    dhsngrowth = (hsn - hsnold) / dt
    dhgrowth = (h - hold) / dt
    PmEocn = PmEocn / dt

    if not use_virt_salt:
        fw = PmEocn * RHOFWT - dhgrowth * rhoice - dhsngrowth * rhosno
        rsf = -dhgrowth * rhoice * Sice / rhowat
    else:
        fw = PmEocn * RHOFWT - dhgrowth * rhoice * (rsss - Sice) / rsss \
            - dhsngrowth * rhosno
        rsf = torch.zeros_like(fw)

    # total energy flux into the ocean (ref :421)
    ehf = -ahf + cl * (dhgrowth + dhsngrowth * rhosno / rhoice)

    # flooding: snow below the waterline converts to ice (ref :424-446)
    htmp_fl = h
    hdraft = (h * rhoice + hsn * rhosno) / rhowat
    hflood = hdraft - torch.minimum(h, hdraft)
    h = h + hflood
    hsn = hsn - hflood * rhoice / rhosno
    dhflice = (h - htmp_fl) / dt
    if not use_virt_salt:
        rsf = rsf - dhflice * rhoice * Sice / rhowat
    else:
        fw = fw + dhflice * rhoice * Sice / rsss

    fw = fw / rhowat

    return replace(ice, a_ice=A, m_ice=h, m_snow=hsn,
                   net_heat_flux=ehf, fresh_wa_flux=fw,
                   real_salt_flux=rsf, evaporation=evaporation,
                   thdgr=dhgrowth, thdgrsn=dhsngrowth, flice=dhflice,
                   a_ice_old=A0)
