"""Icepack state and configuration.

The port of ``fesom2_tpu/ice/icepack/state.py``: the per-gridpoint state
of the reference driver (``src/icepack_drivers/icedrv_main.F90:83-140``:
aicen, vicen, vsnon, trcrn = [Tsfc, qice(nilyr), qsno(nslyr)]) in the
layout ``[ncat, N]`` / ``[ncat, nlyr, N]``.  ``IcepackConfig`` is the
port's own copy of the JAX package's, field for field and value for value
(``tests/test_torch_config.py`` and ``tests/test_torch_icepack.py`` hold
them against each other); ``convert.icepack_config_from`` builds one from
the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import constants as c
from .itd import category_bounds


@dataclass
class IcepackConfig:
    """Subset of config/namelist.icepack exercised by the reference CI
    (env_nml, thermo_nml, shortwave_nml, dynamics_nml)."""
    ncat: int = 5
    nilyr: int = 4
    nslyr: int = 4
    kcatbound: int = 1
    kitd: int = 1                 # 1 linear remap | 0 delta rebin
    ktherm: int = 1               # BL99
    conduct: str = "bubbly"       # 'bubbly' (Pringle 2007) | 'MU71'
    ksno: float = 0.30
    # shortwave scheme: 'ccsm3' (CI default) | 'dEdd' (delta-Eddington
    # multiple scattering, dedd.py; handles ponds internally)
    shortwave: str = "ccsm3"
    # shortwave / albedo (ccsm3)
    albicev: float = 0.78
    albicei: float = 0.36
    albsnowv: float = 0.98
    albsnowi: float = 0.70
    albocn: float = 0.06
    ahmax: float = 0.3
    i0vis: float = 0.70           # fraction of penetrating vis SW
    kappav: float = 1.4           # vis extinction in ice [1/m]
    frac_vis: float = 0.52        # visible fraction of incoming SW
    dT_mlt: float = 1.5
    dalb_mlt: float = -0.075
    dalb_mltv: float = -0.100
    dalb_mlti: float = -0.150
    snowpatch: float = 0.02
    # dynamics / ridging
    kstrength: int = 1            # 1 Rothrock | 0 Hibler
    krdg_partic: int = 1          # exponential participation
    krdg_redist: int = 1          # exponential redistribution
    mu_rdg: float = 3.0
    Cf: float = 17.0
    P_star: float = 27000.0
    C_star: float = 20.0
    # forcing
    ustar_min: float = 0.0005
    emissivity: float = 0.95
    tfrz_option: str = "linear_salt"
    natmiter: int = 5
    # numerics
    atmbndy: str = "const"        # 'const' = FESIM bulk (default);
                                  # 'similarity' = Icepack MO-iterated
                                  # transfer coeffs (experimental: blows
                                  # up the pi day-run at step ~21, needs
                                  # stability work before it can default)
    niter_therm: int = 4          # MINIMUM BL99 Newton sweeps; the solve
                                  # then iterates until max|dTsf| < 5e-4 C
                                  # (Icepack Tsf_errmax), maxiter 100
    ndtd: int = 1
    # optional tracers (tracer_nml; reference ships the pond variant as
    # config/namelist.icepack.cesm.ponds: trpnd=1, tr_pond_cesm)
    tr_pond_cesm: bool = False    # CESM melt ponds (Holland et al. 2012)
    tr_iage: bool = False         # ice age
    tr_FY: bool = False           # first-year ice area
    tr_lvl: bool = False          # level/deformed ice partition
    tr_fsd: bool = False          # floe size distribution (fsd.py;
    #                               Roach et al. 2018, icedrv_main.F90:49)
    nfsd: int = 12                # floe size bins (Icepack standard set)
    wave_spec: bool = False       # wave field present: new floes pancake-
    #                               sized (smallest bin) vs consolidation
    kweld: float = 5.0e-7         # welding rate at full ice cover [1/s]
    # skeletal-layer biogeochemistry (bgc.py; skl_bgc hooks of
    # icedrv_main.F90:61-62,557)
    tr_bgc: bool = False
    bgc_mu_max: float = 1.44      # max algal growth rate [1/day]
    bgc_grow_Tdep: float = 0.0633  # growth T-dependence [1/C]
    bgc_K_par: float = 4.0        # light half-saturation [W/m^2]
    bgc_K_NO3: float = 1.0        # nitrate half-saturation [mmol/m^3]
    bgc_K_Sil: float = 4.0        # silicate half-saturation [mmol/m^3]
    bgc_R_Si2N: float = 1.8       # diatom Si:N uptake ratio
    bgc_mort: float = 0.007       # linear mortality [1/day]
    bgc_fr_resp: float = 0.05     # respired (remineralized) fraction
    bgc_NO3_ocn: float = 16.0     # mixed-layer nitrate [mmol/m^3]
    bgc_Sil_ocn: float = 25.0     # mixed-layer silicate [mmol/m^3]
    bgc_N_seed: float = 0.02      # new-ice algal seed [mmol N/m^3]
    # ponds_nml (namelist.icepack:71-79)
    pndaspect: float = 0.8        # pond depth/area aspect delta_p
    rfracmin: float = 0.15        # min meltwater retention fraction
    rfracmax: float = 1.0         # max meltwater retention fraction
    hi_min_pond: float = 0.1      # ponds removed on thinner ice [m]
    dpthhi: float = 0.9           # max pond depth / ice thickness
    Td_pond: float = 2.0          # refreeze onset below Timelt - Td [C]
    rexp_pond: float = 0.01       # refreeze exponential rate

    def __post_init__(self):
        self.hin_max = category_bounds(self.ncat, self.kcatbound)
        # stacked aux-tracer layouts: area-weighted ('ta') and ice-volume-
        # weighted ('tv') names, in storage order
        ta = []
        tv = []
        if self.tr_pond_cesm:
            ta += ["apnd", "hpnd"]
        if self.tr_FY:
            ta += ["FY"]
        if self.tr_lvl:
            ta += ["alvl"]
            tv += ["vlvl"]
        if self.tr_iage:
            tv += ["iage"]
        if self.tr_fsd:
            from .fsd import fsd_bounds
            self.fsd_i0 = len(ta)
            ta += [f"fsd{k:02d}" for k in range(self.nfsd)]
            self.fsd_lims = fsd_bounds(self.nfsd)
        if self.tr_bgc:
            from .bgc import BGC_NAMES
            self.bgc_i0 = len(ta)
            ta += list(BGC_NAMES)
        self.area_tracers = tuple(ta)
        self.vol_tracers = tuple(tv)
        # ridging behavior: True = conserved into the ridged receiver,
        # False = destroyed on the ridged portion (ponds drain, level ice
        # becomes deformed; FY/age survive deformation).  FSD bins are
        # conserved through ridging (the mechanical fracture of ridged
        # floes is not modelled; the distribution rides along unchanged).
        # BGC concentrations ride the ridged ice (the skeletal layer is
        # carried with the ice bottom)
        self.ta_ridge_keep = tuple(n in ("FY",) or n.startswith("fsd")
                                   or n.startswith("bgc")
                                   for n in ta)
        self.tv_ridge_keep = tuple(n in ("iage",) for n in tv)

    @property
    def fsd_slice(self):
        return slice(self.fsd_i0, self.fsd_i0 + self.nfsd)

    @property
    def bgc_slice(self):
        from .bgc import N_BGC
        return slice(self.bgc_i0, self.bgc_i0 + N_BGC)

    def ta_index(self, name: str) -> int:
        return self.area_tracers.index(name)

    def tv_index(self, name: str) -> int:
        return self.vol_tracers.index(name)

    @property
    def has_aux(self) -> bool:
        return bool(self.area_tracers or self.vol_tracers)



@dataclass
class IcepackState:
    """Prognostic multi-category state; N = number of surface nodes."""
    aicen: torch.Tensor   # [ncat, N] category area fractions
    vicen: torch.Tensor   # [ncat, N] ice volume per grid area [m]
    vsnon: torch.Tensor   # [ncat, N] snow volume per grid area [m]
    Tsfcn: torch.Tensor   # [ncat, N] surface temperature [C]
    qin: torch.Tensor     # [ncat, nilyr, N] ice enthalpy density [J/m^3] (<0)
    qsn: torch.Tensor     # [ncat, nslyr, N] snow enthalpy density [J/m^3] (<0)
    # optional aux tracers (tracer_nml), stacked by IcepackConfig layout:
    # ta [ncat, Ka, N] intensive per category AREA (apnd, hpnd, FY, alvl);
    # tv [ncat, Kv, N] intensive per category ICE VOLUME (vlvl, iage)
    ta: Optional[torch.Tensor] = None
    tv: Optional[torch.Tensor] = None


def salinity_profile(nilyr: int) -> np.ndarray:
    """BL99 fixed bulk-salinity profile per ice layer midpoint [ppt]."""
    z = (np.arange(nilyr) + 0.5) / nilyr
    return 0.5 * c.saltmax * (1.0 - np.cos(np.pi
                                           * z ** (c.sal_a / (z + c.sal_b))))


def melt_temps(nilyr: int) -> np.ndarray:
    """Layer melting temperatures Tm = -mu*S [C]."""
    return -c.mu_liq * salinity_profile(nilyr)


def enthalpy_ice(T, S):
    """BL99 ice enthalpy density q(T,S) [J/m^3], T in C (<= Tm <= 0)."""
    Tm = -c.mu_liq * S
    Ts = torch.clamp_max(T, -1e-6)
    return -c.rhoi * (c.cp_ice * (Tm - Ts) + c.Lfresh * (1.0 - Tm / Ts)
                      - c.cp_ocn * Tm)


def enthalpy_snow(T):
    """Snow enthalpy density [J/m^3]."""
    return -c.rhos * (-c.cp_ice * T + c.Lfresh)


def temperature_ice(q, S):
    """Invert q(T,S): T from the quadratic
    cp_ice*T^2 + b*T + Lfresh*Tm = 0."""
    Tm = -c.mu_liq * S
    b = (c.cp_ocn - c.cp_ice) * Tm - q / c.rhoi - c.Lfresh
    cc = c.Lfresh * Tm
    disc = torch.clamp_min(b * b - 4.0 * c.cp_ice * cc, 0.0)
    T = (-b - torch.sqrt(disc)) / (2.0 * c.cp_ice)
    return torch.minimum(T, Tm)


def temperature_snow(q):
    return torch.clamp_max((q / c.rhos + c.Lfresh) / c.cp_ice, 0.0)


def aux_init_values(cfg: IcepackConfig) -> tuple:
    """({area tracer: initial value}, {volume tracer: initial value}):
    initial ice has no ponds, age 0, is not first-year (a climatological
    pack is multiyear) and entirely level; FSD: all area in the largest
    floe bin (a consolidated pack)."""
    init_a = {"apnd": 0.0, "hpnd": 0.0, "FY": 0.0, "alvl": 1.0}
    init_a.update({f"fsd{k:02d}": (1.0 if k == cfg.nfsd - 1 else 0.0)
                   for k in range(getattr(cfg, "nfsd", 0))})
    if getattr(cfg, "tr_bgc", False):
        from .bgc import bgc_defaults
        init_a.update(bgc_defaults(cfg))
    return init_a, {"vlvl": 1.0, "iage": 0.0}


def init_icepack_state(cfg: IcepackConfig, a_ice, m_ice, m_snow, Tsf,
                       dtype=torch.float64) -> IcepackState:
    """Distribute an aggregate (a, hi*a, hs*a) initial condition into
    categories: all initial ice is placed in the category containing its
    mean thickness (the reference driver's init_state does the same
    single-category placement per point)."""
    a_ice, m_ice, m_snow, Tsf = (x.to(dtype) for x in (a_ice, m_ice, m_snow,
                                                        Tsf))
    N = a_ice.shape[0]
    dev = a_ice.device
    ncat, nilyr, nslyr = cfg.ncat, cfg.nilyr, cfg.nslyr
    hmax = cfg.hin_max
    hi = torch.where(a_ice > c.puny, m_ice / torch.clamp_min(a_ice, c.puny),
                     0.0)

    sal = torch.as_tensor(salinity_profile(nilyr), dtype=dtype, device=dev)
    # isothermal cold profile at the surface temperature (capped below Tm)
    Tprof = torch.clamp_max(Tsf, -c.mu_liq * c.saltmax - 0.1)
    qi0 = enthalpy_ice(Tprof[None, :], sal[:, None])            # [nilyr, N]
    qs0 = enthalpy_snow(Tprof)[None, :].expand(nslyr, N)

    aicen = []
    for n in range(ncat):
        inb = (hi > hmax[n]) & (hi <= hmax[n + 1]) & (a_ice > c.puny)
        aicen.append(torch.where(inb, a_ice, 0.0))
    aicen = torch.stack(aicen)
    frac = torch.where(a_ice[None] > c.puny,
                       aicen / torch.clamp_min(a_ice[None], c.puny), 0.0)
    vicen = frac * m_ice[None]
    vsnon = frac * m_snow[None]
    has = aicen > c.puny
    ta = tv = None
    if cfg.has_aux:
        init_a, init_v = aux_init_values(cfg)
        zero = torch.zeros((ncat, 0, N), dtype=dtype, device=dev)
        fill = lambda v: torch.where(has, torch.full_like(aicen, v), 0.0)
        ta = torch.stack([fill(init_a[n]) for n in cfg.area_tracers], 1) \
            if cfg.area_tracers else zero
        tv = torch.stack([fill(init_v[n]) for n in cfg.vol_tracers], 1) \
            if cfg.vol_tracers else zero
    return IcepackState(
        aicen=aicen, vicen=vicen, vsnon=vsnon,
        Tsfcn=torch.where(has, torch.clamp_max(Tsf, 0.0)[None], 0.0),
        qin=torch.where(has[:, None, :], qi0[None], 0.0),
        qsn=torch.where(has[:, None, :], qs0[None], 0.0),
        ta=ta, tv=tv)
