# Frozen copy of fesom2_tpu_torch/config.py, lines 1-462 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""Typed configuration mirroring the reference namelist groups 1:1.

Reference: ``src/gen_modules_config.F90`` (module g_config), ``src/oce_modules.F90``
(o_PARAM namelist-bound variables), ``src/ice_modules.F90`` (i_PARAM).  The field
names are kept identical to the Fortran namelist entries so reference configs
(``config/namelist.*``) port directly; ``from_namelist`` parses the Fortran
namelist files themselves.

The port's own copy of ``fesom2_tpu/config.py`` (standard library only):
``fesom2_tpu_torch`` imports nothing of the JAX package.
``tests/test_torch_config.py`` holds the two copies field for field.
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import List, Optional


# --------------------------------------------------------------------------
# namelist.config  (g_config)
# --------------------------------------------------------------------------
@dataclass
class TimestepConfig:
    step_per_day: int = 72
    run_length: int = 1
    run_length_unit: str = "y"   # y, m, d, s

    @property
    def dt(self) -> float:
        return 86400.0 / self.step_per_day


@dataclass
class ClockConfig:
    timenew: float = 0.0
    daynew: int = 1
    yearnew: int = 1948
    include_fleapyear: bool = False


@dataclass
class AleConfig:
    which_ALE: str = "linfs"     # 'linfs' | 'zlevel' | 'zstar'
    use_partial_cell: bool = False
    partial_cell_thresh: float = 0.0
    min_hnode: float = 0.5
    lzstar_lev: int = 4
    max_ice_loading: float = 5.0


@dataclass
class GeometryConfig:
    cartesian: bool = False
    fplane: bool = False
    cyclic_length: float = 360.0   # [degree]
    rotated_grid: bool = True
    force_rotation: bool = True
    alphaEuler: float = 50.0
    betaEuler: float = 15.0
    gammaEuler: float = -90.0


@dataclass
class RunConfig:
    use_ice: bool = False
    use_floatice: bool = False
    use_sw_pene: bool = True
    use_cavity: bool = False
    toy_ocean: bool = False
    which_toy: str = "soufflet"
    flag_debug: bool = False
    flag_warn_cflz: bool = True
    use_global_tides: bool = False  # luni-solar potential (mo_tidal)
    l_mslp: bool = False            # sea-level pressure forcing
    use_icepack: bool = False       # multi-category column physics (__icepack)


# --------------------------------------------------------------------------
# namelist.oce  (o_PARAM)
# --------------------------------------------------------------------------
@dataclass
class OceDynConfig:
    state_equation: int = 1       # 1 full EoS (Jackett-McDougall), 0 linear
    # PGF discretization for moving coordinates (oce_modules.F90:172):
    # 'shchepetkin' (density Jacobian) | 'easypgf' (EoS re-evaluation at
    # element mid-depths)
    which_pgf: str = "shchepetkin"
    C_d: float = 0.0025           # bottom drag
    A_ver: float = 0.001          # vertical harmonic viscosity [m^2/s]
    gamma0: float = 0.01
    gamma1: float = 0.1
    gamma2: float = 10.0
    Div_c: float = 1.0
    Leith_c: float = 1.0
    visc_option: int = 5
    easy_bs_return: float = 1.0
    scale_area: float = 2.0e8
    # dynamic backscatter / UKE budget, visc_option=8 (oce_modules.F90:34-41)
    K_back: float = 600.0
    c_back: float = 0.1
    uke_scaling: bool = True
    uke_scaling_factor: float = 1.0
    rosb_dis: float = 1.0
    smooth_back: int = 2
    smooth_dis: int = 2
    smooth_back_tend: int = 4
    mom_adv: int = 2              # 2 = flux form on scalar CV, 3 = vector invariant
    free_slip: bool = False
    i_vert_visc: bool = True
    w_split: bool = False
    w_max_cfl: float = 1.0e-5
    SPP: bool = False
    Fer_GM: bool = False
    K_GM_max: float = 3000.0
    K_GM_min: float = 2.0
    K_GM_bvref: int = 2
    K_GM_rampmax: float = 40.0
    K_GM_rampmin: float = 30.0
    scaling_Ferreira: bool = True
    scaling_Rossby: bool = False
    scaling_resolution: bool = True
    scaling_FESOM14: bool = False
    Redi: bool = False
    visc_sh_limit: float = 5.0e-3
    mix_scheme: str = "KPP"       # KPP | PP | cvmix_KPP | cvmix_PP | cvmix_TKE ...
    use_kpp_nonlclflx: bool = False  # apply KPP nonlocal tracer fluxes (o_PARAM :150)
    Ricr: float = 0.3
    concv: float = 1.6
    # semi-implicit free surface (o_PARAM, oce_modules.F90:80-82)
    alpha: float = 1.0
    theta: float = 1.0
    epsilon: float = 0.1          # AB2 offset


@dataclass
class OceTraConfig:
    use_momix: bool = True
    momix_lat: float = -50.0
    momix_kv: float = 0.01
    use_instabmix: bool = True
    instabmix_kv: float = 0.1
    use_windmix: bool = False
    windmix_kv: float = 1.0e-3
    windmix_nl: int = 2
    diff_sh_limit: float = 5.0e-3
    Kv0_const: bool = True
    double_diffusion: bool = False
    K_ver: float = 1.0e-5
    K_hor: float = 10.0
    surf_relax_T: float = 0.0
    surf_relax_S: float = 10.0 / (60.0 * 3600.0 * 24.0)
    balance_salt_water: bool = True
    clim_relax: float = 0.0
    ref_sss_local: bool = False
    ref_sss: float = 34.7
    i_vert_diff: bool = True
    tracer_adv: int = 2           # 1 MUSCL, 2 MUSCL+FCT
    num_tracers: int = 2
    tracer_ID: List[int] = field(default_factory=lambda: [0, 1])
    # advection scheme selection (namelist.oce &oce_tra in newer refs)
    tra_adv_hor: str = "MFCT"     # UPW1 | MUSCL | MFCT
    tra_adv_ver: str = "QR4C"     # UPW1 | QR4C | CDIFF | PPM
    tra_adv_lim: str = "FCT"      # FCT | NONE
    tra_adv_ph: float = 1.0       # horizontal high-order blend
    tra_adv_pv: float = 1.0       # vertical high-order blend


# --------------------------------------------------------------------------
# namelist.ice  (i_PARAM; reference src/ice_modules.F90)
# --------------------------------------------------------------------------
@dataclass
class IceConfig:
    whichEVP: int = 0             # 0 EVP, 1 mEVP, 2 aEVP
    # run the EVP subcycle loop only on the polar caps |lat| > this value
    # (deg); None = global.  Exact as long as all ice stays inside the cap
    # (ice/subdomain.py) — gather volume per subcycle scales with cap size.
    evp_subdomain_lat: float = None
    Pstar: float = 30000.0        # [N/m^2]
    ellipse: float = 2.0
    c_pressure: float = 20.0
    delta_min: float = 1.0e-11    # [1/s]
    evp_rheol_steps: int = 120
    alpha_evp: float = 250.0
    beta_evp: float = 250.0
    c_aevp: float = 0.15
    Cd_oce_ice: float = 0.0055
    ice_gamma_fct: float = 0.5
    ice_diff: float = 0.0
    theta_io: float = 0.0
    ice_ave_steps: int = 1        # ice step every ice_ave_steps ocean steps
    Sice: float = 4.0             # ice salinity [psu] (ice_modules.F90:132)
    h0: float = 0.5               # lead closing parameter [m]
    emiss_ice: float = 0.97
    emiss_wat: float = 0.97
    albsn: float = 0.81
    albsnm: float = 0.77
    albi: float = 0.7
    albim: float = 0.68
    albw: float = 0.1
    con: float = 2.1656           # ice conductivity [W/m/K]
    consn: float = 0.31           # snow conductivity [W/m/K]


# --------------------------------------------------------------------------
# top-level config
# --------------------------------------------------------------------------
@dataclass
class DiagConfig:
    """&diag_list (ref gen_modules_diag.F90:55-71)."""
    ldiag_solver: bool = False
    lcurt_stress_surf: bool = False
    ldiag_curl_vel3: bool = False
    ldiag_energy: bool = False
    ldiag_salt3D: bool = False
    ldiag_dMOC: bool = False
    ldiag_DVD: bool = False
    ldiag_forc: bool = False


@dataclass
class CvmixConfig:
    """CVMix-style scheme parameters (ref namelist.cvmix defaults:
    gen_modules_cvmix_pp.F90:37-49, gen_modules_cvmix_tke.F90:13-40,
    gen_modules_cvmix_idemix.F90, gen_modules_cvmix_tidal.F90)."""
    # param_pp
    pp_Av0: float = 0.01
    pp_alpha: float = 5.0
    pp_exp: float = 2.0
    pp_Avbckg: float = 1.0e-4
    pp_Kvbckg: float = 1.0e-5
    pp_use_fesompp: bool = True
    pp_use_AvbinKv: bool = True
    pp_use_nonconstKvb: bool = True
    # param_kpp (gen_modules_cvmix_kpp.F90:20-52)
    kpp_Rib_crit: float = 0.3
    kpp_vonKarman: float = 0.40
    kpp_minOBLdepth: float = 0.0
    kpp_minVtsqr: float = 1.0e-10
    kpp_surf_layer_ext: float = 0.10
    kpp_cs: float = 98.96           # CVMix c_s constant
    kpp_cs2: float = 6.32739901508  # nonlocal transport coefficient
    kpp_use_enhanceKv: bool = True
    kpp_use_compEkman: bool = True
    kpp_use_monob: bool = True
    kpp_reduce_tauuice: bool = False
    kpp_Av0: float = 5.0e-3
    kpp_Kv0: float = 5.0e-3
    kpp_Ri0: float = 0.7
    kpp_loc_exp: float = 3.0
    kpp_use_nonconstKvb: bool = True
    kpp_Avbckg: float = 1.0e-4
    kpp_Kvbckg: float = 1.0e-5
    # param_tke
    tke_c_k: float = 0.1
    tke_c_eps: float = 0.7
    tke_alpha: float = 30.0
    tke_mxl_min: float = 1.0e-8
    tke_kappaM_min: float = 0.0
    tke_kappaM_max: float = 100.0
    tke_cd: float = 1.0
    tke_surf_min: float = 1.0e-4
    tke_min: float = 1.0e-6
    tke_mxl_choice: int = 2
    # param_idemix
    idemix_tau_v: float = 86400.0
    idemix_tau_h: float = 1296000.0
    idemix_gamma: float = 1.57
    idemix_jstar: float = 10.0
    idemix_mu0: float = 1.33333333
    idemix_sforcusage: float = 0.2
    idemix_n_hor_iwe_prop_iter: int = 5
    idemix_surforc_file: str = ""
    idemix_botforc_file: str = ""
    # param_ddiff (cvmix_ddiff.F90 defaults :126-240)
    ddiff_strat_param_max: float = 2.55
    ddiff_kappa_s: float = 1.0e-4
    ddiff_exp1: float = 1.0
    ddiff_exp2: float = 3.0
    ddiff_mol_diff: float = 1.5e-6
    ddiff_param1: float = 0.909
    ddiff_param2: float = 4.6
    ddiff_param3: float = -0.54
    # param_conv (cvmix_convection.F90 defaults :96-160)
    conv_diff: float = 1.0
    conv_visc: float = 1.0
    conv_bvsqr: float = 0.0
    # param_tidal
    tidal_mixscheme: str = "Simmons"
    tidal_efficiency: float = 0.2
    tidal_vert_decayscale: float = 500.0
    tidal_max_coefficient: float = 50.0e-4
    tidal_local_mixfrac: float = 0.33
    tidal_depth_cutoff: float = 0.0
    tidal_forc_file: str = ""


@dataclass
class SbcConfig:
    """Generic surface-forcing source description (ref &nam_sbc,
    ``config/namelist.forcing:28-58``, read by ``gen_surface_forcing.F90
    sbc_ini :877-1040``).  File entries are path PREFIXES: the year and
    '.nc' are appended (nc_sbc_ini_fillnames :469).  Empty nm_xwind_file
    means "not configured" -> the shipped-test-set fast path is used."""
    nm_xwind_file: str = ""
    nm_ywind_file: str = ""
    nm_humi_file: str = ""
    nm_qsr_file: str = ""
    nm_qlw_file: str = ""
    nm_tair_file: str = ""
    nm_prec_file: str = ""
    nm_snow_file: str = ""
    nm_mslp_file: str = ""
    nm_xwind_var: str = "uas"
    nm_ywind_var: str = "vas"
    nm_humi_var: str = "huss"
    nm_qsr_var: str = "rsds"
    nm_qlw_var: str = "rlds"
    nm_tair_var: str = "tas"
    nm_prec_var: str = "prra"
    nm_snow_var: str = "prsn"
    nm_mslp_var: str = "psl"
    nm_nc_iyear: int = 1900
    nm_nc_imm: int = 1
    nm_nc_idd: int = 1
    nm_nc_freq: int = 1          # data points per day in the raw time axis
    nm_nc_tmid: int = 0          # 1: stamps already at interval mid-points
    y_perpetual: bool = False    # repeat one forcing year forever
    l_xwind: bool = True
    l_ywind: bool = True
    l_humi: bool = True
    l_qsr: bool = True
    l_qlw: bool = True
    l_tair: bool = True
    l_prec: bool = True
    l_mslp: bool = False
    l_cloud: bool = False
    l_snow: bool = True
    nm_runoff_file: str = ""
    runoff_data_source: str = "CORE2"
    nm_sss_data_file: str = ""
    sss_data_source: str = "CORE2"

    @property
    def configured(self) -> bool:
        return bool(self.nm_xwind_file)


@dataclass
class ModelConfig:
    runid: str = "fesom"
    MeshPath: str = "./mesh/"
    ClimateDataPath: str = "./hydrography/"
    ResultPath: str = "./result/"
    timestep: TimestepConfig = field(default_factory=TimestepConfig)
    clock: ClockConfig = field(default_factory=ClockConfig)
    ale: AleConfig = field(default_factory=AleConfig)
    geometry: GeometryConfig = field(default_factory=GeometryConfig)
    run: RunConfig = field(default_factory=RunConfig)
    dyn: OceDynConfig = field(default_factory=OceDynConfig)
    tra: OceTraConfig = field(default_factory=OceTraConfig)
    ice: IceConfig = field(default_factory=IceConfig)
    icepack: "object" = field(default=None)   # IcepackConfig when use_icepack
    sbc: SbcConfig = field(default_factory=SbcConfig)
    cvmix: CvmixConfig = field(default_factory=CvmixConfig)
    diag: DiagConfig = field(default_factory=DiagConfig)
    restart_length: int = 1
    restart_length_unit: str = "m"
    logfile_outfreq: int = 1

    @property
    def dt(self) -> float:
        return self.timestep.dt


# --------------------------------------------------------------------------
# Fortran namelist parsing (so reference configs run unmodified)
# --------------------------------------------------------------------------
_NML_GROUP_RE = re.compile(r"&(\w+)(.*?)(?:^|\n)\s*/", re.S)
_NML_ITEM_RE = re.compile(r"(\w+)\s*=\s*([^=\n!]+?)(?=\s*(?:!|$|\n|,\s*\w+\s*=))", re.M)


def _parse_value(text: str):
    text = text.strip().rstrip(",").strip()
    low = text.lower()
    if low in (".true.", "t", "true"):
        return True
    if low in (".false.", "f", "false"):
        return False
    if "," in text:  # list
        return [_parse_value(v) for v in text.split(",") if v.strip()]
    if text.startswith(("'", '"')):
        return text.strip("'\"")
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text.replace("d", "e").replace("D", "E"))
    except ValueError:
        return text


def parse_namelist(path: str) -> dict:
    """Parse a Fortran namelist file into {group: {key: value}}."""
    with open(path) as fh:
        src = fh.read()
    groups = {}
    for m in _NML_GROUP_RE.finditer(src):
        name, body = m.group(1).lower(), m.group(2)
        # strip comments line-wise FIRST: comment text may itself contain
        # key=value fragments (e.g. "... with visc_option=5 (easy
        # backscatter)" in namelist.oce:18) that must not parse as items
        body = "\n".join(line.split("!")[0] for line in body.splitlines())
        items = {}
        for im in _NML_ITEM_RE.finditer(body):
            items[im.group(1)] = _parse_value(im.group(2))
        groups[name] = items
    return groups


def _apply(dc, items: dict):
    names = {f.name.lower(): f.name for f in dataclasses.fields(dc)}
    for key, val in items.items():
        name = names.get(key.lower())
        if name is not None:
            setattr(dc, name, val)


def load_config(namelist_config: str, namelist_oce: Optional[str] = None,
                namelist_ice: Optional[str] = None,
                namelist_forcing: Optional[str] = None) -> ModelConfig:
    """Build a ModelConfig from reference-format namelist file(s)."""
    cfg = ModelConfig()
    if namelist_forcing:
        f = parse_namelist(namelist_forcing)
        if "nam_sbc" in f:
            _apply(cfg.sbc, f["nam_sbc"])
    g = parse_namelist(namelist_config)
    for group, target in (("modelname", cfg), ("paths", cfg), ("restart_log", cfg),
                          ("timestep", cfg.timestep), ("clockinit", cfg.clock),
                          ("calendar", cfg.clock), ("ale_def", cfg.ale),
                          ("geometry", cfg.geometry), ("run_config", cfg.run)):
        if group in g:
            _apply(target, g[group])
    if namelist_oce:
        o = parse_namelist(namelist_oce)
        for group in ("oce_dyn",):
            if group in o:
                _apply(cfg.dyn, o[group])
                _apply(cfg.tra, o[group])  # some keys live in either group
        for group in ("oce_tra",):
            if group in o:
                _apply(cfg.tra, o[group])
                _apply(cfg.dyn, o[group])
    if namelist_ice:
        i = parse_namelist(namelist_ice)
        for group in ("ice_dyn", "ice_therm", "ice_stress"):
            if group in i:
                _apply(cfg.ice, i[group])
    return cfg
