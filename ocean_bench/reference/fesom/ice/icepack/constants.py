# Frozen copy of fesom2_tpu_torch/ice/icepack/constants.py, lines 1-65 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""Physical constants of the Icepack column physics: the port's own copy of
``fesom2_tpu/ice/icepack/constants.py``, value for value.

Values follow the CICE/Icepack conventions (icedrv_constants.F90 in the
reference driver re-exports these); they deliberately differ from the
0-layer FESIM constants in ``ice/state.py`` — the two thermodynamics
families keep their own constant sets, like the reference.
"""

rhoi = 917.0          # density of ice [kg/m^3]
rhos = 330.0          # density of snow [kg/m^3]
rhow = 1026.0         # density of seawater [kg/m^3]
rhofresh = 1000.0     # density of fresh water [kg/m^3]

cp_ice = 2106.0       # specific heat of fresh ice [J/kg/K]
cp_ocn = 4218.0       # specific heat of ocean water [J/kg/K]
cp_air = 1005.0       # specific heat of air [J/kg/K]
Lfresh = 3.34e5       # latent heat of melting fresh ice [J/kg]
Lvap = 2.501e6        # latent heat of vaporization [J/kg]
Lsub = Lfresh + Lvap  # latent heat of sublimation [J/kg]

mu_liq = 0.054        # liquidus ratio: Tf = -mu_liq * S [deg/ppt]
saltmax = 3.2         # max bulk ice salinity (BL99 profile) [ppt]
sal_a = 0.407         # BL99 salinity-profile shape parameters
sal_b = 0.573
ice_ref_salinity = 4.0  # reference bulk ice salinity for fluxes [ppt]
min_salin = 0.1       # threshold for brine pockets [ppt]

ksno = 0.30           # snow thermal conductivity [W/m/K] (namelist ksno)
kice0 = 2.03          # pure-ice conductivity (MU71) [W/m/K]
beta_mu71 = 0.13      # MU71 salinity-conductivity coefficient [W/m/ppt]

emissivity = 0.95     # long-wave emissivity of ice/snow (namelist)
stefan_boltzmann = 567.0e-10
Tffresh = 273.15      # freezing temperature of fresh water [K]
depressT = 0.054      # Tf depression per ppt for 'linear_salt' [deg/ppt]

rhoair = 1.3          # air density [kg/m^3]

# lateral melt (Steele 1992; icepack_therm_itd floe constants)
floediam = 300.0      # effective floe diameter [m]
alpha_floe = 0.66     # floe shape parameter
m1_lat = 1.6e-6       # lateral melt rate coefficients: w = m1*(dT)**m2
m2_lat = 1.36

# ridging (namelist dynamics_nml)
Cf_default = 17.0     # frictional-dissipation ratio
Cs_shear = 0.25       # fraction of shear energy that contributes to closing
Cp_ratio = 0.5        # g*(rhow-rhoi)*rhoi/rhow prefactor is computed in code
astar_partic = 0.05   # e-folding of the exponential participation function
maxraft = 1.0         # max thickness of rafted ice [m]
hrmin_factor = 1.1    # ridges are at least 1.1x thicker than parent sheet? see code
porosity_rdg = 0.3    # ridge porosity (fraction of voids)

puny = 1.0e-11
bignum = 1.0e30
hs_min = 1.0e-4       # minimum snow thickness [m]
hi_min = 0.01         # minimum ice thickness in cleanup [m]
hfrazilmin = 0.05     # minimum thickness of new frazil ice [m]
phi_init = 0.75       # initial liquid fraction of frazil (mushy only; unused)
dSin0_frazil = 3.0    # bulk salinity reduction of newly formed frazil (unused)
qqqice = 11221.8      # saturation-humidity-over-ice coefficients (CICE)
TTTice = 5897.8
qqqocn = 627572.4     # over ocean (unused here; ocean humidity from forcing)
TTTocn = 5107.4
