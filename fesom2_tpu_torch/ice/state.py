"""Sea-ice state and atmospheric inputs (replaces i_ARRAYS,
``src/ice_modules.F90:52-105``).

The port of ``fesom2_tpu/ice/state.py``: the same constants and the same
fields in the same order, so that states convert field for field
(``convert.ice_state_from_numpy``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..mesh import MeshTables

# thermodynamic constants (i_therm_param, ice_modules.F90:109-156)
rhoair = 1.3
inv_rhoair = 1.0 / 1.3
rhowat = 1025.0
inv_rhowat = 1.0 / 1025.0
rhoice = 910.0
inv_rhoice = 1.0 / 910.0
rhosno = 290.0
inv_rhosno = 1.0 / 290.0
cpair = 1005.0
cc = rhowat * 4190.0
cl = rhoice * 3.34e5
clhw = 2.501e6
clhi = 2.835e6
tmelt = 273.15
boltzmann = 5.67e-8
Sice = 4.0
iclasses = 7
hmin = 0.01
Armin = 0.01
Ch_atm_ice = 1.75e-3  # transfer coeff. sensible heat over ice (gen_modules_forcing.F90:18)
Ce_atm_ice = 1.75e-3  # transfer coeff. evaporation over ice (gen_modules_forcing.F90:17)


@dataclass
class IceState:
    u_ice: torch.Tensor       # [N]
    v_ice: torch.Tensor       # [N]
    m_ice: torch.Tensor       # [N] ice volume per area [m]
    a_ice: torch.Tensor       # [N] concentration
    m_snow: torch.Tensor      # [N]
    sigma11: torch.Tensor     # [E] stress memory across subcycles/steps
    sigma12: torch.Tensor
    sigma22: torch.Tensor
    t_skin: torch.Tensor      # [N] snow/ice surface temperature [C]
    # fluxes to the ocean (filled by thermodynamics)
    fresh_wa_flux: torch.Tensor   # [N] positive down
    net_heat_flux: torch.Tensor   # [N] positive down
    real_salt_flux: torch.Tensor  # [N]
    evaporation: torch.Tensor     # [N]
    thdgr: torch.Tensor           # [N] thermodynamic ice growth rate [m/s]
    thdgrsn: torch.Tensor         # [N]
    flice: torch.Tensor           # [N] snow->ice flooding rate
    a_ice_old: torch.Tensor       # [N] (pre-thermo concentration, for fluxes)
    # adaptive-EVP stability parameters (whichEVP=2, ice/evp.py:
    # aevp_subcycles; restarts carry them, io/restart.py ICE_FIELDS)
    alpha_aevp: torch.Tensor      # [E]
    beta_aevp: torch.Tensor       # [N]


@dataclass
class IceForcing:
    """Atmospheric inputs to the ice model (subset of g_forcing_arrays)."""
    shortwave: torch.Tensor
    longwave: torch.Tensor
    Tair: torch.Tensor        # [C]
    shum: torch.Tensor        # specific humidity
    prec_rain: torch.Tensor   # [m water/s]
    prec_snow: torch.Tensor
    runoff: torch.Tensor
    evaporation_in: torch.Tensor
    u_wind: torch.Tensor
    v_wind: torch.Tensor
    stress_atmice_x: torch.Tensor
    stress_atmice_y: torch.Tensor
    stress_atmoce_x: torch.Tensor
    stress_atmoce_y: torch.Tensor
    Ch_atm_oce: torch.Tensor  # sensible-heat transfer coeff over open water
    Ce_atm_oce: torch.Tensor  # evaporation transfer coeff over open water


@dataclass
class OceanSurface:
    """Ocean fields seen by the ice model (ocean2ice output)."""
    T_oc: torch.Tensor
    S_oc: torch.Tensor
    u_w: torch.Tensor
    v_w: torch.Tensor
    elevation: torch.Tensor


def allocate_ice(mesh: MeshTables, dtype=torch.float64) -> IceState:
    N, E = mesh.n_nodes, mesh.n_elems
    dev = mesh.zbar.device
    z = lambda n: torch.zeros(n, dtype=dtype, device=dev)
    return IceState(u_ice=z(N), v_ice=z(N), m_ice=z(N), a_ice=z(N),
                    m_snow=z(N), sigma11=z(E), sigma12=z(E), sigma22=z(E),
                    t_skin=z(N), fresh_wa_flux=z(N), net_heat_flux=z(N),
                    real_salt_flux=z(N), evaporation=z(N), thdgr=z(N),
                    thdgrsn=z(N), flice=z(N), a_ice_old=z(N),
                    alpha_aevp=torch.full((E,), 250.0, dtype=dtype, device=dev),
                    beta_aevp=torch.full((N,), 250.0, dtype=dtype, device=dev))


def zero_ice_forcing(mesh: MeshTables, dtype=torch.float64) -> IceForcing:
    N = mesh.n_nodes
    dev = mesh.zbar.device
    z = lambda: torch.zeros(N, dtype=dtype, device=dev)
    full = lambda v: torch.full((N,), v, dtype=dtype, device=dev)
    return IceForcing(shortwave=z(), longwave=z(), Tair=z(), shum=z(),
                      prec_rain=z(), prec_snow=z(), runoff=z(),
                      evaporation_in=z(), u_wind=z(), v_wind=z(),
                      stress_atmice_x=z(), stress_atmice_y=z(),
                      stress_atmoce_x=z(), stress_atmoce_y=z(),
                      Ch_atm_oce=full(1.75e-3), Ce_atm_oce=full(1.75e-3))
