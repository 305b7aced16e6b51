"""The ice time step: dynamics -> FCT advection -> thermodynamics.

The port of ``fesom2_tpu/ice/step.py:ice_timestep``.  Reference:
``src/ice_setup_step.F90`` ice_timestep :165-279.  ``ice_timestep_cpl``
is the coupled-mode step of ``fesom2_tpu/ice/step.py:26-40``: the same
dynamics and advection, then the Dorn 2009 thermodynamics of
``thermo_cpl`` on the fluxes of an atmosphere model.
"""
from __future__ import annotations

from torch.profiler import record_function

from ..mesh import MeshTables
from .state import IceState, IceForcing, OceanSurface
from .evp import ice_dynamics
from .fct import ice_fct_advect
from .thermo import thermodynamics
from .thermo_cpl import CoupledAtmFluxes, thermodynamics_cpl


def ice_timestep(ice: IceState, mesh: MeshTables, forcing: IceForcing,
                 ocean: OceanSurface, cfg, use_virt_salt: bool,
                 ref_sss: float = 34.0, ref_sss_local: bool = False,
                 sub=None) -> IceState:
    """One ice step; the three named spans mark its layers for
    torch.profiler."""
    ice_dt = cfg.dt * cfg.ice.ice_ave_steps
    with record_function("step.ice.evp"):
        ice = ice_dynamics(ice, mesh, forcing, ocean, cfg, sub=sub)
    with record_function("step.ice.fct"):
        ice = ice_fct_advect(ice, mesh, cfg, ice_dt)
    with record_function("step.ice.thermo"):
        ice = thermodynamics(ice, mesh, forcing, ocean, cfg, use_virt_salt,
                             ref_sss, ref_sss_local)
    return ice


def ice_timestep_cpl(ice: IceState, mesh: MeshTables, forcing: IceForcing,
                     atm_fluxes: CoupledAtmFluxes, ocean: OceanSurface, cfg,
                     use_virt_salt: bool, ref_sss: float = 34.0,
                     ref_sss_local: bool = False) -> IceState:
    """The coupled-mode ice step (ref ice_thermo_cpl.F90 in place of
    ice_thermo_oce.F90 in __oasis builds): dynamics on the whole mesh and
    advection as ``ice_timestep``, then ``thermodynamics_cpl`` on
    ``atm_fluxes``."""
    ice_dt = cfg.dt * cfg.ice.ice_ave_steps
    with record_function("step.ice.evp"):
        ice = ice_dynamics(ice, mesh, forcing, ocean, cfg)
    with record_function("step.ice.fct"):
        ice = ice_fct_advect(ice, mesh, cfg, ice_dt)
    with record_function("step.ice.thermo"):
        ice = thermodynamics_cpl(ice, atm_fluxes, ocean, cfg, use_virt_salt,
                                 ref_sss, ref_sss_local)
    return ice
