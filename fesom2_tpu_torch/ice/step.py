"""The ice time step: dynamics -> FCT advection -> thermodynamics.

The port of ``fesom2_tpu/ice/step.py:ice_timestep``.  Reference:
``src/ice_setup_step.F90`` ice_timestep :165-279.  The coupled-mode step
(``ice_timestep_cpl``) needs ``thermo_cpl``, which is not ported.
"""
from __future__ import annotations

from torch.profiler import record_function

from ..mesh import MeshTables
from .state import IceState, IceForcing, OceanSurface
from .evp import ice_dynamics
from .fct import ice_fct_advect
from .thermo import thermodynamics


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
