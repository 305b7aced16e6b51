"""Ice-ocean coupling: field transfer and flux assembly.

The port of ``fesom2_tpu/ice/coupling.py``.  Reference:
``src/ice_oce_coupling.F90`` - ocean2ice :81-155, oce_fluxes_mom :4-78,
oce_fluxes :155-346.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from ..constants import density_0
from ..mesh import MeshTables
from ..core.state import OceanState, Forcing
from ..core.ops import elem_to_node_mean_flat, node_sum
from .state import (IceState, IceForcing, OceanSurface, rhoice, rhosno,
                    inv_rhowat)


def ocean2ice(state: OceanState, mesh: MeshTables) -> OceanSurface:
    """Copy SST/SSS/hbar and surface velocity (elem->node avg) to the ice."""
    # surface-layer element velocity averaged to nodes (ref :126-149)
    uv_w = elem_to_node_mean_flat(torch.stack([state.u[0], state.v[0]]), mesh)
    return OceanSurface(T_oc=state.tr[0, 0], S_oc=state.tr[1, 0],
                        u_w=uv_w[0], v_w=uv_w[1], elevation=state.hbar)


def oce_fluxes_mom(ice: IceState, ocean: OceanSurface, forcing: IceForcing,
                   mesh: MeshTables, cfg):
    """Combined ice+atm surface stress on elements (ref :4-78).

    Returns (stress_x_elem, stress_y_elem).
    """
    du = ice.u_ice - ocean.u_w
    dv = ice.v_ice - ocean.v_w
    aux = torch.sqrt(du * du + dv * dv) * density_0 * cfg.ice.Cd_oce_ice
    has = ice.a_ice > 0.001
    six = torch.where(has, aux * du, 0.0)
    siy = torch.where(has, aux * dv, 0.0)
    nx = six * ice.a_ice + forcing.stress_atmoce_x * (1.0 - ice.a_ice)
    ny = siy * ice.a_ice + forcing.stress_atmoce_y * (1.0 - ice.a_ice)
    en = mesh.elem_nodes
    return nx[en].mean(-1), ny[en].mean(-1)


def oce_fluxes(ice: IceState, ocean: OceanSurface, forcing: IceForcing,
               ocean_forcing: Forcing, mesh: MeshTables, cfg,
               use_virt_salt: bool, Ssurf=None, ref_sss: float = 34.0,
               ref_sss_local: bool = False) -> Forcing:
    """Heat/freshwater/virtual-salt fluxes to the ocean with global balancing
    (ref :155-346). Returns an updated ocean Forcing."""
    area1 = mesh.area[0]
    inv_ocean_area = 1.0 / mesh.ocean_area

    heat_flux = -ice.net_heat_flux
    water_flux = -ice.fresh_wa_flux

    # virtual salt flux + balancing (linfs; ref :244-262)
    if use_virt_salt:
        rsss = ocean.S_oc if ref_sss_local else ref_sss
        virtual_salt = rsss * water_flux
        net = node_sum(virtual_salt * area1) * inv_ocean_area
        virtual_salt = virtual_salt - net
    else:
        virtual_salt = torch.zeros_like(water_flux)

    # SSS relaxation + balancing (ref :276-290)
    if Ssurf is not None and cfg.tra.surf_relax_S != 0.0:
        relax_salt = cfg.tra.surf_relax_S * (Ssurf - ocean.S_oc)
        net = node_sum(relax_salt * area1) * inv_ocean_area
        relax_salt = relax_salt - net
    else:
        relax_salt = torch.zeros_like(water_flux)

    # zero total freshwater flux (ref :294-330)
    flux = ice.evaporation + forcing.prec_rain \
        + forcing.prec_snow * (1.0 - ice.a_ice_old) + forcing.runoff
    if not use_virt_salt:
        flux = flux - ice.thdgr * rhoice * inv_rhowat \
            - ice.thdgrsn * rhosno * inv_rhowat
    net = node_sum(flux * area1) * inv_ocean_area
    water_flux = water_flux + net

    return replace(ocean_forcing, heat_flux=heat_flux, water_flux=water_flux,
                   virtual_salt=virtual_salt, relax_salt=relax_salt,
                   real_salt_flux=ice.real_salt_flux,
                   prec_rain=forcing.prec_rain)
