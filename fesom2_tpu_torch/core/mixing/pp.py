"""Pacanowski & Philander (1981) Richardson-number mixing + convection.

The port of ``fesom2_tpu/core/mixing/pp.py`` (ref
``src/oce_ale_mixing_pp.F90:2-88``, ``src/oce_mo_conv.F90:4-194`` with
the Monin-Obukhov mixing of ``use_momix``).
"""
from __future__ import annotations

from dataclasses import replace

import torch

from ...constants import rad
from ...mesh import MeshTables
from ..state import OceanState


def oce_mixing_pp(state: OceanState, mesh: MeshTables, cfg) -> OceanState:
    """Av = mix_coeff_PP*<f^2>/3 + A_ver;  Kv = mix_coeff_PP*f^3 + K_ver,
    f = shear/(shear + 5 max(N^2,0) + 1e-14)."""
    mix_coeff_PP = 0.01  # o_PARAM default (oce_modules.F90:24)
    Z3 = state.Z_3d
    dz = Z3[:-1] - Z3[1:]
    dz_inv = 1.0 / torch.where(dz == 0, 1.0, dz)
    du = (state.unode[:-1] - state.unode[1:]) * dz_inv
    dv = (state.vnode[:-1] - state.vnode[1:]) * dz_inv
    shear = du * du + dv * dv
    f = shear / (shear + 5.0 * torch.clamp_min(state.bvfreq[1:-1], 0.0)
                 + 1.0e-14)
    fK = torch.zeros_like(state.Kv)
    fK[1:-1] = f
    lev = torch.arange(mesh.nl, device=Z3.device)[:, None]
    imask = (lev >= 1) & (lev <= (mesh.nlevels_node - 2)[None, :])
    fK = torch.where(imask, fK, 0.0)

    # Av on elements from nodal f^2 (ref :48-57)
    fe = fK[:, mesh.elem_nodes]                             # [nl, E, 3]
    emask = (lev >= 1) & (lev <= (mesh.nlevels_elem - 2)[None, :])
    Av = torch.where(emask, mix_coeff_PP * (fe ** 2).mean(-1) + cfg.dyn.A_ver,
                     0.0)
    Kv = torch.where(imask, mix_coeff_PP * fK ** 3 + cfg.tra.K_ver, 0.0)
    return replace(state, Av=Av, Kv=Kv)


def _mo_length(forcing, dt, mixlength):
    """Monin-Obukhov mixed-layer length of Timmermann & Beckmann 2004 (ref
    mo_length/pmlktmo oce_mo_conv.F90:108-194), relaxed in time with a
    10-day retreat constant."""
    cosgam = 0.913632                     # cos(24 deg)
    qfm = forcing.water_flux * 34.0
    qtm = -2.38e-7 * forcing.heat_flux
    tau = torch.sqrt(forcing.stress_atm_x ** 2 + forcing.stress_atm_y ** 2)
    ustar = torch.sqrt(tau / 1030.0)
    uabs = torch.sqrt(forcing.u_ice ** 2 + forcing.v_ice ** 2)
    a = forcing.a_ice
    qw = 1.25 * ustar ** 3 * (1.0 - a) + 0.005 * uabs ** 3 * cosgam * a

    # pmlktmo: 5 Newton iterations on 2 qw e^{-t/7} + g qrho t = 0
    qhw, betas, betat = 1.0 / 7.0, 0.0008, 0.00004
    qrho = betas * qfm - betat * qtm
    ttmp = torch.full_like(qrho, 60.0)
    for _ in range(5):
        a1 = torch.exp(-ttmp * qhw)
        f0 = 2.0 * qw * a1 + 9.81 * qrho * ttmp
        f1 = -2.0 * qw * a1 * qhw + 9.81 * qrho
        ttmp = torch.clamp_min(
            ttmp - f0 / torch.where(f1 == 0.0, -1e-30, f1), 10.0)
    obuk = torch.clamp_min(torch.where(qrho > 0.0, 0.0, ttmp), 10.0)
    rtc = dt / (10.0 * 86400.0)
    return torch.where(obuk < mixlength,
                       mixlength + (obuk - mixlength) * rtc, obuk)


def mo_convect(state: OceanState, mesh: MeshTables, cfg,
               forcing=None) -> OceanState:
    """Monin-Obukhov (TB04), instability and wind mixing enhancements
    (ref oce_mo_conv.F90:4-104)."""
    t = cfg.tra
    lev = torch.arange(mesh.nl, device=state.Kv.device)[:, None]
    Kv = state.Kv
    Av = state.Av
    imask = (lev >= 1) & (lev <= (mesh.nlevels_node - 2)[None, :])
    emask = (lev >= 1) & (lev <= (mesh.nlevels_elem - 2)[None, :])
    if t.use_momix and forcing is not None:
        lat = mesh.geo_coords[:, 1]
        apply_n = lat <= t.momix_lat * rad
        mixlength = torch.where(apply_n,
                                _mo_length(forcing, cfg.dt, state.mixlength),
                                state.mixlength)
        in_ml = torch.abs(state.zbar_3d) <= mixlength[None, :]
        # built at the state's dtype (a where() of two Python scalars
        # would take torch's default dtype)
        mo = (imask & in_ml & apply_n[None, :]).to(Kv.dtype) * t.momix_kv
        Kv = Kv + mo
        mo_e = mo[:, mesh.elem_nodes].mean(-1)
        lat_e = lat[mesh.elem_nodes].mean(-1)
        Av = Av + torch.where(emask & (lat_e <= t.momix_lat * rad)[None, :],
                              mo_e, 0.0)
        state = replace(state, mixlength=mixlength)
    if t.use_instabmix:
        unstable = state.bvfreq < 0.0
        Kv = torch.where(imask & unstable,
                         torch.clamp_min(Kv, t.instabmix_kv), Kv)
        une = unstable[:, mesh.elem_nodes].any(-1)
        Av = torch.where(emask & une, torch.clamp_min(Av, t.instabmix_kv), Av)
    if t.use_windmix:
        wmask = (lev >= 1) & (lev <= t.windmix_nl)
        Kv = torch.where(wmask & imask, torch.clamp_min(Kv, t.windmix_kv), Kv)
        Av = torch.where(wmask & emask, torch.clamp_min(Av, t.windmix_kv), Av)
    return replace(state, Kv=Kv, Av=Av)
