"""Pacanowski & Philander (1981) Richardson-number mixing + convection.

The port of ``fesom2_tpu/core/mixing/pp.py`` (ref
``src/oce_ale_mixing_pp.F90:2-88``, ``src/oce_mo_conv.F90:4-104``).
"""
from __future__ import annotations

from dataclasses import replace

import torch

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


def mo_convect(state: OceanState, mesh: MeshTables, cfg,
               forcing=None) -> OceanState:
    """Instability and wind mixing enhancements (ref oce_mo_conv.F90:4-104)."""
    t = cfg.tra
    if t.use_momix:
        raise NotImplementedError("Monin-Obukhov mixing (use_momix) is not "
                                  "ported yet: ROADMAP queue 1 item 15")
    lev = torch.arange(mesh.nl, device=state.Kv.device)[:, None]
    Kv = state.Kv
    Av = state.Av
    imask = (lev >= 1) & (lev <= (mesh.nlevels_node - 2)[None, :])
    emask = (lev >= 1) & (lev <= (mesh.nlevels_elem - 2)[None, :])
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
