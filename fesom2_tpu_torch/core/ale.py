"""ALE vertical machinery, linfs and zstar: vertical velocity and the
layer-thickness update.

The port of the linfs and zstar paths of ``fesom2_tpu/core/ale.py`` (ref
``src/oce_ale.F90`` vert_vel_ale :1692-2204 with the explicit/implicit w
split, update_thickness_ale :800-993) and of the GM bolus vertical
velocity ``bolus_wvel``.  zlevel raises.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from ..mesh import MeshTables
from .ops import cumsum_bottom_up, edge_divergence, edge_transport, take_row
from .state import OceanState, Forcing


def _check_ale(cfg):
    if cfg.ale.which_ALE not in ("linfs", "zstar"):
        raise NotImplementedError(f"which_ALE='{cfg.ale.which_ALE}' is not "
                                  "ported yet: ROADMAP queue 1 item 8")


def _nlevels_node_min(mesh: MeshTables) -> torch.Tensor:
    """min over adjacent elements of nlevels (ref nlevels_nod2D_min)."""
    nie = mesh.nod_in_elem
    valid = nie >= 0
    nle = torch.where(valid, mesh.nlevels_elem[nie.clamp_min(0)], 10 ** 6)
    return nle.amin(-1)


def vert_vel_ale(state: OceanState, mesh: MeshTables, cfg,
                 forcing: Forcing) -> OceanState:
    """Vertical velocity from the horizontal divergence, bottom up (ref
    :1724-1815); under zstar the hbar change is spread over the column in
    proportion to the unperturbed thickness (ref :2028-2092); then the
    vertical CFL number (ref :2141-2154) and, with ``w_split``, the split
    of w into an explicit part w_e and an implicit part w_i above the CFL
    limit w_max_cfl (ref :2189-2203)."""
    _check_ale(cfg)
    w = _divergence_wvel(state.u, state.v, state, mesh)

    hnode_new = state.hnode
    if cfg.ale.which_ALE == "zstar":
        dev = w.device
        nln_min = _nlevels_node_min(mesh)
        dd1 = take_row(state.zbar_3d, nln_min - 1)
        dd = (state.hbar - state.hbar_old) / (state.zbar_3d[0] - dd1)
        dddt = dd / cfg.dt
        lev = torch.arange(mesh.nl, device=dev)[:, None]
        w = w - torch.where(lev < (nln_min - 1)[None, :],
                            (state.zbar_3d - dd1[None, :]) * dddt[None, :],
                            0.0)
        lay = torch.arange(mesh.nl - 1, device=dev)[:, None]
        hnode_new = torch.where(
            lay < (nln_min - 1)[None, :],
            state.hnode + (state.zbar_3d[:-1] - state.zbar_3d[1:]) * dd[None, :],
            state.hnode)
        w = w + torch.where(lev == (mesh.ulevels_node - 1)[None, :],
                            -forcing.water_flux[None, :], 0.0)

    nmask = mesh.node_layer_mask
    hsafe = torch.where(nmask, hnode_new, 1.0)
    c_up = torch.abs(w[:-1] * cfg.dt / hsafe)
    c_dn = torch.abs(w[1:] * cfg.dt / hsafe)
    cfl = torch.zeros_like(state.cfl_z)
    cfl[:-1] += torch.where(nmask, c_up, 0.0)
    cfl[1:] = torch.where(nmask, c_dn, 0.0) + cfl[1:]
    if cfg.dyn.w_split:
        dd = torch.clamp_min(cfl - cfg.dyn.w_max_cfl, 0.0) \
            / max(cfg.dyn.w_max_cfl, 1e-12)
        w_e = 1.0 / (1.0 + dd) * w
        w_i = dd / (1.0 + dd) * w
    else:
        w_e, w_i = w, torch.zeros_like(w)
    return replace(state, w=w, w_e=w_e, w_i=w_i, cfl_z=cfl,
                   hnode_new=hnode_new)


def _divergence_wvel(u, v, state: OceanState, mesh: MeshTables):
    """Vertical velocity [nl, N] of the horizontal flow (u, v) on elements:
    edge transports, their divergence, summed bottom up, over the area
    (ref :1720-1815)."""
    he = torch.where(mesh.elem_layer_mask, state.helem, 0.0)
    flux = edge_transport(u * he, v * he, mesh)             # [nl-1, Ed]
    div = torch.cat([edge_divergence(flux, mesh),
                     flux.new_zeros((1, mesh.n_nodes))], 0)
    w = cumsum_bottom_up(div)
    return torch.where(mesh.node_level_mask,
                       w / torch.where(mesh.area > 0, mesh.area, 1.0), 0.0)


def bolus_wvel(fer_u, fer_v, state: OceanState, mesh: MeshTables):
    """Vertical bolus velocity [nl, N] of the GM bolus velocity (ref
    :1720-1815 with fer_UV -> fer_Wvel)."""
    return _divergence_wvel(fer_u, fer_v, state, mesh)


def update_thickness(state: OceanState, mesh: MeshTables, cfg) -> OceanState:
    """hnode <- hnode_new; helem, zbar_3d and Z_3d follow (ref :800-993).
    Nothing moves under linfs."""
    _check_ale(cfg)
    if cfg.ale.which_ALE == "linfs":
        return state
    dev = state.hnode.device
    hnode = state.hnode_new
    # interface depths bottom-up from the fixed bottom (ref :962-970)
    zbot = mesh.zbar_n_bot
    hsum = torch.cumsum(torch.flip(
        torch.where(mesh.node_layer_mask, hnode, 0.0), (0,)), 0)
    zbar_3d = torch.cat([zbot[None, :] + torch.flip(hsum, (0,)),
                         zbot[None, :]], 0)
    lev = torch.arange(mesh.nl, device=dev)[:, None]
    zbar_3d = torch.where(lev <= (mesh.nlevels_node - 1)[None, :], zbar_3d,
                          zbot[None, :])
    Z_3d = torch.where(mesh.node_layer_mask,
                       0.5 * (zbar_3d[:-1] + zbar_3d[1:]), state.Z_3d)

    # helem = nodal mean (ref :975-990); the bottom layer keeps its value
    helem = hnode[:, mesh.elem_nodes].mean(-1)
    lay = torch.arange(mesh.nl - 1, device=dev)[:, None]
    helem = torch.where(lay == (mesh.nlevels_elem - 2)[None, :], state.helem,
                        helem)
    helem = torch.where(mesh.elem_layer_mask, helem, 0.0)
    return replace(state, hnode=hnode, helem=helem, zbar_3d=zbar_3d, Z_3d=Z_3d)
