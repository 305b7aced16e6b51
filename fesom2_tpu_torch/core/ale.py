"""ALE vertical machinery, linfs, zlevel and zstar: vertical velocity and
the layer-thickness update.

The port of ``fesom2_tpu/core/ale.py`` (ref ``src/oce_ale.F90``
vert_vel_ale :1692-2204 with the explicit/implicit w split and zlevel's
local-zstar fallback, update_thickness_ale :800-993) and of the GM bolus
vertical velocity ``bolus_wvel``.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from ..mesh import MeshTables
from .ops import (cumsum_bottom_up, edge_divergence, edge_transport,
                  halo_fix_nodes, take_row)
from .state import OceanState, Forcing


def _nlevels_node_min(mesh: MeshTables) -> torch.Tensor:
    """min over adjacent elements of nlevels (ref nlevels_nod2D_min)."""
    nie = mesh.nod_in_elem
    valid = nie >= 0
    nle = torch.where(valid, mesh.nlevels_elem[nie.clamp_min(0)], 10 ** 6)
    return halo_fix_nodes(nle.amin(-1))


def vert_vel_ale(state: OceanState, mesh: MeshTables, cfg,
                 forcing: Forcing) -> OceanState:
    """Vertical velocity from the horizontal divergence, bottom up (ref
    :1724-1815); under zstar the hbar change is spread over the column in
    proportion to the unperturbed thickness (ref :2028-2092), under zlevel
    by ``_zlevel_distribution``; then the
    vertical CFL number (ref :2141-2154) and, with ``w_split``, the split
    of w into an explicit part w_e and an implicit part w_i above the CFL
    limit w_max_cfl (ref :2189-2203)."""
    w = _divergence_wvel(state.u, state.v, state, mesh)

    hnode_new = state.hnode
    if cfg.ale.which_ALE == "zlevel":
        dist = _zlevel_distribution(state, mesh, cfg)
        # W at interface k takes all that is distributed at or below k
        w = torch.cat([w[:-1] - cumsum_bottom_up(dist) / cfg.dt, w[-1:]])
        hnode_new = hnode_new + dist
        lev = torch.arange(mesh.nl, device=w.device)[:, None]
        w = w + torch.where(lev == (mesh.ulevels_node - 1)[None, :],
                            -forcing.water_flux[None, :], 0.0)
    elif cfg.ale.which_ALE == "zstar":
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


def _zlevel_distribution(state: OceanState, mesh: MeshTables, cfg):
    """[nl-1, N]: where zlevel puts each column's hbar change (ref
    oce_ale.F90:1836-2016).  (C) the surface layer takes it all; (A) a
    drop that would thin the surface layer below min_hnode of its nominal
    thickness is spread greedily down the first lzstar_lev layers, each
    to its min_hnode capacity (none where cfl_z >= 0.95, read from the
    state as it enters); (B) a rise where a subsurface layer has a deficit
    refills the deficits bottom up, the rest to the surface.  The greedy
    spread is the one intended; the reference's capacity sum (:1891) is a
    pairwise sum used as a loop bound, as ``fesom2_tpu/core/ale.py`` notes.
    The two scans run over the layers in JAX's order."""
    dhbar = state.hbar - state.hbar_old
    K = int(cfg.ale.lzstar_lev)
    nominal = (mesh.zbar[:-1] - mesh.zbar[1:])[:, None]          # [nl-1, 1]
    lay = torch.arange(mesh.nl - 1, device=dhbar.device)[:, None]
    allowed = lay < torch.clamp_max(_nlevels_node_min(mesh) - 2, K)[None, :]
    hnode = state.hnode
    min_h = cfg.ale.min_hnode
    go_zstar = (dhbar < 0.0) & (hnode[0] + dhbar <= nominal[0] * min_h)
    deficit = nominal - hnode
    has_deficit = torch.where((lay >= 1) & (lay < K), deficit.abs(),
                              0.0).amax(0) > 0.0
    go_refill = (dhbar > 0.0) & has_deficit

    # (A) spread a drop top down, each layer to its capacity (<= 0)
    capA = torch.clamp_max(nominal * min_h - hnode, 0.0)
    capA = torch.where((state.cfl_z[:-1] >= 0.95) | ~allowed, 0.0, capA)
    distA, rest = [], dhbar
    for k in range(mesh.nl - 1):
        d = torch.maximum(rest, capA[k])
        rest = torch.clamp_max(rest - d, 0.0)
        distA.append(d)
    # (B) refill the deficits bottom up, the surface without limit
    capB = torch.where(allowed, torch.clamp_min(deficit, 0.0), 0.0)
    capB[0] = torch.where(allowed[0], 1000.0, 0.0)
    distB, rest = [None] * (mesh.nl - 1), dhbar
    for k in reversed(range(mesh.nl - 1)):
        d = torch.minimum(rest, capB[k])
        rest = torch.clamp_min(rest - d, 0.0)
        distB[k] = d
    # (C) all to the surface layer
    distC = torch.zeros_like(hnode)
    distC[0] = dhbar
    return torch.where(go_zstar[None, :], torch.stack(distA),
                       torch.where(go_refill[None, :], torch.stack(distB),
                                   distC))


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
    """hnode <- hnode_new; helem, zbar_3d and Z_3d follow (ref :800-993),
    under zlevel and zstar alike.  Nothing moves under linfs."""
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
