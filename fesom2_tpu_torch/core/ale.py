"""ALE vertical machinery, linfs: vertical velocity and thickness update.

The port of the linfs path of ``fesom2_tpu/core/ale.py`` (ref
``src/oce_ale.F90`` vert_vel_ale :1692-2204, update_thickness_ale
:800-993).
"""
from __future__ import annotations

from dataclasses import replace

import torch

from ..mesh import MeshTables
from .ops import cumsum_bottom_up, edge_divergence, edge_transport
from .state import OceanState, Forcing


def _linfs_only(cfg):
    if cfg.ale.which_ALE != "linfs":
        raise NotImplementedError(f"which_ALE='{cfg.ale.which_ALE}' is not "
                                  "ported yet: ROADMAP queue 1 item 8")


def vert_vel_ale(state: OceanState, mesh: MeshTables, cfg,
                 forcing: Forcing) -> OceanState:
    """Vertical velocity from the horizontal divergence, bottom up, and
    the vertical CFL number (ref :1724-1815, :2141-2154)."""
    _linfs_only(cfg)
    if cfg.dyn.w_split:
        raise NotImplementedError("the explicit/implicit w split is not "
                                  "ported yet: ROADMAP queue 1 item 8")
    he = torch.where(mesh.elem_layer_mask, state.helem, 0.0)
    flux = edge_transport(state.u * he, state.v * he, mesh)  # [nl-1, Ed]
    div = torch.cat([edge_divergence(flux, mesh),
                     flux.new_zeros((1, mesh.n_nodes))], 0)
    w = cumsum_bottom_up(div)
    w = torch.where(mesh.node_level_mask,
                    w / torch.where(mesh.area > 0, mesh.area, 1.0), 0.0)

    hnode_new = state.hnode
    nmask = mesh.node_layer_mask
    hsafe = torch.where(nmask, hnode_new, 1.0)
    c_up = torch.abs(w[:-1] * cfg.dt / hsafe)
    c_dn = torch.abs(w[1:] * cfg.dt / hsafe)
    cfl = torch.zeros_like(state.cfl_z)
    cfl[:-1] += torch.where(nmask, c_up, 0.0)
    cfl[1:] = torch.where(nmask, c_dn, 0.0) + cfl[1:]
    return replace(state, w=w, w_e=w, w_i=torch.zeros_like(w), cfl_z=cfl,
                   hnode_new=hnode_new)


def update_thickness(state: OceanState, mesh: MeshTables, cfg) -> OceanState:
    """hnode <- hnode_new etc.; nothing moves under linfs."""
    _linfs_only(cfg)
    return state
