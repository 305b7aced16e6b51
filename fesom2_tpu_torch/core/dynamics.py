"""Momentum: PGF, AB2 rhs with Coriolis and flux-form advection, the
easy-backscatter viscosity, implicit vertical viscosity, velocity update.

The port of the soufflet subset of ``fesom2_tpu/core/dynamics.py`` (ref
``src/oce_ale_vel_rhs.F90`` compute_vel_rhs :13-148, momentum_adv_scalar
:154-343; ``src/oce_dyn.F90`` update_vel :101-131, compute_vel_nodes
:133-169, visc_filt_bcksct :563-649; ``src/oce_ale.F90`` impl_vert_visc_ale
:2348-2517; ``src/oce_ale_pressure_bv.F90`` pressure_force_4_linfs_fullcell
:432-466).
"""
from __future__ import annotations

from dataclasses import replace

import torch

from fesom2_tpu.constants import g, density_0
from ..mesh import MeshTables
from .state import OceanState, Forcing
from .ops import (scalar_gradient, tridiag_solve, elem_to_node_mean,
                  edge_divergence)


def _elem_interface_mask(mesh: MeshTables):
    """[nl, E] True on the element's active interfaces."""
    lev = torch.arange(mesh.nl, device=mesh.zbar.device)[:, None]
    return (lev < (mesh.nlevels_elem - 1)[None, :]) \
        & (lev >= (mesh.ulevels_elem - 1)[None, :])


def pressure_force_linfs(state: OceanState, mesh: MeshTables) -> OceanState:
    """PGF from hydrostatic pressure (ref pressure_force_4_linfs_fullcell)."""
    gx, gy = scalar_gradient(state.hpressure / density_0, mesh)
    m = mesh.elem_layer_mask
    return replace(state, pgf_x=torch.where(m, gx, 0.0),
                   pgf_y=torch.where(m, gy, 0.0))


def pressure_force(state: OceanState, mesh: MeshTables, cfg) -> OceanState:
    """PGF dispatch; the port has the linfs full-cell form only."""
    which = getattr(cfg.dyn, "which_pgf", "shchepetkin")
    if cfg.ale.which_ALE != "linfs" or cfg.ale.use_partial_cell \
            or getattr(cfg.run, "use_cavity_partial_cell", False) \
            or which in ("nemo", "cubicspline"):
        raise NotImplementedError(
            "only the linfs full-cell PGF is ported: the other forms are "
            "ROADMAP queue 1 items 8 and 15")
    return pressure_force_linfs(state, mesh)


def momentum_adv_scalar(state: OceanState, mesh: MeshTables,
                        u_rhsAB, v_rhsAB):
    """Flux-form momentum advection on scalar CVs (ref :154-343); returns
    (u_rhsAB, v_rhsAB) with the -div(u u) contribution added."""
    u, v = state.u, state.v
    area = mesh.elem_area

    # ---- vertical part: w * du/dz via interface velocities ---------------
    iface = _elem_interface_mask(mesh)
    zero = torch.zeros_like(u[:1])
    u_up = torch.where(iface, torch.cat([u[:1], 0.5 * (u[1:] + u[:-1]), zero]),
                       0.0)
    v_up = torch.where(iface, torch.cat([v[:1], 0.5 * (v[1:] + v[:-1]), zero]),
                       0.0)
    nie = mesh.nod_in_elem
    valid = nie >= 0
    safe = torch.where(valid, nie, 0)
    w_area = torch.where(valid, area[safe], 0.0)            # [N, K]
    uv_up = torch.stack([u_up, v_up])
    wuv = None
    for kk in range(safe.shape[-1]):                        # slot order
        vk = uv_up[..., safe[:, kk]] * w_area[:, kk]
        wuv = vk if wuv is None else wuv + vk
    wu = wuv[0] * state.w_e
    wv = wuv[1] * state.w_e
    nmask = mesh.node_layer_mask
    h = torch.where(nmask, state.hnode, 1.0)
    un_rhs = torch.where(nmask, -(wu[:-1] - wu[1:]) / (3.0 * h), 0.0)
    vn_rhs = torch.where(nmask, -(wv[:-1] - wv[1:]) / (3.0 * h), 0.0)

    # ---- horizontal part: edge loop ---------------------------------------
    et1 = mesh.edge_tri[:, 0]
    et2 = mesh.edge_tri[:, 1]
    has2 = et2 >= 0
    et2s = torch.where(has2, et2, 0)
    dX1, dY1 = mesh.edge_cross_dxdy[:, 0], mesh.edge_cross_dxdy[:, 1]
    dX2, dY2 = mesh.edge_cross_dxdy[:, 2], mesh.edge_cross_dxdy[:, 3]
    lmask = mesh.elem_layer_mask
    m1 = lmask[:, et1]
    m2 = lmask[:, et2s] & has2[None, :]
    u1, v1 = u[:, et1], v[:, et1]
    u2, v2 = u[:, et2s], v[:, et2s]
    un1 = torch.where(m1, v1 * dX1[None] - u1 * dY1[None], 0.0)
    un2 = torch.where(m2, -v2 * dX2[None] + u2 * dY2[None], 0.0)
    fu = un1 * torch.where(m1, u1, 0.0) + un2 * torch.where(m2, u2, 0.0)
    fv = un1 * torch.where(m1, v1, 0.0) + un2 * torch.where(m2, v2, 0.0)

    duv = edge_divergence(torch.stack([fu, fv]), mesh)
    un_rhs = (un_rhs + duv[0]) * mesh.areasvol_inv[:-1]
    vn_rhs = (vn_rhs + duv[1]) * mesh.areasvol_inv[:-1]

    # ---- back to elements ----------------------------------------------------
    en = mesh.elem_nodes
    uvn = torch.stack([un_rhs, vn_rhs])
    acc = uvn[..., en[:, 0]] + uvn[..., en[:, 1]] + uvn[..., en[:, 2]]
    uve = acc / 3.0 * area[None, :]
    u_rhsAB = u_rhsAB + torch.where(lmask, uve[0], 0.0)
    v_rhsAB = v_rhsAB + torch.where(lmask, uve[1], 0.0)
    return u_rhsAB, v_rhsAB


def compute_vel_rhs(state: OceanState, mesh: MeshTables, forcing: Forcing,
                    cfg):
    """AB2 momentum rhs (ref compute_vel_rhs :43-137).  Returns
    (state with the new AB memory, u_rhs, v_rhs)."""
    if cfg.dyn.mom_adv != 2:
        raise NotImplementedError("only flux-form momentum advection "
                                  "(mom_adv=2) is ported: mom_adv=3 is "
                                  "ROADMAP queue 1 item 15")
    if (cfg.run.use_floatice and cfg.ale.which_ALE != "linfs") \
            or cfg.run.l_mslp or cfg.run.use_global_tides:
        raise NotImplementedError("ice loading, sea-level pressure and tidal "
                                  "potential are not ported yet: ROADMAP "
                                  "queue 1 items 12-13 and 19")
    dt = cfg.dt
    eps = cfg.dyn.epsilon
    lmask = mesh.elem_layer_mask
    area = mesh.elem_area

    u_rhs = -(0.5 + eps) * state.u_rhsAB
    v_rhs = -(0.5 + eps) * state.v_rhsAB

    gx, gy = scalar_gradient(-g * state.eta, mesh)          # [E]
    Fx = gx[None, :] - state.pgf_x
    Fy = gy[None, :] - state.pgf_y
    u_rhs = u_rhs + torch.where(lmask, Fx * area[None], 0.0)
    v_rhs = v_rhs + torch.where(lmask, Fy * area[None], 0.0)

    ff = mesh.coriolis * area
    u_rhsAB = torch.where(lmask, state.v * ff[None], 0.0)
    v_rhsAB = torch.where(lmask, -state.u * ff[None], 0.0)
    u_rhsAB, v_rhsAB = momentum_adv_scalar(state, mesh, u_rhsAB, v_rhsAB)

    # first step is pure forward (ff_ab = 1, ref :123-127)
    first = state.step == 0
    ff_ab = torch.where(first, torch.ones_like(u_rhs[0, 0]),
                        torch.full_like(u_rhs[0, 0], 1.5 + eps))
    inv_area = 1.0 / torch.clamp_min(area, 1e-30)
    u_rhs = torch.where(lmask, dt * (u_rhs + u_rhsAB * ff_ab) * inv_area[None],
                        0.0)
    v_rhs = torch.where(lmask, dt * (v_rhs + v_rhsAB * ff_ab) * inv_area[None],
                        0.0)
    return replace(state, u_rhsAB=u_rhsAB, v_rhsAB=v_rhsAB), u_rhs, v_rhs


def visc_filt_bcksct(state: OceanState, mesh: MeshTables, cfg, u_rhs, v_rhs):
    """'Easy backscatter' viscosity filter, visc_option=5 (ref
    oce_dyn.F90:563-649)."""
    dt = cfg.dt
    d = cfg.dyn
    et1, et2 = mesh.edge_tri[:, 0], mesh.edge_tri[:, 1]
    internal = torch.arange(mesh.n_edges, device=et1.device) < mesh.n_edges_in
    et2s = torch.where(et2 >= 0, et2, 0)

    area = mesh.elem_area
    length = torch.sqrt(area[et1] + area[et2s])
    lmask = mesh.elem_layer_mask
    shared = lmask[:, et1] & lmask[:, et2s] & internal[None, :]

    du = state.u[:, et1] - state.u[:, et2s]
    dv = state.v[:, et1] - state.v[:, et2s]
    sp2 = du * du + dv * dv
    sp = torch.sqrt(sp2)
    vi = dt * torch.clamp_min(torch.maximum(d.gamma1 * sp, d.gamma2 * sp2),
                              d.gamma0) * length[None]
    du = torch.where(shared, du * vi, 0.0)
    dv = torch.where(shared, dv * vi, 0.0)

    # edge -> element: each element sums its 3 edges, sign -1 where it is
    # the edge's left triangle
    ee = mesh.elem_edges                                    # [E, 3]
    e_is_left = mesh.edge_tri[ee, 0] == torch.arange(
        mesh.n_elems, device=ee.device)[:, None]
    esign = torch.where(e_is_left, -1.0, 1.0).to(u_rhs.dtype)
    duv = torch.stack([du, dv])
    acc = duv[..., ee[:, 0]] * esign[:, 0]
    acc = acc + duv[..., ee[:, 1]] * esign[:, 1]
    acc = acc + duv[..., ee[:, 2]] * esign[:, 2]
    UV_b = acc * (1.0 / torch.clamp_min(area, 1e-30))[None, :]

    # smooth to nodes over ALL adjacent elements (ref :619-635)
    UV_c = elem_to_node_mean(UV_b, mesh, respect_levels=False)
    UVc_e = UV_c[..., mesh.elem_nodes].mean(-1)
    u_rhs = u_rhs + torch.where(lmask, UV_b[0] - d.easy_bs_return * UVc_e[0],
                                0.0)
    v_rhs = v_rhs + torch.where(lmask, UV_b[1] - d.easy_bs_return * UVc_e[1],
                                0.0)
    return u_rhs, v_rhs


def viscosity_filter(state: OceanState, mesh: MeshTables, cfg, u_rhs, v_rhs):
    """Dispatch on visc_option; the port has option 5 only."""
    if cfg.dyn.visc_option != 5:
        raise NotImplementedError(f"visc_option={cfg.dyn.visc_option} is not "
                                  "ported yet: ROADMAP queue 1 item 15")
    u_rhs, v_rhs = visc_filt_bcksct(state, mesh, cfg, u_rhs, v_rhs)
    return state, u_rhs, v_rhs


def impl_vert_visc(state: OceanState, mesh: MeshTables, cfg, forcing: Forcing,
                   u_rhs, v_rhs):
    """Implicit vertical viscosity, one tridiagonal system per element
    column shared by u and v (ref :2348-2517).  Returns the new (u_rhs,
    v_rhs) increments."""
    dt = cfg.dt
    nl, E = mesh.nl, mesh.n_elems
    dev, dtype = u_rhs.device, u_rhs.dtype
    nlev = mesh.nlevels_elem.long()
    lay = torch.arange(nl - 1, device=dev)[:, None]
    lmask = mesh.elem_layer_mask

    # element-wise interface depths from helem, bottom-up (ref :2372-2384)
    zbot = mesh.zbar_e_bot
    hsum = torch.cumsum(torch.flip(torch.where(lmask, state.helem, 0.0),
                                   (0,)), 0)
    zbar_n = torch.cat([zbot[None, :] + torch.flip(hsum, (0,)),
                        zbot[None, :]], 0)
    Z_n = 0.5 * (zbar_n[:-1] + zbar_n[1:])

    wi_e = state.w_i[:, mesh.elem_nodes].mean(-1)           # [nl, E]

    h_lay = torch.where(lmask, zbar_n[:-1] - zbar_n[1:], 1.0)
    zinv = dt / h_lay
    dZ = Z_n[:-1] - Z_n[1:]

    Av = state.Av
    is_bot = lay == (nlev - 2)[None, :]
    is_surf = lay == (mesh.ulevels_elem - 1)[None, :]

    a_visc = torch.zeros((nl - 1, E), dtype=dtype, device=dev)
    a_visc[1:] = -Av[1:-1] / dZ * zinv[1:]
    a_visc = torch.where(is_surf, 0.0, a_visc)
    c_visc = torch.zeros((nl - 1, E), dtype=dtype, device=dev)
    c_visc[:-1] = -Av[1:-1] / dZ * zinv[:-1]
    c_visc = torch.where(is_bot, 0.0, c_visc)

    # vertical advection of the implicit split (ref :2395-2437)
    wu = wi_e[:-1]
    wd = wi_e[1:]
    a_adv = torch.where(is_surf, 0.0, torch.clamp_max(wu, 0.0) * zinv)
    b_adv_u = torch.where(is_surf, wu * zinv, torch.clamp_min(wu, 0.0) * zinv)
    b_adv_d = torch.where(is_bot, 0.0, -torch.clamp_max(wd, 0.0) * zinv)
    c_adv = torch.where(is_bot, 0.0, -torch.clamp_min(wd, 0.0) * zinv)

    a = a_visc + a_adv
    c = c_visc + c_adv
    b = -a_visc - c_visc + 1.0 + b_adv_u + b_adv_d
    a = torch.where(lmask, a, 0.0)
    c = torch.where(lmask, c, 0.0)
    b = torch.where(lmask, b, 1.0)

    # surface stress (ref :2444-2451) and bottom friction (ref :2453-2460)
    ur = u_rhs + torch.where(is_surf, zinv * (forcing.stress_x / density_0)[None, :], 0.0)
    vr = v_rhs + torch.where(is_surf, zinv * (forcing.stress_y / density_0)[None, :], 0.0)
    ubot = torch.gather(state.u, 0, (nlev - 2)[None, :])[0]
    vbot = torch.gather(state.v, 0, (nlev - 2)[None, :])[0]
    fric = -cfg.dyn.C_d * torch.sqrt(ubot ** 2 + vbot ** 2)
    ur = ur + torch.where(is_bot, zinv * (fric * ubot)[None, :], 0.0)
    vr = vr + torch.where(is_bot, zinv * (fric * vbot)[None, :], 0.0)

    # subtract the operator applied to the previous velocity (ref :2465-2475)
    zrow = torch.zeros_like(state.u[:1])
    u_prev = torch.where(lmask, state.u, 0.0)
    v_prev = torch.where(lmask, state.v, 0.0)
    ur = ur - a * torch.cat([zrow, u_prev[:-1]]) - (b - 1.0) * u_prev \
        - c * torch.cat([u_prev[1:], zrow])
    vr = vr - a * torch.cat([zrow, v_prev[:-1]]) - (b - 1.0) * v_prev \
        - c * torch.cat([v_prev[1:], zrow])
    rhs = torch.where(lmask, torch.stack([ur, vr]), 0.0)

    uv_new = torch.where(lmask, tridiag_solve(a, b, c, rhs), 0.0)
    return uv_new[0], uv_new[1]


def update_vel(state: OceanState, mesh: MeshTables, cfg, u_rhs, v_rhs,
               d_eta) -> OceanState:
    """u^{n+1} = u + du - g theta dt grad(d_eta) (ref update_vel oce_dyn.F90:101)."""
    gx, gy = scalar_gradient(-g * cfg.dyn.theta * cfg.dt * d_eta, mesh)
    lmask = mesh.elem_layer_mask
    u = torch.where(lmask, state.u + u_rhs + gx[None, :], 0.0)
    v = torch.where(lmask, state.v + v_rhs + gy[None, :], 0.0)
    return replace(state, u=u, v=v, eta=state.eta + d_eta)


def compute_vel_nodes(state: OceanState, mesh: MeshTables) -> OceanState:
    """Element->node velocity average (ref compute_vel_nodes oce_dyn.F90:133)."""
    uvn = elem_to_node_mean(torch.stack([state.u, state.v]), mesh)
    nm = mesh.node_layer_mask
    return replace(state, unode=torch.where(nm, uvn[0], 0.0),
                   vnode=torch.where(nm, uvn[1], 0.0))
