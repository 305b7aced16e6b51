# Frozen copy of fesom2_tpu_torch/core/dynamics.py, lines 1-1113 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""Momentum: the pressure-gradient forms, the AB2 rhs (flux-form or
vector-invariant advection, floating-ice loading), the viscosity filters,
implicit vertical viscosity, the velocity update.

The port of ``fesom2_tpu/core/dynamics.py`` (ref
``src/oce_ale_vel_rhs.F90`` compute_vel_rhs :13-148, momentum_adv_scalar
:154-343; ``src/oce_vel_rhs_vinv.F90``; ``src/oce_dyn.F90`` update_vel
:101-131, compute_vel_nodes :133-169, viscosity_filter :171-234 and the
filters :236-986, uke_update :988-1153; ``src/oce_ale.F90``
impl_vert_visc_ale :2348-2517; ``src/oce_ale_pressure_bv.F90`` the
pressure_force_4_linfs and pressure_force_4_zxxxx forms :371-2546).
Every assembly is a gather in fixed slot order, with no atomics: the
edge-to-element sums of the viscosity filters walk ``elem_edges``.
"""
from __future__ import annotations

import math
from dataclasses import replace

import torch

from ..constants import g, density_0, r_earth, rhoice, rhosno, rhowat
from ..mesh import MeshTables
from . import eos
from .state import OceanState, Forcing
from .ops import (scalar_gradient, tridiag_solve, elem_to_node_mean,
                  edge_divergence, cumsum_bottom_up, elem_contrib_to_nodes,
                  halo_fix_elems, halo_fix_nodes, take_row)


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


def _pgf_vertex_stencil(mesh: MeshTables):
    """Per-vertex 3-point vertical stencil of the moving-coordinate PGF
    (ref oce_ale_pressure_bv.F90:2209-2296): base b = k-1 in the interior,
    k at the surface, k-2 where the vertex column ends with the element's,
    clipped into the column.  Returns, per element vertex, (node ids [E],
    dm2, dm1): [nl-1, E] masks of the base offset d = b - k being -2 or -1
    (else 0), so the stencil reads are static shifts of the gathered
    column."""
    dev = mesh.zbar.device
    k = torch.arange(mesh.nl - 1, device=dev)[:, None]
    nle = (mesh.nlevels_elem - 1)[None, :]
    out = []
    for v in range(3):
        env = mesh.elem_nodes[:, v]
        nln = (mesh.nlevels_node[env] - 1)[None, :]
        b = torch.where(k == 0, 0, k - 1)
        b = torch.where((k == nle - 1) & (nln - 1 == k), k - 2, b)
        b = torch.minimum(torch.clamp_min(b, 0), torch.clamp_min(nln - 3, 0))
        d = torch.clamp(b - k, -2, 0)
        out.append((env, d == -2, d == -1))
    return out


def _shift_clamp(arr_e, j: int):
    """[nl-1, E] shifted vertically by a static j with edge clamping: row
    k becomes row clip(k+j, 0, nl-2)."""
    if j == 0:
        return arr_e
    if j > 0:
        return torch.cat([arr_e[j:], arr_e[-1:].expand((j,) + arr_e.shape[1:])])
    return torch.cat([arr_e[:1].expand((-j,) + arr_e.shape[1:]), arr_e[:j]])


def _stencil_reads(arr_e, dm2, dm1):
    """The 3 stencil values (base+0, base+1, base+2) of a gathered vertex
    column, from 5 static shifts and 2-level selects."""
    s = {j: _shift_clamp(arr_e, j) for j in (-2, -1, 0, 1, 2)}

    def pick(a, b, c):
        return torch.where(dm2, a, torch.where(dm1, b, c))
    return (pick(s[-2], s[-1], s[0]), pick(s[-1], s[0], s[1]),
            pick(s[0], s[1], s[2]))


def _safe(d):
    """d, with |d| <= 1e-30 replaced by 1e-30 (the divisions' guard)."""
    return torch.where(torch.abs(d) > 1e-30, d, 1e-30)


def _elem_mid_depths(state: OceanState, mesh: MeshTables):
    """(h, Z_e): the masked element thickness and the element mid-depths
    stacked up from the fixed bottom, [nl-1, E]."""
    h = torch.where(mesh.elem_layer_mask, state.helem, 0.0)
    return h, mesh.zbar_e_bot[None] + cumsum_bottom_up(h) - 0.5 * h


def _integrate_down(sum_x, sum_y, h, mesh: MeshTables) -> tuple:
    """The along-layer density gradient (sum_x, sum_y) integrated down by
    the midpoint rule: the integral above plus half of the layer's own."""
    lmask = mesh.elem_layer_mask
    aux_x = torch.where(lmask, sum_x * h * g / density_0, 0.0)
    aux_y = torch.where(lmask, sum_y * h * g / density_0, 0.0)
    pgf_x = torch.cumsum(aux_x, 0) - 0.5 * aux_x
    pgf_y = torch.cumsum(aux_y, 0) - 0.5 * aux_y
    return torch.where(lmask, pgf_x, 0.0), torch.where(lmask, pgf_y, 0.0)


def _take_layer(a, idx, nl: int):
    """a[idx[e], e] for a [nl-1, E], with idx [E] clipped into the column."""
    return torch.gather(a, 0, idx.clamp(0, nl - 2).long()[None, :])[0]


def pressure_force_zxxxx_shchepetkin(state: OceanState,
                                     mesh: MeshTables) -> OceanState:
    """Density-Jacobian PGF for moving coordinates, after Shchepetkin &
    McWilliams (2003): drho/dz * dz/dx is subtracted from the along-layer
    density gradient before the vertical integration (ref
    pressure_force_4_zxxxx_shchepetkin, oce_ale_pressure_bv.F90:1878-2104).
    The vertex drho/dz is a 3-point Newton polynomial on the node
    mid-depths Z_3d, evaluated at the element mid-depth."""
    lmask = mesh.elem_layer_mask
    rho = state.density_m_rho0
    Z3 = state.Z_3d
    h, Z_e = _elem_mid_depths(state, mesh)
    gx = mesh.gradient_sca[:, 0:3]
    gy = mesh.gradient_sca[:, 3:6]

    drho_dz = torch.zeros_like(Z_e)
    drho_dx = torch.zeros_like(Z_e)
    drho_dy = torch.zeros_like(Z_e)
    dz_dx = torch.zeros_like(Z_e)
    dz_dy = torch.zeros_like(Z_e)
    for v, (env, dm2, dm1) in enumerate(_pgf_vertex_stencil(mesh)):
        rho_v = rho[:, env]
        z_v = Z3[:, env]
        x0, x1, x2 = _stencil_reads(z_v, dm2, dm1)
        f0, f1, f2 = _stencil_reads(rho_v, dm2, dm1)
        dx10, dx21, dx20 = x1 - x0, x2 - x1, x2 - x0
        df10, df21 = f1 - f0, f2 - f1
        drho_dz = drho_dz + df10 / _safe(dx10) \
            + (dx10 * df21 - dx21 * df10) / _safe(dx20 * dx21 * dx10) \
            * ((Z_e - x1) + (Z_e - x0))
        drho_dx = drho_dx + rho_v * gx[None, :, v]
        drho_dy = drho_dy + rho_v * gy[None, :, v]
        dz_dx = dz_dx + z_v * gx[None, :, v]
        dz_dy = dz_dy + z_v * gy[None, :, v]
    drho_dz = torch.where(lmask, drho_dz / 3.0, 0.0)
    pgf_x, pgf_y = _integrate_down(drho_dx - drho_dz * dz_dx,
                                   drho_dy - drho_dz * dz_dy, h, mesh)
    return replace(state, pgf_x=pgf_x, pgf_y=pgf_y)


def pressure_force_easypgf(state: OceanState, mesh: MeshTables,
                           cfg) -> OceanState:
    """'easypgf': per layer, T and S are Newton-quadratically interpolated
    from each vertex column to the element mid-depth Z_e, the in-situ
    density is re-evaluated there and its along-layer gradient integrated
    down (ref pressure_force_4_zxxxx_easypgf, oce_ale_pressure_bv.F90:
    2116-2546; the linfs form :898-1245 is the same on linfs geometry)."""
    Z3 = state.Z_3d
    T, S_ = state.tr[0], state.tr[1]
    seq = cfg.dyn.state_equation
    h, Z_e = _elem_mid_depths(state, mesh)
    gx = mesh.gradient_sca[:, 0:3]
    gy = mesh.gradient_sca[:, 3:6]
    sum_x = torch.zeros_like(Z_e)
    sum_y = torch.zeros_like(Z_e)
    for v, (env, dm2, dm1) in enumerate(_pgf_vertex_stencil(mesh)):
        x0, x1, x2 = _stencil_reads(Z3[:, env], dm2, dm1)
        dx10, dx21, dx20 = x1 - x0, x2 - x1, x2 - x0

        def newton_at_ze(arr):
            f0, f1, f2 = _stencil_reads(arr[:, env], dm2, dm1)
            df10, df21 = f1 - f0, f2 - f1
            return f0 + df10 / _safe(dx10) * (Z_e - x0) \
                + (dx10 * df21 - dx21 * df10) / _safe(dx20 * dx21 * dx10) \
                * (Z_e - x1) * (Z_e - x0)

        b0, bpz, bpz2, rhopot = eos.eos_components(newton_at_ze(T),
                                                   newton_at_ze(S_), seq)
        rho = b0 + Z_e * (bpz + Z_e * bpz2)
        rho_at = rho * rhopot / (rho + 0.1 * Z_e * float(seq)) - density_0
        sum_x = sum_x + rho_at * gx[None, :, v]
        sum_y = sum_y + rho_at * gy[None, :, v]
    pgf_x, pgf_y = _integrate_down(sum_x, sum_y, h, mesh)
    return replace(state, pgf_x=pgf_x, pgf_y=pgf_y)


def _monotone_cubic(s1z, s2z, s3z, s4z, s1d, s2d, s3d, s4d, surf, bot, Z_e):
    """Monotone cubic Hermite (the FESOM1.4 spline) on [s2, s3] at Z_e,
    with the harmonic-mean derivative limit and one-sided surface and
    bottom closures, the surface's winning where both apply (ref
    oce_ale_pressure_bv.F90:1782, :1786-1846)."""
    s_H = _safe(s3z - s2z)
    aux1 = (s3d - s2d) / s_H

    def harm(a, b):
        return torch.where(a * b > 0.0, 2.0 * a * b / _safe(a + b), 0.0)

    aux_up = (s2d - s1d) / _safe(s2z - s1z)
    aux_lo = (s4d - s3d) / _safe(s4z - s3z)
    dup_i, dlo_i = harm(aux1, aux_up), harm(aux1, aux_lo)
    dlo_s = harm(aux1, aux_lo)
    dup_s = 1.5 * aux1 - 0.5 * dlo_s
    dup_b = harm(aux1, aux_up)
    dlo_b = 1.5 * aux1 - 0.5 * dup_b
    s_dup = torch.where(surf, dup_s, torch.where(bot, dup_b, dup_i))
    s_dlo = torch.where(surf, dlo_s, torch.where(bot, dlo_b, dlo_i))
    c_ = -(2.0 * s_dup + s_dlo) / s_H + 3.0 * (s3d - s2d) / s_H ** 2
    d_ = (s_dup + s_dlo) / s_H ** 2 - 2.0 * (s3d - s2d) / s_H ** 3
    dz = Z_e - s2z
    return s2d + s_dup * dz + c_ * dz ** 2 + d_ * dz ** 3


def _bracket_count(z_of, k, ul0, nln0, Z):
    """The count of a vertex column's valid node levels above Z, from k+1
    corrected over a window of +-3 levels (``z_of(j)``: the column's
    mid-depth at level k+j): exact where the node and element mid-depth
    stacks interleave within three levels."""
    c = k + 1 - ul0
    for j in (1, 2, 3):
        valid = (k + j <= nln0 - 1) & (k + j >= ul0)
        c = c + torch.where(valid & (z_of(j) > Z), 1, 0)
    for j in (0, -1, -2):
        valid = (k + j <= nln0 - 1) & (k + j >= ul0)
        c = c - torch.where(valid & (z_of(j) <= Z), 1, 0)
    return c


def pressure_force_zxxxx_cubicspline(state: OceanState,
                                     mesh: MeshTables) -> OceanState:
    """Cubic-spline PGF for moving coordinates: per layer each vertex
    column's density is monotone-cubic interpolated to the element
    mid-depth Z_e, then integrated down (ref
    pressure_force_4_zxxxx_cubicspline, oce_ale_pressure_bv.F90:1697-1866).
    The bracketing node level comes from a +-3-level window, not the
    reference's scan of the whole column (:1760-1768), as in
    ``fesom2_tpu/core/dynamics.py``."""
    nl = mesh.nl
    rho = state.density_m_rho0
    Z3 = state.Z_3d
    h, Z_e = _elem_mid_depths(state, mesh)
    gx = mesh.gradient_sca[:, 0:3]
    gy = mesh.gradient_sca[:, 3:6]
    k0 = torch.arange(nl - 1, device=Z3.device)[:, None]
    sum_x = torch.zeros_like(Z_e)
    sum_y = torch.zeros_like(Z_e)
    for v in range(3):
        env = mesh.elem_nodes[:, v]
        z_v = Z3[:, env]
        r_v = rho[:, env]
        nln0 = (mesh.nlevels_node[env] - 1)[None, :]
        ul0 = (mesh.ulevels_node[env] - 1)[None, :]
        c = _bracket_count(lambda j: _shift_clamp(z_v, j), k0, ul0, nln0, Z_e)
        nlc0 = torch.minimum(torch.maximum(c - 1, ul0), nln0 - 2)
        surf = nlc0 == ul0
        bot = (nlc0 == nln0 - 2) & ~surf

        def at(arr, idx):
            return torch.gather(arr, 0, idx.clamp(0, nl - 2).long())

        i1 = torch.where(surf, nlc0, nlc0 - 1)
        i4 = torch.where(bot, nlc0 + 1, nlc0 + 2)
        rho_n = _monotone_cubic(
            at(z_v, i1), at(z_v, nlc0), at(z_v, nlc0 + 1), at(z_v, i4),
            at(r_v, i1), at(r_v, nlc0), at(r_v, nlc0 + 1), at(r_v, i4),
            surf, bot, Z_e)
        sum_x = sum_x + rho_n * gx[None, :, v]
        sum_y = sum_y + rho_n * gy[None, :, v]
    pgf_x, pgf_y = _integrate_down(sum_x, sum_y, h, mesh)
    return replace(state, pgf_x=pgf_x, pgf_y=pgf_y)


def pressure_force_linfs_cubicspline(state: OceanState,
                                     mesh: MeshTables) -> OceanState:
    """linfs cubic-spline PGF (ref pressure_force_4_linfs_cubicspline,
    oce_ale_pressure_bv.F90:1252-1444): the direct along-layer density
    gradient above the element bottom (dz/dx = 0 on linfs); the bottom
    layer interpolates each vertex column's density to the element's
    bottom mid-depth with the monotone cubic's bottom closure."""
    nl = mesh.nl
    rho = state.density_m_rho0
    Z3 = state.Z_3d
    h, Z_e = _elem_mid_depths(state, mesh)
    gx = mesh.gradient_sca[:, 0:3]
    gy = mesh.gradient_sca[:, 3:6]
    nle0 = mesh.nlevels_elem - 2
    gx_r, gy_r = scalar_gradient(rho, mesh)
    Zb = _take_layer(Z_e, nle0, nl)
    bx = torch.zeros_like(Zb)
    by = torch.zeros_like(Zb)
    for v in range(3):
        env = mesh.elem_nodes[:, v]
        z_v = Z3[:, env]
        r_v = rho[:, env]
        nln0 = mesh.nlevels_node[env] - 1
        ul0 = mesh.ulevels_node[env] - 1
        c = _bracket_count(lambda j: _take_layer(z_v, nle0 + j, nl), nle0,
                           ul0, nln0, Zb)
        nlc0 = torch.minimum(torch.maximum(c - 1, ul0), nln0 - 2)
        surf = nlc0 == ul0
        i1 = torch.where(surf, nlc0, nlc0 - 1)
        rho_n = _monotone_cubic(
            _take_layer(z_v, i1, nl), _take_layer(z_v, nlc0, nl),
            _take_layer(z_v, nlc0 + 1, nl), _take_layer(z_v, nlc0 + 1, nl),
            _take_layer(r_v, i1, nl), _take_layer(r_v, nlc0, nl),
            _take_layer(r_v, nlc0 + 1, nl), _take_layer(r_v, nlc0 + 1, nl),
            surf, ~surf, Zb)
        bx = bx + rho_n * gx[:, v]
        by = by + rho_n * gy[:, v]
    is_bot = torch.arange(nl - 1, device=Z3.device)[:, None] == nle0[None, :]
    pgf_x, pgf_y = _integrate_down(torch.where(is_bot, bx[None, :], gx_r),
                                   torch.where(is_bot, by[None, :], gy_r),
                                   h, mesh)
    return replace(state, pgf_x=pgf_x, pgf_y=pgf_y)


def pressure_force_linfs_nemo(state: OceanState, mesh: MeshTables,
                              cfg) -> OceanState:
    """NEMO-style linfs PGF (ref pressure_force_4_linfs_nemo,
    oce_ale_pressure_bv.F90:479-635): the hydrostatic-pressure gradient
    above the element bottom; in the bottom layer T and S are linearly
    interpolated to the deepest common mid-depth, the in-situ density is
    re-evaluated there and each vertex's bottom pressure rebuilt before
    its gradient is taken (:560-633)."""
    nl = mesh.nl
    lmask = mesh.elem_layer_mask
    h_n = state.hnode
    T, S_ = state.tr[0], state.tr[1]
    Z3 = state.Z_3d
    seq = cfg.dyn.state_equation
    gx_p, gy_p = scalar_gradient(state.hpressure / density_0, mesh)
    nle0 = mesh.nlevels_elem - 2
    take_e = lambda a, i: _take_layer(a, i, nl)
    # Zt: the deepest vertex mid-depth of the bottom layer (:575); dh: the
    # thinnest vertex thickness there (:577)
    Zt = dh = None
    for v in range(3):
        env = mesh.elem_nodes[:, v]
        zv = take_e(Z3[:, env], nle0)
        hv = take_e(h_n[:, env], nle0)
        Zt = zv if Zt is None else torch.maximum(Zt, zv)
        dh = hv if dh is None else torch.minimum(dh, hv)
    # density_ref is not on the state: rho_insitu(T, S, Z) - density_m_rho0
    b0a, bpza, bpz2a, rpota = eos.eos_components(T, S_, seq)
    ra = b0a + Z3 * (bpza + Z3 * bpz2a)
    dref_rows = ra * rpota / (ra + 0.1 * Z3 * float(seq)) \
        - state.density_m_rho0
    bx = torch.zeros_like(Zt)
    by = torch.zeros_like(Zt)
    gx = mesh.gradient_sca[:, 0:3]
    gy = mesh.gradient_sca[:, 3:6]
    for v in range(3):
        env = mesh.elem_nodes[:, v]
        z_v = Z3[:, env]
        nln0 = mesh.nlevels_node[env] - 1
        ul0 = mesh.ulevels_node[env] - 1
        # the first node level at or below Zt (:569-573), 0-based interval
        # [nlc0 - 1, nlc0]
        c = _bracket_count(lambda j: take_e(z_v, nle0 + j), nle0, ul0, nln0,
                           Zt)
        nlc0 = torch.minimum(torch.maximum(c, ul0 + 1), nln0 - 1)
        za = take_e(z_v, nlc0 - 1)
        zb = take_e(z_v, nlc0)
        w = (Zt - za) / _safe(zb - za)
        t_at = take_e(T[:, env], nlc0 - 1) * (1 - w) \
            + take_e(T[:, env], nlc0) * w
        s_at = take_e(S_[:, env], nlc0 - 1) * (1 - w) \
            + take_e(S_[:, env], nlc0) * w
        b0, bpz, bpz2, rpot = eos.eos_components(t_at, s_at, seq)
        r = b0 + Zt * (bpz + Zt * bpz2)
        rho_b = r * rpot / (r + 0.1 * Zt * float(seq)) \
            - take_e(dref_rows[:, env], nle0)
        # the bottom pressure (:620-630) from the row above, 0-based
        # min(nlc0 - 1, nle0 - 1)
        row = torch.clamp_min(torch.minimum(nlc0 - 1, nle0 - 1), 0)
        hp_b = take_e(state.hpressure[:, env], row) + 0.5 * g * (
            take_e(state.density_m_rho0[:, env], row)
            * take_e(h_n[:, env], row) + rho_b * dh)
        bx = bx + hp_b * gx[:, v]
        by = by + hp_b * gy[:, v]
    is_bot = torch.arange(nl - 1, device=Z3.device)[:, None] == nle0[None, :]
    pgf_x = torch.where(is_bot, (bx / density_0)[None, :], gx_p)
    pgf_y = torch.where(is_bot, (by / density_0)[None, :], gy_p)
    return replace(state, pgf_x=torch.where(lmask, pgf_x, 0.0),
                   pgf_y=torch.where(lmask, pgf_y, 0.0))


def pressure_force_linfs_cavity(state: OceanState,
                                mesh: MeshTables) -> OceanState:
    """The 'sergey' linfs PGF of cavity and partial-cell geometry (ref
    pressure_force_4_linfs_cavity, oce_ale_pressure_bv.F90:1451-1658):
    the layers between take the hydrostatic-pressure gradient; the top
    layer under a cavity (ulevels > 1) and the partial bottom layer get the
    sloped density-Jacobian correction drho/dx - drho/dz dz/dx, the bottom
    anchored on the pressure integrated to its upper interface
    (:1590-1594)."""
    nl = mesh.nl
    lmask = mesh.elem_layer_mask
    rho = state.density_m_rho0
    Z3 = state.Z_3d
    dev = Z3.device
    lev = torch.arange(nl - 1, device=dev)[:, None]
    nle0 = (mesh.nlevels_elem - 2)[None, :]      # bottom layer row
    ule0 = (mesh.ulevels_elem - 1)[None, :]      # top layer row
    gx_p, gy_p = scalar_gradient(state.hpressure / density_0, mesh)

    # element mid-depths and the sloped correction (the shchepetkin
    # forms' stencil; only the top and bottom rows are used)
    h, Z_e = _elem_mid_depths(state, mesh)
    gx = mesh.gradient_sca[:, 0:3]
    gy = mesh.gradient_sca[:, 3:6]
    drho_dz = torch.zeros_like(Z_e)
    drho_dx = torch.zeros_like(Z_e)
    drho_dy = torch.zeros_like(Z_e)
    dz_dx = torch.zeros_like(Z_e)
    dz_dy = torch.zeros_like(Z_e)
    for v, (env, dm2, dm1) in enumerate(_pgf_vertex_stencil(mesh)):
        rho_v = rho[:, env]
        z_v = Z3[:, env]
        x0, x1, x2 = _stencil_reads(z_v, dm2, dm1)
        f0, f1, f2 = _stencil_reads(rho_v, dm2, dm1)
        dx10, dx21, dx20 = x1 - x0, x2 - x1, x2 - x0
        df10, df21 = f1 - f0, f2 - f1
        drho_dz = drho_dz + df10 / _safe(dx10) \
            + (dx10 * df21 - dx21 * df10) / _safe(dx20 * dx21 * dx10) \
            * ((Z_e - x1) + (Z_e - x0))
        drho_dx = drho_dx + rho_v * gx[None, :, v]
        drho_dy = drho_dy + rho_v * gy[None, :, v]
        dz_dx = dz_dx + z_v * gx[None, :, v]
        dz_dy = dz_dy + z_v * gy[None, :, v]
    drho_dz = drho_dz / 3.0
    aux_x = (drho_dx - drho_dz * dz_dx) * h * g / density_0
    aux_y = (drho_dy - drho_dz * dz_dy) * h * g / density_0

    # the bottom's anchor: the gradient of hpressure + g/2 rho hnode on
    # the row above the bottom (:1590-1594)
    hp_anchor = state.hpressure + 0.5 * g * rho \
        * torch.where(mesh.node_layer_mask, state.hnode, 0.0)
    ax, ay = scalar_gradient(hp_anchor / density_0, mesh)
    row = torch.clamp_min(nle0 - 1, 0).clamp(0, nl - 2).long()
    int_x = torch.gather(ax, 0, row)
    int_y = torch.gather(ay, 0, row)

    is_srf_cav = (lev == ule0) & (ule0 > 0)
    is_bot = lev == nle0
    pgf_x = torch.where(is_srf_cav, 0.5 * aux_x, gx_p)
    pgf_y = torch.where(is_srf_cav, 0.5 * aux_y, gy_p)
    pgf_x = torch.where(is_bot, int_x + 0.5 * aux_x, pgf_x)
    pgf_y = torch.where(is_bot, int_y + 0.5 * aux_y, pgf_y)
    return replace(state, pgf_x=torch.where(lmask, pgf_x, 0.0),
                   pgf_y=torch.where(lmask, pgf_y, 0.0))


def pressure_force(state: OceanState, mesh: MeshTables, cfg) -> OceanState:
    """PGF dispatch on ``which_pgf`` (ref pressure_force_4_linfs :371-427,
    pressure_force_4_zxxxx :1661-1687), as ``fesom2_tpu/core/dynamics.py:
    560-615``: under linfs on full cells nemo, cubicspline or else the
    hydrostatic-pressure gradient; linfs with partial cells nemo,
    shchepetkin, cubicspline or easypgf (the layer geometry is static
    there, so the moving-coordinate forms evaluate to the linfs ones);
    linfs with cavity partial cells (``cfg.run.use_cavity_partial_cell``,
    an attribute set on the configuration) sergey, shchepetkin or easypgf;
    zlevel and zstar shchepetkin, cubicspline or easypgf.  Another name
    raises ValueError."""
    which = getattr(cfg.dyn, "which_pgf", "shchepetkin")
    if cfg.ale.which_ALE == "linfs":
        use_cav_pc = getattr(cfg.run, "use_cavity_partial_cell", False)
        if use_cav_pc:
            if which == "sergey":
                return pressure_force_linfs_cavity(state, mesh)
            if which == "shchepetkin":
                return pressure_force_zxxxx_shchepetkin(state, mesh)
            if which == "easypgf":
                return pressure_force_easypgf(state, mesh, cfg)
            raise ValueError(
                f"which_pgf='{which}' not supported for linfs with cavity "
                "partial cells (ref :388-402: sergey, shchepetkin, easypgf)")
        if not cfg.ale.use_partial_cell:
            if which == "nemo":
                return pressure_force_linfs_nemo(state, mesh, cfg)
            if which == "cubicspline":
                return pressure_force_linfs_cubicspline(state, mesh)
            return pressure_force_linfs(state, mesh)
        if which == "nemo":
            return pressure_force_linfs_nemo(state, mesh, cfg)
        if which == "shchepetkin":
            return pressure_force_zxxxx_shchepetkin(state, mesh)
        if which == "cubicspline":
            return pressure_force_linfs_cubicspline(state, mesh)
        if which == "easypgf":
            return pressure_force_easypgf(state, mesh, cfg)
        raise ValueError(
            f"which_pgf='{which}' not supported for linfs with partial "
            "cells (ref :407-427: nemo, shchepetkin, cubicspline, easypgf)")
    if which == "easypgf":
        return pressure_force_easypgf(state, mesh, cfg)
    if which == "cubicspline":
        return pressure_force_zxxxx_cubicspline(state, mesh)
    if which != "shchepetkin":
        raise ValueError(f"which_pgf='{which}' not supported for "
                         "zlevel/zstar (ref :1671-1686: shchepetkin, "
                         "cubicspline, easypgf)")
    return pressure_force_zxxxx_shchepetkin(state, mesh)


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
    wuv = halo_fix_nodes(wuv)
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
    """AB2 momentum rhs (ref compute_vel_rhs :43-137), with flux-form
    advection where ``mom_adv`` is 2 (3 takes ``compute_vel_rhs_vinv``).
    Returns (state with the new AB memory, u_rhs, v_rhs)."""
    eps = cfg.dyn.epsilon
    lmask = mesh.elem_layer_mask
    area = mesh.elem_area

    u_rhs = -(0.5 + eps) * state.u_rhsAB
    v_rhs = -(0.5 + eps) * state.v_rhsAB

    # surface pressure: -(g eta + p_ice + p_air) - ssh_gp (ref :60-96):
    # floating-ice loading off linfs, sea-level pressure under l_mslp, the
    # tidal potential under use_global_tides
    pre2d = -g * state.eta
    if cfg.run.use_floatice and cfg.ale.which_ALE != "linfs":
        p_ice = (forcing.m_ice * rhoice + forcing.m_snow * rhosno) / rhowat
        pre2d = pre2d - g * torch.clamp_max(p_ice, cfg.ale.max_ice_loading)
    if cfg.run.l_mslp:
        pre2d = pre2d - forcing.press_air / 1000.0
    if cfg.run.use_global_tides:
        pre2d = pre2d - forcing.ssh_gp
    gx, gy = scalar_gradient(pre2d, mesh)                   # [E]
    Fx = gx[None, :] - state.pgf_x
    Fy = gy[None, :] - state.pgf_y
    u_rhs = u_rhs + torch.where(lmask, Fx * area[None], 0.0)
    v_rhs = v_rhs + torch.where(lmask, Fy * area[None], 0.0)

    ff = mesh.coriolis * area
    u_rhsAB = torch.where(lmask, state.v * ff[None], 0.0)
    v_rhsAB = torch.where(lmask, -state.u * ff[None], 0.0)
    if cfg.dyn.mom_adv == 2:
        u_rhsAB, v_rhsAB = momentum_adv_scalar(state, mesh, u_rhsAB, v_rhsAB)

    return _ab_combine(state, mesh, cfg, u_rhs, v_rhs, u_rhsAB, v_rhsAB)


def _ab_combine(state: OceanState, mesh: MeshTables, cfg, u_rhs, v_rhs,
                u_rhsAB, v_rhsAB):
    """dt (rhs + AB memory * ff_ab) / area, the first step pure forward
    (ff_ab = 1, ref :123-127); returns (state with the new AB memory,
    u_rhs, v_rhs)."""
    lmask = mesh.elem_layer_mask
    ff_ab = torch.where(state.step == 0, torch.ones_like(u_rhs[0, 0]),
                        torch.full_like(u_rhs[0, 0], 1.5 + cfg.dyn.epsilon))
    inv_area = (1.0 / torch.clamp_min(mesh.elem_area, 1e-30))[None]
    u_rhs = torch.where(lmask, cfg.dt * (u_rhs + u_rhsAB * ff_ab) * inv_area,
                        0.0)
    v_rhs = torch.where(lmask, cfg.dt * (v_rhs + v_rhsAB * ff_ab) * inv_area,
                        0.0)
    return replace(state, u_rhsAB=u_rhsAB, v_rhsAB=v_rhsAB), u_rhs, v_rhs


def compute_vel_rhs_vinv(state: OceanState, mesh: MeshTables,
                         forcing: Forcing, cfg):
    """Vector-invariant momentum rhs, mom_adv=3 (ref compute_vel_rhs_vinv,
    oce_vel_rhs_vinv.F90:104-290): advection as (f + zeta) x u plus the
    gradient of the kinetic energy; pressure as the plain -grad(g eta +
    hpressure / rho0).  The reference's vertical block multiplies by a w
    that is never set (:119, :225-243), so it is left out, as in
    ``fesom2_tpu/core/dynamics.py``; neither takes the sea-level pressure
    or the tidal potential here.  The kinetic energy is assembled to
    nodes by ``elem_contrib_to_nodes`` ([nl-1, E, 3]), the vorticity by
    ``node_edge_reduce``."""
    eps = cfg.dyn.epsilon
    lmask = mesh.elem_layer_mask
    area = mesh.elem_area
    nmask = mesh.node_layer_mask

    # kinetic energy at nodes: sum |U|^2 area / (6 areasvol) (ref :141-158),
    # zero at nodes on a boundary edge (:160-166)
    ke2 = torch.where(lmask, (state.u ** 2 + state.v ** 2) * area[None, :],
                      0.0)
    av = mesh.areasvol[:-1]
    KE = elem_contrib_to_nodes(ke2[..., None].expand(ke2.shape + (3,)), mesh) \
        / (6.0 * torch.where(av > 0, av, 1.0))
    ne = mesh.node_edges
    bnd_node = ((ne >= mesh.n_edges_in) & (ne >= 0)).any(-1)
    # bnd_node comes from a rank's incomplete halo rows: refresh the halo
    KE = halo_fix_nodes(torch.where(bnd_node[None, :] | ~nmask, 0.0, KE))

    u_rhs = -(0.5 + eps) * state.u_rhsAB
    v_rhs = -(0.5 + eps) * state.v_rhsAB
    # pressure, layer by layer (ref :185-196)
    Fx, Fy = scalar_gradient(-(g * state.eta[None, :]
                               + state.hpressure / density_0), mesh)
    u_rhs = u_rhs + torch.where(lmask, Fx * area[None], 0.0)
    v_rhs = v_rhs + torch.where(lmask, Fy * area[None], 0.0)

    # AB memory: -grad(KE) + (f + zeta) x u, both on elements (ref :197-204)
    Kx, Ky = scalar_gradient(-KE, mesh)
    fz = (mesh.coriolis_node[None, :] + relative_vorticity(state, mesh))
    fz = fz[..., mesh.elem_nodes].sum(-1) / 3.0
    u_rhsAB = torch.where(lmask, (state.v * fz + Kx) * area[None], 0.0)
    v_rhsAB = torch.where(lmask, (-state.u * fz + Ky) * area[None], 0.0)
    return _ab_combine(state, mesh, cfg, u_rhs, v_rhs, u_rhsAB, v_rhsAB)


def relative_vorticity(state: OceanState, mesh: MeshTables):
    """Relative vorticity at nodes [nl-1, N] (ref oce_vel_rhs_vinv.F90:
    14-103): the circulation of the edge segments, summed by
    ``edge_divergence``, over the node's area."""
    et1, et2 = mesh.edge_tri[:, 0], mesh.edge_tri[:, 1]
    has2 = et2 >= 0
    et2s = torch.where(has2, et2, 0)
    dX1, dY1 = mesh.edge_cross_dxdy[:, 0], mesh.edge_cross_dxdy[:, 1]
    dX2, dY2 = mesh.edge_cross_dxdy[:, 2], mesh.edge_cross_dxdy[:, 3]
    lmask = mesh.elem_layer_mask
    u, v = state.u, state.v
    c1 = torch.where(lmask[:, et1],
                     dX1[None] * u[:, et1] + dY1[None] * v[:, et1], 0.0)
    c2 = torch.where(lmask[:, et2s] & has2[None, :],
                     -dX2[None] * u[:, et2s] - dY2[None] * v[:, et2s], 0.0)
    vort = edge_divergence(c1 + c2, mesh) * mesh.areasvol_inv[:-1]
    return torch.where(mesh.node_layer_mask, vort, 0.0)


def _edge_internal_shared(mesh: MeshTables):
    """(shared [nl-1, Ed]: the internal edges' layers where both triangles
    are wet, et1, et2 with 0 for a missing second triangle)."""
    et1, et2 = mesh.edge_tri[:, 0], mesh.edge_tri[:, 1]
    et2s = torch.where(et2 >= 0, et2, 0)
    internal = torch.arange(mesh.n_edges, device=et1.device) < mesh.n_edges_in
    lmask = mesh.elem_layer_mask
    return lmask[:, et1] & lmask[:, et2s] & internal[None, :], et1, et2s


def _edge_diff(x, et1, et2s):
    """x[.., et1] - x[.., et2] of an element field, per edge."""
    return x[..., et1] - x[..., et2s]


def _accum_edge_to_elem(val, mesh: MeshTables):
    """Per element, the sum over its three edges (``elem_edges``, in slot
    order) of -val where it is the edge's first triangle, else +val: the
    scatter of ``visc_filt_harmon`` as a gather, with no atomics."""
    ee = mesh.elem_edges                                    # [E, 3]
    is_left = mesh.edge_tri[ee, 0] == torch.arange(
        mesh.n_elems, device=ee.device)[:, None]
    esign = torch.where(is_left, -1.0, 1.0).to(val.dtype)
    acc = val[..., ee[:, 0]] * esign[:, 0]
    acc = acc + val[..., ee[:, 1]] * esign[:, 1]
    return halo_fix_elems(acc + val[..., ee[:, 2]] * esign[:, 2])


def _apply_edge_filter(duv, mesh: MeshTables, u_rhs, v_rhs):
    """(u_rhs, v_rhs) plus the edge values duv [2, nl-1, Ed], +-val/area on
    the two triangles of each edge."""
    acc = _accum_edge_to_elem(duv, mesh) \
        * (1.0 / torch.clamp_min(mesh.elem_area, 1e-30))[None, :]
    return u_rhs + acc[0], v_rhs + acc[1]


def _uv_edge_diff(state: OceanState, shared, et1, et2s):
    """[2, nl-1, Ed]: the (u, v) jump across each shared edge, else 0."""
    return torch.where(shared, _edge_diff(torch.stack([state.u, state.v]),
                                          et1, et2s), 0.0)


def _biharmonic_second_stage(UV_c, shared, et1, et2s, mesh, u_rhs, v_rhs):
    """The Laplacian of the first stage's element field UV_c [2, nl-1, E]
    added to (u_rhs, v_rhs)."""
    duv2 = torch.where(shared, _edge_diff(UV_c, et1, et2s), 0.0)
    return _apply_edge_filter(duv2, mesh, u_rhs, v_rhs)


def visc_filt_harmon(state: OceanState, mesh: MeshTables, cfg, u_rhs, v_rhs):
    """Plain harmonic filter with the constant gamma0 (ref visc_filt_harmon
    oce_dyn.F90:236-273), the dispatch's fallback."""
    shared, et1, et2s = _edge_internal_shared(mesh)
    area = mesh.elem_area
    vi = cfg.dt * cfg.dyn.gamma0 * torch.sqrt(area[et1] + area[et2s])
    return _apply_edge_filter(_uv_edge_diff(state, shared, et1, et2s)
                              * vi[None, None, :], mesh, u_rhs, v_rhs)


def visc_filt_bcksct(state: OceanState, mesh: MeshTables, cfg, u_rhs, v_rhs):
    """'Easy backscatter' viscosity filter, visc_option=5 (ref
    oce_dyn.F90:563-649)."""
    d = cfg.dyn
    shared, et1, et2s = _edge_internal_shared(mesh)
    area = mesh.elem_area
    length = torch.sqrt(area[et1] + area[et2s])
    lmask = mesh.elem_layer_mask

    duv = _edge_diff(torch.stack([state.u, state.v]), et1, et2s)
    sp2 = duv[0] * duv[0] + duv[1] * duv[1]
    sp = torch.sqrt(sp2)
    vi = cfg.dt * torch.clamp_min(torch.maximum(d.gamma1 * sp, d.gamma2 * sp2),
                                  d.gamma0) * length[None]
    duv = torch.where(shared, duv * vi, 0.0)
    UV_b = _accum_edge_to_elem(duv, mesh) \
        * (1.0 / torch.clamp_min(area, 1e-30))[None, :]

    # smooth to nodes over ALL adjacent elements (ref :619-635)
    UV_c = elem_to_node_mean(UV_b, mesh, respect_levels=False)
    UVc_e = UV_c[..., mesh.elem_nodes].mean(-1)
    u_rhs = u_rhs + torch.where(lmask, UV_b[0] - d.easy_bs_return * UVc_e[0],
                                0.0)
    v_rhs = v_rhs + torch.where(lmask, UV_b[1] - d.easy_bs_return * UVc_e[1],
                                0.0)
    return u_rhs, v_rhs


def h_viscosity_leith(state: OceanState, mesh: MeshTables, cfg):
    """Leith and modified-Leith viscosity on elements [nl-1, E] (ref
    h_viscosity_leith oce_dyn.F90:461-562), smoothed twice through the
    nodes (:525-557)."""
    d = cfg.dyn
    en = mesh.elem_nodes
    lmask = mesh.elem_layer_mask
    hsafe = torch.where(lmask, state.helem, 1.0)
    dwdz = (state.w[:-1] - state.w[1:])[..., en] / hsafe[..., None]
    xe = (dwdz * mesh.gradient_sca[:, 0:3]).sum(-1)
    ye = (dwdz * mesh.gradient_sca[:, 3:6]).sum(-1)
    lx, ly = scalar_gradient(relative_vorticity(state, mesh), mesh)
    A = mesh.elem_area[None, :]
    visc = torch.minimum(
        d.gamma1 * A * torch.sqrt((d.Div_c * (xe ** 2 + ye ** 2)
                                   + d.Leith_c * (lx ** 2 + ly ** 2)) * A),
        A / cfg.dt)
    visc = torch.where(lmask, visc, 0.0)
    for _ in range(2):
        aux = elem_to_node_mean(visc, mesh)
        visc = torch.where(lmask, aux[..., en].mean(-1), 0.0)
    return visc


def visc_filt_harmon_leith(state, mesh, cfg, u_rhs, v_rhs, visc):
    """Harmonic filter with the Leith coefficient (ref visc_filt_harmon
    oce_dyn.F90:236-273), visc_option=1."""
    shared, et1, et2s = _edge_internal_shared(mesh)
    length = torch.sqrt(mesh.elem_area[et1] + mesh.elem_area[et2s])
    vi = 0.5 * (visc[:, et1] + visc[:, et2s])
    vi = torch.maximum(vi, cfg.dyn.gamma0 * length[None]) * cfg.dt
    return _apply_edge_filter(_uv_edge_diff(state, shared, et1, et2s) * vi,
                              mesh, u_rhs, v_rhs)


def visc_filt_biharm(state, mesh, cfg, u_rhs, v_rhs, option, visc=None):
    """Biharmonic filter (ref visc_filt_biharm oce_dyn.F90:275-374):
    ``option`` 1, the flow-aware coefficient (visc_option=4), or 2, the
    Leith coefficient ``visc`` (visc_option=3)."""
    d = cfg.dyn
    shared, et1, et2s = _edge_internal_shared(mesh)
    UV_c = _accum_edge_to_elem(_uv_edge_diff(state, shared, et1, et2s), mesh)
    length = torch.sqrt(mesh.elem_area)[None]
    if option == 1:
        speed = torch.sqrt(state.u ** 2 + state.v ** 2)
        vi = torch.clamp_min(d.gamma1 * speed, d.gamma0) * length * cfg.dt
    else:
        vi = torch.maximum(visc, d.gamma0 * length) * cfg.dt
    UV_c = torch.where(mesh.elem_layer_mask, -UV_c * vi, 0.0)
    return _biharmonic_second_stage(UV_c, shared, et1, et2s, mesh, u_rhs,
                                    v_rhs)


def visc_filt_hbhmix(state, mesh, cfg, u_rhs, v_rhs, visc):
    """Harmonic Leith plus a biharmonic background (ref visc_filt_hbhmix
    oce_dyn.F90:376-458), visc_option=2."""
    shared, et1, et2s = _edge_internal_shared(mesh)
    duv = _uv_edge_diff(state, shared, et1, et2s)
    vi_h = cfg.dt * 0.5 * (visc[:, et1] + visc[:, et2s])
    u_rhs, v_rhs = _apply_edge_filter(duv * vi_h, mesh, u_rhs, v_rhs)
    UV_c = _accum_edge_to_elem(duv, mesh)
    vi_b = cfg.dt * cfg.dyn.gamma0 * torch.sqrt(mesh.elem_area)[None]
    UV_c = torch.where(mesh.elem_layer_mask, -UV_c * vi_b, 0.0)
    return _biharmonic_second_stage(UV_c, shared, et1, et2s, mesh, u_rhs,
                                    v_rhs)


def visc_filt_bilapl(state, mesh, cfg, u_rhs, v_rhs):
    """Biharmonic, the viscosity from the velocity Laplacian (ref
    oce_dyn.F90:658-726), visc_option=6."""
    d = cfg.dyn
    shared, et1, et2s = _edge_internal_shared(mesh)
    UV_c = _accum_edge_to_elem(_uv_edge_diff(state, shared, et1, et2s), mesh)
    sp2 = UV_c[0] ** 2 + UV_c[1] ** 2
    vi = torch.clamp_min(torch.maximum(d.gamma1 * torch.sqrt(sp2),
                                       d.gamma2 * sp2), d.gamma0) \
        * torch.sqrt(mesh.elem_area)[None] * cfg.dt
    UV_c = torch.where(mesh.elem_layer_mask, -UV_c * vi, 0.0)
    return _biharmonic_second_stage(UV_c, shared, et1, et2s, mesh, u_rhs,
                                    v_rhs)


def visc_filt_bidiff(state, mesh, cfg, u_rhs, v_rhs):
    """Biharmonic, the viscosity from velocity differences, applied in
    both stages (ref oce_dyn.F90:734-801), visc_option=7."""
    d = cfg.dyn
    shared, et1, et2s = _edge_internal_shared(mesh)
    length = torch.sqrt(mesh.elem_area[et1] + mesh.elem_area[et2s])[None]
    duv = _uv_edge_diff(state, shared, et1, et2s)
    sp2 = duv[0] ** 2 + duv[1] ** 2
    vi1 = torch.sqrt(torch.clamp_min(torch.maximum(
        d.gamma1 * torch.sqrt(sp2), d.gamma2 * sp2), d.gamma0) * length)
    UV_c = torch.where(mesh.elem_layer_mask,
                       _accum_edge_to_elem(duv * vi1, mesh), 0.0)
    duv2 = torch.where(shared, _edge_diff(UV_c, et1, et2s), 0.0)
    return _apply_edge_filter(duv2 * (-cfg.dt * vi1), mesh, u_rhs, v_rhs)


def _smooth_elem(arr, mesh: MeshTables, n: int):
    """n rounds of element -> node -> element smoothing, per level, without
    level masks (ref smooth_elem2D gen_support.F90:183-212)."""
    for _ in range(n):
        aux = elem_to_node_mean(arr, mesh, respect_levels=False)
        arr = aux[..., mesh.elem_nodes].mean(-1)
    return arr


def backscatter_coef(uke, mesh: MeshTables, cfg):
    """The negative backscatter viscosity [nl-1, E] of the UKE reservoir
    (ref backscatter_coef oce_dyn.F90:958-986)."""
    vb = -cfg.dyn.c_back * torch.sqrt(mesh.elem_area)[None] \
        * torch.sqrt(torch.clamp_min(2.0 * uke, 0.0))
    vb = torch.minimum(vb, 0.2 * mesh.elem_area[None] / cfg.dt)
    return torch.where(mesh.elem_layer_mask, vb, 0.0)


def uke_update(state, mesh: MeshTables, cfg, UV_dis, UV_back, uke_dif):
    """The unresolved kinetic energy's budget, AB2 in time (ref uke_update
    oce_dyn.F90:988-1153), with ``fesom2_tpu``'s two deliberate departures:
    the true area-weighted V node mean (the reference's :1062 assigns U's)
    and no Southern-Pacific distance taper (:1106-1123)."""
    d = cfg.dyn
    lmask = mesh.elem_layer_mask
    en = mesh.elem_nodes
    uke_dis = torch.where(lmask, state.u * UV_dis[0] + state.v * UV_dis[1],
                          0.0)
    uke_back = torch.where(lmask, state.u * UV_back[0]
                           + state.v * UV_back[1], 0.0)
    uke_back = _smooth_elem(uke_back, mesh, d.smooth_back)

    # local Rossby number of the node-averaged velocity (ref :1045-1080)
    UVw = elem_to_node_mean(torch.stack([state.u, state.v]), mesh,
                            respect_levels=False)
    ux, uy = scalar_gradient(UVw[0], mesh)
    vx, vy = scalar_gradient(UVw[1], mesh)
    rosb = torch.sqrt((ux - vy) ** 2 + (uy + vx) ** 2)

    c_min, f_min, r_max = 0.5, 1.0e-6, 200000.0        # ref :1014
    if d.uke_scaling:
        # resolution against the first baroclinic Rossby radius (:1083-1100)
        reso = torch.sqrt(mesh.elem_area * 4.0 / math.sqrt(3.0))
        bv = torch.sqrt(torch.clamp_min(state.bvfreq, 0.0))
        integ = state.hnode_new * 0.5 * (bv[:-1] + bv[1:])
        c1 = torch.where(mesh.node_layer_mask, integ, 0.0).sum(0)
        c1 = torch.clamp_min(c1 / math.pi, c_min)
        rr = torch.clamp_max(c1 / torch.clamp_min(mesh.coriolis_node.abs(),
                                                  f_min), r_max)
        scaling = 1.0 / (1.0 + d.uke_scaling_factor * reso
                         / rr[en].mean(-1))
    else:
        scaling = torch.ones_like(mesh.elem_area)
    fsum = mesh.coriolis_node[en].sum(-1).abs()
    rosb = rosb / torch.clamp_min(fsum, f_min)[None]
    uke_dis = uke_dis * scaling[None] / (1.0 + rosb / d.rosb_dis)
    uke_dis = _smooth_elem(uke_dis, mesh, d.smooth_dis)

    # AB2 (ref :1142-1148); uke_rhs carries this step's rhs to the next
    uke_rhs = torch.where(lmask, -uke_dis - uke_back + uke_dif, 0.0)
    uke = state.uke + 1.5 * uke_rhs - 0.5 * state.uke_rhs
    return replace(state, uke=torch.where(lmask, uke, 0.0), uke_rhs=uke_rhs)


def visc_filt_dbcksc(state: OceanState, mesh: MeshTables, cfg, u_rhs, v_rhs):
    """Dynamic backscatter, visc_option=8: biharmonic dissipation plus a
    negative harmonic viscosity set by the UKE reservoir (ref
    visc_filt_dbcksc oce_dyn.F90:806-954).  Returns (state with the UKE
    updated, u_rhs, v_rhs)."""
    d = cfg.dyn
    dt = cfg.dt
    shared, et1, et2s = _edge_internal_shared(mesh)
    lmask = mesh.elem_layer_mask
    area = mesh.elem_area
    inv_area = (1.0 / torch.clamp_min(area, 1e-30))[None]
    v_back = backscatter_coef(state.uke, mesh, cfg)
    duv = _uv_edge_diff(state, shared, et1, et2s)

    # the first biharmonic stage, a 3rd-order-upwind-like coefficient
    # (ref :857-869)
    vi = torch.clamp_min(torch.sqrt(state.u ** 2 + state.v ** 2), 0.2) \
        * (dt * torch.sqrt(area) / 30.0)[None]
    UV_c = torch.where(lmask, -_accum_edge_to_elem(duv, mesh) * vi, 0.0)

    # edge length over the distance of the circumcentres (ref :877-884)
    lex = mesh.edge_dxdy[:, 0] * (mesh.elem_cos[et1] + mesh.elem_cos[et2s]) \
        * 0.25
    length = torch.sqrt(lex ** 2 + mesh.edge_dxdy[:, 1] ** 2) * r_earth
    ecd = mesh.edge_cross_dxdy
    cx = ecd[:, 0] - ecd[:, 2]
    cy = ecd[:, 1] - ecd[:, 3]
    lc = length / torch.clamp_min(torch.sqrt(cx ** 2 + cy ** 2), 1e-30)

    # the backscatter tendency: harmonic with v_back < 0 (ref :886-905)
    vi_b = dt * lc[None] * (v_back[:, et1] + v_back[:, et2s])
    UV_back = _accum_edge_to_elem(torch.where(shared, duv * vi_b, 0.0),
                                  mesh) * inv_area
    # UKE diffusion (ref :893-907)
    sq = torch.sqrt(area / d.scale_area)
    vi_d = dt * lc * d.K_back * (sq[et1] + sq[et2s])
    duke = torch.where(shared, _edge_diff(state.uke, et1, et2s) * vi_d[None],
                       0.0)
    uke_dif = _accum_edge_to_elem(duke, mesh) * inv_area
    # the second biharmonic stage (ref :909-917)
    duv2 = torch.where(shared, _edge_diff(UV_c, et1, et2s), 0.0)
    UV_dis = _accum_edge_to_elem(duv2, mesh) * inv_area

    UV_back = _smooth_elem(UV_back, mesh, d.smooth_back_tend)
    u_rhs = u_rhs + torch.where(lmask, UV_dis[0] + UV_back[0], 0.0)
    v_rhs = v_rhs + torch.where(lmask, UV_dis[1] + UV_back[1], 0.0)
    state = uke_update(state, mesh, cfg, UV_dis, UV_back, uke_dif)
    return state, u_rhs, v_rhs


def viscosity_filter(state: OceanState, mesh: MeshTables, cfg, u_rhs, v_rhs):
    """Dispatch on visc_option (ref viscosity_filter oce_dyn.F90:171-234):
    1 harmonic Leith; 2 harmonic Leith + biharmonic background; 3
    biharmonic Leith; 4 biharmonic flow-aware; 5 easy backscatter; 6
    biharmonic from the Laplacian; 7 biharmonic from differences; 8
    dynamic backscatter with the UKE budget; any other value the plain
    harmonic filter.  Returns (state, u_rhs, v_rhs); only option 8 changes
    the state."""
    opt = cfg.dyn.visc_option
    if opt in (1, 2, 3):
        visc = h_viscosity_leith(state, mesh, cfg)
        if opt == 1:
            out = visc_filt_harmon_leith(state, mesh, cfg, u_rhs, v_rhs, visc)
        elif opt == 2:
            out = visc_filt_hbhmix(state, mesh, cfg, u_rhs, v_rhs, visc)
        else:
            out = visc_filt_biharm(state, mesh, cfg, u_rhs, v_rhs, 2, visc)
    elif opt == 4:
        out = visc_filt_biharm(state, mesh, cfg, u_rhs, v_rhs, 1)
    elif opt == 5:
        out = visc_filt_bcksct(state, mesh, cfg, u_rhs, v_rhs)
    elif opt == 6:
        out = visc_filt_bilapl(state, mesh, cfg, u_rhs, v_rhs)
    elif opt == 7:
        out = visc_filt_bidiff(state, mesh, cfg, u_rhs, v_rhs)
    elif opt == 8:
        return visc_filt_dbcksc(state, mesh, cfg, u_rhs, v_rhs)
    else:
        out = visc_filt_harmon(state, mesh, cfg, u_rhs, v_rhs)
    return (state,) + tuple(out)


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
    ubot = take_row(state.u, nlev - 2)
    vbot = take_row(state.v, nlev - 2)
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
