# Frozen copy of fesom2_tpu_torch/core/mixing/cvmix.py, lines 1-644 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""CVMix-style vertical mixing: PP shear (cvmix_PP), the prognostic TKE
closure (cvmix_TKE), internal-wave energy (cvmix_IDEMIX), Simmons tidal
mixing (cvmix_TIDAL), double diffusion (cvmix_DDIFF), convection
(cvmix_CONV) and CVMix KPP (cvmix_KPP).

The port of ``fesom2_tpu/core/mixing/cvmix.py``: the reference's column
loops (``gen_modules_cvmix_*.F90`` around ``cvmix_*.F90``) are masked
``[nl, N]`` tensor ops.  The TKE and IDEMIX tridiagonals go through
``ops.tridiag_solve`` (a hand-written kernel on the card, one ``[nl, N]``
system each); TKE's mixing-length min-chains are two loops over the level
axis that keep the JAX scans' order of ``min`` and ``+``.
"""
from __future__ import annotations

import math
from dataclasses import replace

import torch

from ...constants import density_0, g, rad, vcpw
from ...mesh import MeshTables
from .. import eos
from ..ops import (edge_divergence, elem_to_node_mean_flat, scalar_gradient,
                   take_row, tridiag_solve)
from ..state import OceanState
from .kpp import _wscale, guard_eps


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------
def kv0_background_qiang(lat_deg, dep):
    """Latitude and depth dependent background diffusivity (ref
    Kv0_background_qiang oce_ale_mixing_pp.F90:91-125); lat in degrees,
    dep positive metres, broadcast [nl, N] x [N]."""
    aux = (0.6 + 1.0598 / 3.1415926
           * torch.atan(4.5e-3 * (dep - 2500.0))) * 1.0e-5
    alat = torch.abs(lat_deg)
    ratio = torch.where(alat < 5.0, 1.0,
                        torch.clamp_max(1.0 + 9.0 * (alat - 5.0) / 10.0, 10.0))
    arctic = torch.where(dep <= 50.0, 4.0 + 6.0 * (50.0 - dep) / 50.0, 4.0)
    return aux * torch.where(lat_deg > 70.0, arctic, ratio)


def _shear2(state: OceanState):
    """Squared vertical shear of the node velocity on the interior
    interfaces, zero on the surface and bottom rows [nl, N]."""
    Z3 = state.Z_3d
    dz = Z3[:-1] - Z3[1:]
    dz_inv = 1.0 / torch.where(dz == 0, 1.0, dz)
    du = (state.unode[:-1] - state.unode[1:]) * dz_inv
    dv = (state.vnode[:-1] - state.vnode[1:]) * dz_inv
    zrow = torch.zeros_like(Z3[:1])
    return torch.cat([zrow, du * du + dv * dv, zrow], 0)


def _interface_masks(mesh: MeshTables):
    """(lev [nl, 1], nb [1, N] the bottom interface, interior: interfaces
    1..nb-1, active: 0..nb).  Every column starts at interface 1, as in
    the JAX package, whatever its ``ulevels``."""
    lev = torch.arange(mesh.nl, device=mesh.nlevels_node.device)[:, None]
    nb = (mesh.nlevels_node - 1)[None, :]
    return lev, nb, (lev >= 1) & (lev <= nb - 1), lev <= nb


def _av_to_elems(Av_node, mesh: MeshTables):
    """Node interface viscosity -> the elements' interior interfaces, the
    plain mean of the three vertices (ref gen_modules_cvmix_pp.F90:258-264)."""
    ae = Av_node[:, mesh.elem_nodes].mean(-1)
    lev = torch.arange(mesh.nl, device=ae.device)[:, None]
    return torch.where((lev >= 1) & (lev <= (mesh.nlevels_elem - 2)[None, :]),
                       ae, 0.0)


def _elem_mean_surface(Av_node, mesh: MeshTables):
    """Node interface viscosity -> elements on interfaces 0..nlevels-2."""
    ae = Av_node[:, mesh.elem_nodes].mean(-1)
    lev = torch.arange(mesh.nl, device=ae.device)[:, None]
    return torch.where(lev <= (mesh.nlevels_elem - 2)[None, :], ae, 0.0)


def _dzt_interfaces(state: OceanState, mesh: MeshTables, nb, active):
    """Tracer-point spacing at the interfaces [nl, N], half cells at the
    surface and at the bottom interface nb (1 where inactive), and the
    bottom layer's thickness [N]."""
    lmask = mesh.node_layer_mask
    Z3 = state.Z_3d
    h_bot = take_row(torch.where(lmask, state.hnode, 0.0),
                     torch.clamp_min(nb[0] - 1, 0).long())
    lev = torch.arange(mesh.nl, device=Z3.device)[:, None]
    dzt = torch.cat([(state.hnode[0] / 2.0)[None, :],
                     torch.abs(Z3[:-1] - Z3[1:]),
                     torch.ones_like(Z3[:1])], 0)
    dzt = torch.where(lev == nb, h_bot[None, :] / 2.0, dzt)
    return torch.where(active & (dzt > 0), dzt, 1.0), h_bot


# --------------------------------------------------------------------------
# cvmix_PP (Pacanowski & Philander 1981 through CVMix shear)
# --------------------------------------------------------------------------
def calc_cvmix_pp(state: OceanState, mesh: MeshTables, cfg) -> OceanState:
    """ref calc_cvmix_pp gen_modules_cvmix_pp.F90:164-265 with
    cvmix_coeffs_shear's PP branch (cvmix_shear.F90:381-403)."""
    cv = cfg.cvmix
    _, _, interior, _ = _interface_masks(mesh)
    Ri = torch.where(interior, torch.clamp_min(state.bvfreq, 0.0)
                     / torch.clamp_min(_shear2(state), 1e-30), 0.0)
    denom = torch.where(Ri > 0.0, 1.0 + cv.pp_alpha * Ri, 1.0)
    nu_b = cv.pp_Avbckg if (not cv.pp_use_fesompp or cv.pp_use_AvbinKv) \
        else 0.0
    kap_b = 0.0 if (cv.pp_use_fesompp and cv.pp_use_nonconstKvb) \
        else cv.pp_Kvbckg
    Av = cv.pp_Av0 / denom ** cv.pp_exp + nu_b
    Kv = Av / denom + kap_b
    if cv.pp_use_fesompp and not cv.pp_use_AvbinKv:
        Av = Av + cv.pp_Avbckg          # added by hand, left out of Kv
    if cv.pp_use_fesompp and cv.pp_use_nonconstKvb:
        lat_deg = mesh.geo_coords[:, 1] / rad
        Kv = Kv + kv0_background_qiang(lat_deg[None, :],
                                       torch.abs(state.zbar_3d))
    Av = torch.where(interior, Av, 0.0)
    Kv = torch.where(interior, Kv, 0.0)
    return replace(state, Kv=Kv, Av=_av_to_elems(Av, mesh))


# --------------------------------------------------------------------------
# cvmix_TKE (prognostic turbulent kinetic energy)
# --------------------------------------------------------------------------
def _mixing_length(mxl, dzw0, nb, h_bot, mxl_min):
    """The mixing length of tke_mxl_choice=2 (ref cvmix_tke.F90:560-600):
    each interface's length at most the one above plus the layer between
    them (top down), clamped at nb-1, then at most the one below plus the
    layer between (bottom up, interfaces 1..nb-2), then at least
    ``mxl_min``.  The loops keep the order of the JAX scans."""
    nl = mxl.shape[0]
    rows = [mxl[0]]
    carry = mxl[0]
    for k in range(nl - 1):
        carry = torch.minimum(mxl[k + 1], carry + dzw0[k])
        rows.append(carry)
    lev = torch.arange(nl, device=mxl.device)[:, None]
    mxl = torch.stack(rows)
    mxl = torch.where(lev == nb - 1,
                      torch.minimum(mxl, mxl_min + h_bot[None, :]), mxl)
    out = [None] * nl
    out[nl - 1] = carry = mxl[nl - 1]
    for k in range(nl - 2, -1, -1):
        apply = (k >= 1) & (k <= nb[0] - 2)
        carry = torch.where(apply, torch.minimum(mxl[k], carry + dzw0[k]),
                            mxl[k])
        out[k] = carry
    return torch.clamp_min(torch.stack(out), mxl_min)


def calc_cvmix_tke(state: OceanState, mesh: MeshTables, cfg, forcing,
                   iw_diss=None, iwe=None, iwe_alpha_c=None) -> OceanState:
    """One implicit TKE step per node column (ref integrate_tke
    cvmix_tke.F90:387-918 through gen_modules_cvmix_tke.F90:245-391).

    With ``iw_diss``, ``iwe`` and ``iwe_alpha_c`` (the IDEMIX coupling,
    mix_scheme_nmb=56) the internal-wave dissipation feeds TKE, the
    Richardson number is capped by the wave-energy criterion, and TKE is
    not bounded below by ``tke_min`` (ref cvmix_tke.F90:762-765)."""
    cv = cfg.cvmix
    dt = cfg.dt
    lev, nb, interior, active = _interface_masks(mesh)
    lmask = mesh.node_layer_mask
    dzw = torch.where(lmask, state.hnode, 1.0)
    dzt, h_bot = _dzt_interfaces(state, mesh, nb, active)

    # the wrapper builds the shear only on the interior interfaces
    # (gen_modules_cvmix_tke.F90:288-293)
    Ssqr = torch.where(interior, _shear2(state), 0.0)
    Nsqr = torch.where(interior, state.bvfreq, 0.0)

    sqrttke = torch.sqrt(torch.clamp_min(state.tke, 0.0))
    mxl = math.sqrt(2.0) * sqrttke / torch.sqrt(torch.clamp_min(Nsqr, 1e-12))
    mxl = torch.where((lev == 0) | (lev >= nb), 0.0, mxl)
    mxl = _mixing_length(mxl, torch.where(lmask, state.hnode, 0.0), nb,
                         h_bot, cv.tke_mxl_min)

    # diffusivities
    KappaM = torch.clamp_max(cv.tke_c_k * mxl * sqrttke, cv.tke_kappaM_max)
    Rinum = Nsqr / torch.clamp_min(Ssqr, 1e-12)
    if iwe is not None:
        Rinum = torch.minimum(Rinum, KappaM * Nsqr / torch.clamp_min(
            iwe_alpha_c * iwe ** 2, 1e-12))
    KappaH = KappaM / torch.clamp(6.6 * Rinum, 1.0, 10.0)

    # forcing: shear and buoyancy production, the surface stress
    forc = Ssqr * KappaM - Nsqr * KappaH
    if iw_diss is not None:
        forc = forc + iw_diss
    sxy = elem_to_node_mean_flat(torch.stack([forcing.stress_x,
                                              forcing.stress_y]), mesh)
    forc_surf = torch.sqrt(sxy[0] ** 2 + sxy[1] ** 2) / density_0
    forc = torch.cat([(forc[0] + cv.tke_cd * forc_surf ** 1.5 / dzt[0])[None],
                      forc[1:]], 0)

    # ke on the layers: alpha 0.5 (K[min(k+1, nb-1)] + K[max(k, 1)])
    llev = lev[:-1]
    Kp1 = torch.where(llev == nb - 1,
                      take_row(KappaM, (nb[0] - 1).long())[None, :],
                      KappaM[1:])
    Kk = torch.where(llev == 0, KappaM[1:2], KappaM[:-1])
    ke = torch.where(lmask, cv.tke_alpha * 0.5 * (Kp1 + Kk), 0.0)

    # the tridiagonal, Neumann at both ends
    zrow = torch.zeros_like(ke[:1])
    c_dif = torch.cat([ke * (1.0 / (dzt[:-1] * dzw)), zrow], 0)
    c_dif = torch.where(lev >= nb, 0.0, c_dif)
    a_dif = torch.cat([zrow, ke * (1.0 / (dzt[1:] * dzw))], 0)
    a_dif = torch.where((lev >= 1) & (lev <= nb), a_dif, 0.0)
    b_dif = torch.where(interior, a_dif + c_dif, 0.0)
    b_dif = torch.where(lev == 0, c_dif, b_dif)
    b_dif = torch.where(lev == nb, a_dif, b_dif)

    diss = torch.where(interior, cv.tke_c_eps * sqrttke / mxl, 0.0)
    a_tri = torch.where(active, -dt * a_dif, 0.0)
    b_tri = torch.where(active, 1.0 + dt * (b_dif + diss), 1.0)
    c_tri = torch.where(active, -dt * c_dif, 0.0)
    d_tri = torch.where(active, state.tke + dt * forc, 0.0)
    tke_new = tridiag_solve(a_tri, b_tri, c_tri, d_tri)
    if iw_diss is None:
        tke_new = torch.clamp_min(tke_new, cv.tke_min)
    tke_new = torch.where(active, tke_new, 0.0)

    Kv = torch.where(interior, KappaH, 0.0)
    Av_n = torch.where(interior, KappaM, 0.0)
    return replace(state, tke=tke_new, Kv=Kv, Av=_av_to_elems(Av_n, mesh))


# --------------------------------------------------------------------------
# cvmix_IDEMIX (Olbers & Eden 2013 internal-wave energy)
# --------------------------------------------------------------------------
def _gofx2(x):
    """ref gofx2 cvmix_idemix.F90:672-682."""
    x2 = torch.clamp_min(x, 3.0)
    c = 1.0 - (2.0 / math.pi) * torch.asin(1.0 / x2)
    return 2.0 / math.pi / c * 0.9 * x2 ** (-2.0 / 3.0) \
        * (1.0 - torch.exp(-x2 / 4.3))


def _hofx2(x):
    """ref hofx2 cvmix_idemix.F90:684-693."""
    x2 = torch.clamp_min(x, 10.0)
    return (2.0 / math.pi) / (1.0 - (2.0 / math.pi) * torch.asin(1.0 / x2)) \
        * (x2 - 1.0) / (x2 + 1.0)


def _iwe_propagation(iwe, v0, dzt, active, state: OceanState,
                     mesh: MeshTables, cv, dt):
    """The horizontal propagation of the wave energy: one edge pass on the
    pre-pass energy (ref cvmix_idemix.F90:363-662; the reference's
    in-place, partition-dependent order is not reproduced)."""
    nl = mesh.nl
    lev = torch.arange(nl, device=iwe.device)[:, None]
    fac = cv.idemix_tau_h * dt / cv.idemix_n_hor_iwe_prop_iter
    # interface k budgets with the area of the layer above (surface: own)
    area_up = torch.cat([mesh.area[:1], mesh.area[:-1]], 0)
    asv_up = torch.cat([mesh.areasvol[:1], mesh.areasvol[:-1]], 0)
    vol_i = 1.0 / torch.where(active, asv_up * dzt, 1.0)
    v0c = torch.minimum(v0, torch.sqrt(0.2 * (area_up / math.pi * 4.0) / fac))

    gx, gy = scalar_gradient(v0c * iwe, mesh)                 # [nl, E]
    he = torch.where(mesh.elem_layer_mask, state.helem, 0.0)
    zrow = torch.zeros_like(he[:1])
    dzel = torch.cat([0.5 * he, zrow], 0) + torch.cat([zrow, 0.5 * he], 0)
    et1, et2 = mesh.edge_tri[:, 0], mesh.edge_tri[:, 1]
    has2 = et2 >= 0
    et2s = torch.where(has2, et2, 0)
    dX1, dY1 = mesh.edge_cross_dxdy[:, 0], mesh.edge_cross_dxdy[:, 1]
    dX2, dY2 = mesh.edge_cross_dxdy[:, 2], mesh.edge_cross_dxdy[:, 3]
    em = lev <= (mesh.nlevels_elem - 1)[None, :]
    m1 = em[:, et1]
    m2 = em[:, et2s] & has2[None, :]
    t1 = (gx[:, et1] * dY1[None] - gy[:, et1] * dX1[None]) * dzel[:, et1]
    t2 = -(gx[:, et2s] * dY2[None] - gy[:, et2s] * dX2[None]) * dzel[:, et2s]
    gxm = 0.5 * (gx[:, et1] + gx[:, et2s])
    gym = 0.5 * (gy[:, et1] + gy[:, et2s])
    dzm = 0.5 * (dzel[:, et1] + dzel[:, et2s])
    tb = ((dX2 - dX1)[None] * gym - (dY2 - dY1)[None] * gxm) * dzm
    vflux = torch.where(m1 & m2, tb, torch.where(m1, t1, torch.where(
        m2, t2, 0.0)))
    n0, n1 = mesh.edges[:, 0], mesh.edges[:, 1]
    vflux = vflux * 0.5 * (v0c[:, n0] + v0c[:, n1])
    iwe = iwe + fac * vol_i * edge_divergence(vflux, mesh)
    return torch.where(active, iwe, 0.0)


def calc_cvmix_idemix(state: OceanState, mesh: MeshTables, cfg, forcing,
                      iw_surf=None, iw_bot=None,
                      standalone: bool = False) -> OceanState:
    """The internal-wave energy step (ref integrate_idemix
    cvmix_idemix.F90 through gen_modules_cvmix_idemix.F90:168-336).

    ``iw_surf`` and ``iw_bot`` [N] are the near-inertial surface and tidal
    bottom energy fluxes over density_0, which the reference reads from
    files at setup; zeros when not given (the JAX package never sets
    them).  ``standalone`` (IDEMIX without a main scheme,
    mix_scheme_nmb=6) turns the dissipation into Kv and Av (ref :324-338)."""
    cv = cfg.cvmix
    dt = cfg.dt
    lev, nb, interior, active = _interface_masks(mesh)
    lmask = mesh.node_layer_mask
    N = mesh.n_nodes
    if iw_surf is None:
        iw_surf = torch.zeros(N, dtype=state.Kv.dtype, device=lev.device)
    if iw_bot is None:
        iw_bot = torch.zeros(N, dtype=state.Kv.dtype, device=lev.device)

    dzw = torch.where(lmask, state.hnode, 0.0)
    dzt, _ = _dzt_interfaces(state, mesh, nb, active)
    Nsqr = torch.where(interior, state.bvfreq, 0.0)
    sqrtN = torch.sqrt(torch.clamp_min(Nsqr, 0.0))

    # the column's integrated buoyancy frequency -> cstar (ref :105-110)
    bN0 = (sqrtN[1:] * dzw).sum(0)
    cstar = torch.clamp_min(bN0 / (math.pi * cv.idemix_jstar), 1e-2)[None, :]
    f = torch.abs(mesh.coriolis_node)[None, :]
    fxa = sqrtN / (1e-22 + f)
    c0 = torch.clamp_min(cv.idemix_gamma * cstar * _gofx2(fxa), 0.0)
    v0 = torch.clamp_min(cv.idemix_gamma * cstar * _hofx2(fxa), 0.0)
    v0 = torch.where(fxa < 1.0, 0.0, v0)
    alpha_c = torch.clamp_min(cv.idemix_mu0 * torch.acosh(
        torch.clamp_min(fxa, 1.0)) * f / cstar ** 2, 1e-4)
    iwe_max = torch.clamp_min(state.iwe, 0.0)

    # vertical diffusion of E with the coefficient tau_v c0^2 (ref :121-141)
    safe_dzw = torch.where(lmask, state.hnode, 1.0)
    delta = cv.idemix_tau_v / safe_dzw * 0.5 * (c0[:-1] + c0[1:])
    delta = torch.where(lmask, delta, 0.0)
    inv_dzt = 1.0 / dzt
    zrow = torch.zeros_like(delta[:1])
    a_dif = torch.cat([zrow, delta * c0[:-1] * inv_dzt[1:]], 0)
    a_dif = torch.where((lev >= 1) & (lev <= nb), a_dif, 0.0)
    c_dif = torch.cat([delta * c0[1:] * inv_dzt[:-1], zrow], 0)
    c_dif = torch.where(lev >= nb, 0.0, c_dif)
    dl = torch.where(lmask, delta, 0.0)
    dsum = torch.cat([zrow, dl], 0) + torch.cat([dl, zrow], 0)
    b_dif = torch.where(interior, dsum * c0 * inv_dzt, 0.0)
    b_dif = torch.where(lev == 0, (delta[0] * c0[0] * inv_dzt[0])[None, :],
                        b_dif)
    bot_delta = take_row(delta, torch.clamp_min(nb[0] - 1, 0).long())
    b_dif = torch.where(lev == nb, bot_delta[None, :] * c0 * inv_dzt, b_dif)

    a_tri = torch.where(active, -dt * a_dif, 0.0)
    b_tri = torch.where(active, 1.0 + dt * b_dif + torch.where(
        interior, dt * alpha_c * iwe_max, 0.0), 1.0)
    c_tri = torch.where(active, -dt * c_dif, 0.0)
    d_tri = torch.where(active, state.iwe, 0.0)
    d_tri = torch.cat([(d_tri[0] + dt * iw_surf / dzt[0])[None, :],
                       d_tri[1:]], 0)
    d_tri = d_tri + torch.where(lev == nb, (dt * iw_bot)[None, :] / dzt, 0.0)
    iwe_new = torch.where(active, tridiag_solve(a_tri, b_tri, c_tri, d_tri),
                          0.0)

    # the dissipation, a source of TKE (ref :158-161)
    iwe_diss = torch.where(interior, alpha_c * iwe_max * iwe_new, 0.0)
    if cv.idemix_n_hor_iwe_prop_iter > 0:
        iwe_new = _iwe_propagation(iwe_new, v0, dzt, active, state, mesh, cv,
                                   dt)

    state = replace(state, iwe=iwe_new, iwe_diss=iwe_diss,
                    iwe_alpha_c=alpha_c)
    if standalone:
        Kv = torch.clamp(0.2 / 1.2 * iwe_diss / torch.clamp_min(Nsqr, 1e-12),
                         1e-9, 1.0)
        Kv = torch.where(interior, Kv, 0.0)
        state = replace(state, Kv=Kv,
                        Av=_elem_mean_surface(10.0 * Kv, mesh))
    return state


# --------------------------------------------------------------------------
# cvmix_TIDAL (Simmons et al. 2004)
# --------------------------------------------------------------------------
def calc_cvmix_tidal(state: OceanState, mesh: MeshTables, cfg,
                     tidal_forc=None) -> OceanState:
    """Adds Simmons tidal mixing to Kv and Av (ref calc_cvmix_tidal
    gen_modules_cvmix_tidal.F90:88-130 and cvmix_tidal.F90's Simmons
    invariant, coefficients and vertical deposition).  ``tidal_forc`` [N]
    is the bottom wave-dissipation energy flux in W/m^2 (read from a file
    at setup in the reference); zeros when not given."""
    cv = cfg.cvmix
    lev, nb, interior, active = _interface_masks(mesh)
    if tidal_forc is None:
        tidal_forc = torch.zeros(mesh.n_nodes, dtype=state.Kv.dtype,
                                 device=lev.device)
    simmons = cv.tidal_local_mixfrac * cv.tidal_efficiency \
        * tidal_forc / density_0

    # exp(-zw/zeta) on the interior interfaces, normalised by
    # sum(vert_dep (zt(k-1) - zt(k))) (ref cvmix_compute_vert_dep)
    vd = torch.where(interior, torch.exp(-state.zbar_3d
                                         / cv.tidal_vert_decayscale), 0.0)
    zrow = torch.zeros_like(state.zbar_3d[:1])
    thick = torch.cat([zrow, state.Z_3d[:-1] - state.Z_3d[1:], zrow], 0)
    tot = (vd * torch.where(interior, thick, 0.0)).sum(0)
    vd = vd / torch.where(tot > 0, tot, 1.0)[None, :]

    depth = -take_row(state.zbar_3d, nb[0].long())
    Nsqr = state.bvfreq
    Kv_t = torch.where(Nsqr > 0.0, simmons[None, :] * vd / Nsqr, 0.0)
    Kv_t = torch.clamp_max(Kv_t, cv.tidal_max_coefficient)
    Kv_t = torch.where((depth >= cv.tidal_depth_cutoff)[None, :], Kv_t, 0.0)
    Kv_t = torch.where(active, Kv_t, 0.0)
    Av_t = 1.0 * Kv_t                    # CVMix's default Prandtl number
    return replace(state, Kv=state.Kv + Kv_t,
                   Av=state.Av + _elem_mean_surface(Av_t, mesh))


# --------------------------------------------------------------------------
# cvmix_DDIFF (salt fingering and diffusive convection)
# --------------------------------------------------------------------------
def calc_cvmix_ddiff(state: OceanState, mesh: MeshTables, cfg) -> OceanState:
    """Double-diffusive mixing on its own (ref cvmix_ddiff.F90
    cvmix_coeffs_ddiff_low :355-445): at each interior interface the
    density ratio Rrho = (alpha dT/dz) / (beta dS/dz) selects salt
    fingering (St. Laurent & Schmitt 1999) or diffusive convection (the
    MC76 form).  Temperature mixes with Kv + Td; salinity with Kv_s = the
    main scheme's Kv + Sd, which the tracer solve takes for tracer id 1."""
    cv = cfg.cvmix
    _, _, interior, _ = _interface_masks(mesh)
    T, S = state.tr[0], state.tr[1]
    alpha, beta = eos.sw_alpha_beta(T, S, state.Z_3d)
    dz = state.Z_3d[:-1] - state.Z_3d[1:]
    dz = torch.where(torch.abs(dz) > 1e-12, dz, 1e-12)
    aT = 0.5 * (alpha[:-1] + alpha[1:])
    bS = 0.5 * (beta[:-1] + beta[1:])
    zrow = torch.zeros_like(T[:1])
    num = torch.cat([zrow, aT * (T[:-1] - T[1:]) / dz, zrow], 0)
    den = torch.cat([zrow, bS * (S[:-1] - S[1:]) / dz, zrow], 0)

    # a guard that keeps the sign of a tiny denominator
    safe_den = torch.where(torch.abs(den) > 1e-30, den,
                           torch.where(den < 0.0, -1e-30, 1e-30))
    Rrho = num / safe_den
    finger = (num >= den) & (den > 0.0) & (Rrho < cv.ddiff_strat_param_max)
    dd = (1.0 - ((Rrho - 1.0) / (cv.ddiff_strat_param_max - 1.0))
          ** cv.ddiff_exp1) ** cv.ddiff_exp2
    Sd_f = torch.where(finger, cv.ddiff_kappa_s * dd, 0.0)
    Td_f = 0.7 * Sd_f
    dconv = (num >= den) & (num < 0.0)
    Rs = torch.where(dconv, torch.clamp(Rrho, 1e-10, 1.0), 0.5)
    Td_c = cv.ddiff_mol_diff * cv.ddiff_param1 * torch.exp(
        cv.ddiff_param2 * torch.exp(cv.ddiff_param3 * (1.0 / torch.where(
            torch.abs(Rs) > 1e-30, Rs, 1e-30) - 1.0)))
    Sd_c = torch.where(Rs < 0.5, 0.15 * Rs, 1.85 * Rs - 0.85) * Td_c
    Td = torch.where(interior, Td_f + torch.where(dconv, Td_c, 0.0), 0.0)
    Sd = torch.where(interior, Sd_f + torch.where(dconv, Sd_c, 0.0), 0.0)
    return replace(state, Kv=state.Kv + Td, Kv_s=state.Kv + Sd)


# --------------------------------------------------------------------------
# cvmix_CONV (mixing where the column is statically unstable)
# --------------------------------------------------------------------------
def calc_cvmix_convection(state: OceanState, mesh: MeshTables,
                          cfg) -> OceanState:
    """Convective mixing on its own (ref cvmix_convection.F90
    cvmix_coeffs_conv_low, lBruntVaisala): where N^2 <= 0 a weight of 1
    (``conv_bvsqr >= 0``) or the ramp (1 - (1 - N^2/BVsqr)^2)^3 between
    N^2 = 0 and ``conv_bvsqr`` < 0; Kv += wgt conv_diff, Av += wgt
    conv_visc."""
    cv = cfg.cvmix
    _, _, interior, _ = _interface_masks(mesh)
    Nsqr = state.bvfreq
    if cv.conv_bvsqr < 0.0:
        w = 1.0 - Nsqr / cv.conv_bvsqr
        wgt = torch.where(Nsqr > cv.conv_bvsqr, (1.0 - w ** 2) ** 3, 1.0)
    else:
        wgt = torch.ones_like(Nsqr)
    wgt = torch.where((Nsqr <= 0.0) & interior, wgt, 0.0)
    return replace(state, Kv=state.Kv + wgt * cv.conv_diff,
                   Av=state.Av + _av_to_elems(wgt * cv.conv_visc, mesh))


# --------------------------------------------------------------------------
# cvmix_KPP (the CVMix flavour of KPP, mix_scheme_nmb 3)
# --------------------------------------------------------------------------
def calc_cvmix_kpp(state: OceanState, mesh: MeshTables, cfg, forcing,
                   sw_3d=None) -> OceanState:
    """CVMix KPP with FESOM's default options (ref calc_cvmix_kpp
    gen_modules_cvmix_kpp.F90:171-456 and cvmix_kpp.F90): the
    surface-layer averaged bulk Richardson number, the OBL depth linearly
    interpolated across Ri_crit with the Ekman and Monin-Obukhov limits,
    the sigma (1 - sigma)^2 profile, the enhanced diffusion at the OBL
    base, and KPP-shear interior mixing with the Qiang background.  The
    native KPP's ``kpp_column`` kernel is not on this path."""
    cv = cfg.cvmix
    nl, N = mesh.nl, mesh.n_nodes
    lev, nb, interior, active = _interface_masks(mesh)
    lmask = mesh.node_layer_mask
    dtype = state.Kv.dtype
    eps = guard_eps(dtype)

    Zt = torch.where(lmask, state.Z_3d, -1e6)
    zb = state.zbar_3d
    h = torch.where(lmask, state.hnode, 0.0)

    # the properties averaged over each centre's surface layer (ref
    # :214-247): delh[j, nz, n] is layer j's thickness inside the surface
    # layer of centre nz
    sle = cv.kpp_surf_layer_ext
    sld = sle * torch.clamp_min(torch.maximum(-Zt, (-zb[1])[None, :]),
                                cv.kpp_minOBLdepth)
    cumh = torch.cumsum(h, 0)
    cumh_prev = torch.cat([torch.zeros_like(h[:1]), cumh[:-1]], 0)
    delh = torch.clamp(sld[None, :, :] - cumh_prev[:, None, :], min=0.0)
    delh = torch.minimum(delh, h[:, None, :])
    htot = torch.clamp_min(delh.sum(0), 1e-12)

    def slavg(fld):
        return torch.einsum("jln,jn->ln", delh, fld) / htot
    sfc_t = slavg(state.tr[0])
    sfc_s = slavg(state.tr[1])
    sfc_u = slavg(state.unode)
    sfc_v = slavg(state.vnode)
    dvsurf2 = (state.unode - sfc_u) ** 2 + (state.vnode - sfc_v) ** 2

    # buoyancy of the surface layer's water brought to Z_nz against the
    # water there
    def rho_at(t, s, z):
        b0, bpz, bpz2, rpot = eos.eos_components(
            t, s, cfg.dyn.state_equation, cfg.run.toy_ocean)
        r = b0 + z * (bpz + z * bpz2)
        return r * rpot / (r + 0.1 * z * float(cfg.dyn.state_equation)) \
            - density_0
    dbsurf = -g / density_0 * (rho_at(sfc_t, sfc_s, Zt)
                               - rho_at(state.tr[0], state.tr[1], Zt))

    # interior shear mixing and the background (ref :262-296)
    shearRi = torch.where(interior, torch.clamp_min(state.bvfreq, 0.0)
                          / (_shear2(state) + eps), 0.0)
    aux = (1.0 - torch.clamp_max(shearRi / cv.kpp_Ri0, 1.0) ** 2) \
        ** cv.kpp_loc_exp
    Av_i = torch.where(interior, cv.kpp_Av0 * aux + cv.kpp_Avbckg, 0.0)
    Kv_i = torch.where(interior, cv.kpp_Kv0 * aux, 0.0)
    if cv.kpp_use_nonconstKvb:
        Kv_i = Kv_i + torch.where(interior, kv0_background_qiang(
            (mesh.geo_coords[:, 1] / rad)[None, :], torch.abs(zb)), 0.0)
    else:
        Kv_i = Kv_i + torch.where(interior, cv.kpp_Kvbckg, 0.0)

    # the surface forcing (ref :298-316)
    alpha, beta = eos.sw_alpha_beta(state.tr[0], state.tr[1], state.Z_3d)
    sbuoy = -g * (alpha[0] * forcing.heat_flux / vcpw
                  + beta[0] * forcing.water_flux * state.tr[1, 0])
    ustar = torch.sqrt(torch.sqrt(forcing.stress_atm_x ** 2
                                  + forcing.stress_atm_y ** 2) / density_0)
    if cv.kpp_reduce_tauuice:
        ustar = ustar * (1.0 - forcing.a_ice) ** 2
    sbuoy_obl = sbuoy
    sbuoy_c = sbuoy[None, :]
    if sw_3d is not None:
        sbuoy_obl = sbuoy + g * alpha[0] * (sw_3d[0] - sw_3d[1])
        sbuoy_c = sbuoy_c + g * alpha[0][None, :] * (sw_3d[0][None, :]
                                                     - sw_3d[1:])
    zehat_c = cv.kpp_vonKarman * sle * (-Zt) * sbuoy_c
    _, ws_c = _wscale(zehat_c, ustar[None, :])

    # the bulk Richardson number at the centres
    Ncntr = torch.sqrt(torch.clamp_min(state.bvfreq[1:], 0.0))
    Vtc = math.sqrt(0.2 / (cv.kpp_cs * sle)) / cv.kpp_vonKarman ** 2
    Cv = torch.where(Ncntr < 0.002, 2.1 - 200.0 * Ncntr, 1.7)
    Vt2 = torch.clamp_min(-Cv * Vtc * Zt * Ncntr * ws_c / cv.kpp_Rib_crit,
                          cv.kpp_minVtsqr)
    Rib = torch.where(lmask, -(1.0 - 0.5 * sle) * Zt * dbsurf
                      / torch.clamp_min(dvsurf2 + Vt2, eps), 0.0)

    # the OBL depth: Rib linearly interpolated across Ri_crit
    exceed = (Rib > cv.kpp_Rib_crit) & lmask
    has = exceed.any(0)
    kfirst = torch.argmax(exceed.to(torch.uint8), 0)
    kprev = torch.clamp_min(kfirst - 1, 0)
    r1, r0 = take_row(Rib, kfirst), take_row(Rib, kprev)
    z1, z0 = take_row(Zt, kfirst), take_row(Zt, kprev)
    frac = (cv.kpp_Rib_crit - r0) / torch.where(r1 != r0, r1 - r0, 1.0)
    obl_x = torch.where(kfirst == 0, -z1, -(z0 + frac * (z1 - z0)))
    zt_bot = -take_row(Zt, torch.clamp_min(nb[0] - 2, 0).long())
    obl_lim = zt_bot
    if cv.kpp_use_compEkman:
        f = torch.abs(mesh.coriolis_node)
        ek = torch.where((f == 0.0) | (sbuoy_obl <= 0.0), zt_bot,
                         0.7 * ustar / torch.clamp_min(f, 1e-20))
        obl_lim = torch.minimum(obl_lim, ek)
    if cv.kpp_use_monob:
        mo = torch.where(sbuoy_obl > 0.0, ustar ** 3 / torch.clamp_min(
            sbuoy_obl * cv.kpp_vonKarman, 1e-30), zt_bot)
        obl_lim = torch.minimum(obl_lim, mo)
    obl = torch.where(has, torch.minimum(obl_x, obl_lim), obl_lim)
    # the wrapper's clamps (ref :336-340)
    obl = torch.maximum(obl, torch.abs(zb[1]))
    obl = torch.minimum(obl, torch.abs(take_row(zb, nb[0].long())))

    # the boundary-layer profile (ParabolicNonLocal shapes)
    above_c = torch.where(lmask, -Zt < obl[None, :], False)
    ktup = torch.clamp_min(above_c.sum(0) - 1, 0)
    sigma_i = torch.clamp_max(-zb / obl[None, :], 1.0)
    # LMD94: the scales frozen at sigma = surf_layer_ext when unstable
    stable = sbuoy_obl > 0.0
    sig_eff = torch.where(stable[None, :], sigma_i,
                          torch.clamp_max(sigma_i, sle))
    wm_i, ws_i = _wscale(cv.kpp_vonKarman * sig_eff * obl[None, :]
                         * sbuoy_obl[None, :], ustar[None, :])
    Gs = sigma_i * (1.0 - sigma_i) ** 2
    blm = obl[None, :] * wm_i * Gs
    blt = obl[None, :] * ws_i * Gs
    inside_i = (lev >= 1) & (-zb < obl[None, :]) & (lev <= nb - 1)
    nonloc = torch.where(inside_i & (~stable)[None, :],
                         cv.kpp_cs2 * (1.0 - sigma_i) ** 2, 0.0)

    # enhanced diffusion at the transition interface ktup+1 (ref
    # compute_enhanced_diff, the lkteqkw branch)
    zt_k = take_row(Zt, ktup)
    zt_k1 = take_row(Zt, torch.clamp_max(ktup + 1, nl - 2))
    delta = torch.clamp((obl + zt_k) / torch.where(zt_k != zt_k1,
                                                   zt_k - zt_k1, 1.0),
                        0.0, 1.0)
    sig_k = torch.clamp_max(-zt_k / obl, 1.0)
    wm_k, ws_k = _wscale(cv.kpp_vonKarman * torch.where(
        stable, sig_k, torch.clamp_max(sig_k, sle)) * obl * sbuoy_obl, ustar)
    Gk = sig_k * (1.0 - sig_k) ** 2
    Mk, Tk = obl * wm_k * Gk, obl * ws_k * Gk
    at_trans = lev == (ktup + 1)[None, :]
    Av_tr = take_row(Av_i, ktup + 1)
    Kv_tr = take_row(Kv_i, ktup + 1)
    omd = 1.0 - delta
    enhM = omd ** 2 * Mk + delta ** 2 * Av_tr
    enhT = omd ** 2 * Tk + delta ** 2 * Kv_tr
    if cv.kpp_use_enhanceKv:
        blm = torch.where(at_trans, (omd * Av_tr + delta * enhM)[None, :],
                          blm)
        blt = torch.where(at_trans, (omd * Kv_tr + delta * enhT)[None, :],
                          blt)
        inside_i = inside_i | (at_trans & (lev <= nb - 1))

    keep = interior | (inside_i & active)
    Av_n = torch.where(keep, torch.where(inside_i, blm, Av_i), 0.0)
    Kv_n = torch.where(keep, torch.where(inside_i, blt, Kv_i), 0.0)
    nonloc = torch.where(active, nonloc, 0.0)
    # elementwise Av with the surface interface (ref :448-453)
    return replace(state, Kv=Kv_n, Av=_elem_mean_surface(Av_n, mesh),
                   kpp_nonloc=nonloc, mld1=obl)
