"""Tracer transport: MUSCL/QR4C advection, FCT limiter, diffusion.

The port of the soufflet subset of ``fesom2_tpu/core/tracers.py`` (ref
driver ``src/oce_adv_tra_driver.F90:41-269``; adv_tra_hor_muscl
``oce_adv_tra_hor.F90:215``; adv_tra_ver_{upw1:231,qr4c:286}
``oce_adv_tra_ver.F90``; oce_tra_adv_fct ``oce_adv_tra_fct.F90:58-349``;
fill_up_dn_grad ``oce_muscl_adv.F90:286-447``; diff_part_hor_redi,
diff_ver_part_impl_ale, bc_surface ``oce_ale_tracer.F90``).

Tracers are stacked on a leading axis, [T, nl-1, N].  Sign convention:
``flux_h[.., Ed]`` is positive INTO edge node 0.

``fct_bounds`` (the limiter's steps a1-a3) runs a hand-written CUDA
kernel on a CUDA tensor; ``fct_bounds_plain`` beside it serves CPU
tensors only.
"""
from __future__ import annotations

import torch

from fesom2_tpu.constants import r_earth, vcpw
from .. import kernels
from ..mesh import MeshTables
from .ops import (tridiag_solve, elem_to_node_mean, edge_divergence,
                  edge_signed_reduce2, take_row)
from .tracer_setup import TracerStatics


# --------------------------------------------------------------------------
# gradients
# --------------------------------------------------------------------------
def tracer_gradient_elements(t, mesh: MeshTables):
    """[..., nl-1, N] -> (gx, gy) [..., nl-1, E] (ref oce_tracer_mod.F90:19-45)."""
    gx = gy = None
    for j in range(3):
        v = t[..., mesh.elem_nodes[:, j]]
        gxj = v * mesh.gradient_sca[:, j]
        gyj = v * mesh.gradient_sca[:, 3 + j]
        gx = gxj if gx is None else gx + gxj
        gy = gyj if gy is None else gy + gyj
    m = mesh.elem_layer_mask
    return torch.where(m, gx, 0.0), torch.where(m, gy, 0.0)


def _muscl_dxdy(mesh: MeshTables):
    """Static per-edge reconstruction factors (ref :281, :306)."""
    et2 = mesh.edge_tri[:, 1]
    has2 = et2 >= 0
    cos1 = mesh.elem_cos[mesh.edge_tri[:, 0]]
    cos2 = mesh.elem_cos[torch.where(has2, et2, 0)]
    a = torch.where(has2, 0.5 * (cos1 + cos2), cos1) * r_earth
    return mesh.edge_dxdy[:, 0] * a, mesh.edge_dxdy[:, 1] * r_earth


def fill_up_dn_grad_r(gx, gy, mesh: MeshTables, st: TracerStatics):
    """The MUSCL edge gradients folded with the direction factors:
    (R1, R2) = (dx*g_up_x + dy*g_up_y, dx*g_dn_x + dy*g_dn_y), from the
    up/downwind triangles on layers both share, else from node-averaged
    gradients (ref oce_muscl_adv.F90:286-447, oce_adv_tra_hor.F90:301-309)."""
    up = st.edge_up_dn_tri[:, 0]
    dn = st.edge_up_dn_tri[:, 1]
    both = (up >= 0) & (dn >= 0)
    ups = torch.where(both, up, 0)
    dns = torch.where(both, dn, 0)
    gxy = torch.stack([gx, gy])
    gn = elem_to_node_mean(gxy, mesh)
    n0, n1 = mesh.edges[:, 0], mesh.edges[:, 1]
    lay = torch.arange(mesh.nl - 1, device=gx.device)[:, None]
    shared = lay < (torch.minimum(st.nln_min[n0], st.nln_min[n1]) - 1)[None, :]
    use_tri = shared & both[None, :]
    dx, dy = _muscl_dxdy(mesh)
    r_up = dx * gxy[0][..., ups] + dy * gxy[1][..., ups]
    r_dn = dx * gxy[0][..., dns] + dy * gxy[1][..., dns]
    r_n0 = dx * gn[0][..., n0] + dy * gn[1][..., n0]
    r_n1 = dx * gn[0][..., n1] + dy * gn[1][..., n1]
    return torch.where(use_tri, r_up, r_n0), torch.where(use_tri, r_dn, r_n1)


# --------------------------------------------------------------------------
# horizontal advection
# --------------------------------------------------------------------------
def _edge_vflux(u, v, helem, mesh: MeshTables):
    """Volume transport through the dual edge face [nl-1, Ed]."""
    et1, et2 = mesh.edge_tri[:, 0], mesh.edge_tri[:, 1]
    has2 = et2 >= 0
    et2s = torch.where(has2, et2, 0)
    dX1, dY1 = mesh.edge_cross_dxdy[:, 0], mesh.edge_cross_dxdy[:, 1]
    dX2, dY2 = mesh.edge_cross_dxdy[:, 2], mesh.edge_cross_dxdy[:, 3]
    he = torch.where(mesh.elem_layer_mask, helem, 0.0)
    uh, vh = u * he, v * he
    c1 = -vh[:, et1] * dX1[None] + uh[:, et1] * dY1[None]
    c2 = torch.where(has2[None, :],
                     vh[:, et2s] * dX2[None] - uh[:, et2s] * dY2[None], 0.0)
    return c1 + c2


def _muscl_reconstruct(t1, t2, R1, R2, mesh: MeshTables, st: TracerStatics,
                       dtype):
    """Interface values (tm1, tm2) from the endpoint values and R1/R2,
    with the MUSCL boundary fallback (ref oce_adv_tra_hor.F90:262-309)."""
    n0, n1 = mesh.edges[:, 0], mesh.edges[:, 1]
    nz1 = torch.arange(mesh.nl - 1, device=t1.device)[:, None] + 1
    c1 = (st.nboundary_lay[n0][None, :] >= nz1).to(dtype)
    c2 = (st.nboundary_lay[n1][None, :] >= nz1).to(dtype)
    common = 2.0 * (t2 - t1)
    return (t1 + (common + R1) / 6.0 * c1,
            t2 - (common + R2) / 6.0 * c2)


def adv_hor_lo_ho(t, tAB, vflux, mesh: MeshTables, st: TracerStatics,
                  rec, num_ord, scheme: str = "MUSCL"):
    """Low-order upwind flux of t and the MUSCL antidiffusive flux of tAB
    (already minus the low-order flux): returns (flux_lo, flux_adf)
    (ref oce_adv_tra_driver.F90:83-135)."""
    if scheme != "MUSCL":
        raise NotImplementedError(f"tra_adv_hor='{scheme}' is not ported "
                                  "yet: MFCT is ROADMAP queue 1 item 10, "
                                  "UPW1 item 15")
    n0, n1 = mesh.edges[:, 0], mesh.edges[:, 1]
    av = torch.abs(vflux)
    flux_lo = -0.5 * (t[..., n0] * (vflux + av) + t[..., n1] * (vflux - av))
    tm1, tm2 = _muscl_reconstruct(tAB[..., n0], tAB[..., n1], rec[0], rec[1],
                                  mesh, st, t.dtype)
    cHO = (vflux + av) * tm1 + (vflux - av) * tm2
    expr = 0.5 * (1.0 - num_ord) * cHO + vflux * num_ord * (0.5 * (tm1 + tm2))
    return flux_lo, -expr - flux_lo


# --------------------------------------------------------------------------
# vertical advection
# --------------------------------------------------------------------------
def _surface_flux(t, w, mesh: MeshTables):
    uln0 = (mesh.ulevels_node - 1).long()
    return take_row(w, uln0) * take_row(t, uln0) * take_row(mesh.area, uln0)


def adv_ver_upw1(t, w, mesh: MeshTables, flux_prev=None):
    """First-order upwind vertical flux [.., nl, N] (ref :231-284)."""
    nln = mesh.nlevels_node
    uln0 = mesh.ulevels_node - 1
    lev = torch.arange(mesh.nl, device=t.device)[:, None]
    aw = torch.abs(w)
    t_above = torch.cat([t[..., :1, :], t], -2)
    t_below = torch.cat([t, t[..., -1:, :]], -2)
    interior = 0.5 * (t_below * (w + aw) + t_above * (w - aw)) * mesh.area
    expr = torch.where(lev == uln0[None, :],
                       _surface_flux(t, w, mesh)[..., None, :], interior)
    expr = torch.where(lev < uln0[None, :], 0.0, expr)
    expr = torch.where(lev >= (nln - 1)[None, :], 0.0, expr)
    flux = -expr
    if flux_prev is not None:
        flux = flux - flux_prev
    return flux


def adv_ver_qr4c(t, w, Z3, zb3, mesh: MeshTables, num_ord, flux_prev=None):
    """QR4C 3rd/4th-order vertical flux (ref adv_tra_ver_qr4c :286-360)."""
    nl = mesh.nl
    nln = mesh.nlevels_node
    uln0 = mesh.ulevels_node - 1
    lev = torch.arange(nl, device=t.device)[:, None]
    area = mesh.area

    # interface k sits between layer k-1 (above) and layer k (below)
    def cat(parts):
        return torch.cat(parts, -2)[..., :nl, :]
    t1r, tLr = t[..., :1, :], t[..., -1:, :]
    tm1 = cat([t1r, t])
    t0 = cat([t, tLr])
    tm2 = cat([t1r, t1r, t])
    tp1 = cat([t[..., 1:, :], tLr, tLr])
    Zm1 = torch.cat([Z3[:1], Z3], 0)[:nl]
    Z0 = torch.cat([Z3, Z3[-1:]], 0)[:nl]
    Zm2 = torch.cat([Z3[:1], Z3[:1], Z3], 0)[:nl]
    Zp1 = torch.cat([Z3[1:], Z3[-1:], Z3[-1:]], 0)[:nl]

    def safediff(a, b):
        d = a - b
        return torch.where(d == 0, 1.0, d)

    qc = (tm1 - t0) / safediff(Zm1, Z0)
    qu = (t0 - tp1) / safediff(Z0, Zp1)
    qd = (tm2 - tm1) / safediff(Zm2, Zm1)
    Tmean1 = t0 + (2.0 * qc + qu) * (zb3 - Z0) / 3.0
    Tmean2 = tm1 + (2.0 * qc + qd) * (zb3 - Zm1) / 3.0
    aw = torch.abs(w)
    Tup = (w + aw) * Tmean1 + (w - aw) * Tmean2
    inner = (0.5 * (1.0 - num_ord) * Tup
             + num_ord * (0.5 * (Tmean1 + Tmean2)) * w) * area
    centered = (0.5 * (tm1 + t0)) * w * area

    is_surf = lev == uln0[None, :]
    is_bot = (lev >= (nln - 1)[None, :]) | (lev < uln0[None, :])
    is_cent = (lev == uln0[None, :] + 1) | (lev == (nln - 2)[None, :])
    expr = torch.where(is_cent, centered, inner)
    expr = torch.where(is_surf, _surface_flux(t, w, mesh)[..., None, :], expr)
    expr = torch.where(is_bot, 0.0, expr)
    flux = -expr
    if flux_prev is not None:
        flux = flux - flux_prev
    return flux


# --------------------------------------------------------------------------
# FCT limiter
# --------------------------------------------------------------------------
_FCT_BIG = 1e3


def fct_bounds_plain(ttf, lo, mesh: MeshTables):
    big = _FCT_BIG
    nmask = mesh.node_layer_mask
    # a1: node bounds of (LO, ttf)
    tmax = torch.where(nmask, torch.maximum(lo, ttf), -big)
    tmin = torch.where(nmask, torch.minimum(lo, ttf), big)
    # a2: element bounds over the 3 vertices
    en = mesh.elem_nodes
    emax = torch.maximum(torch.maximum(tmax[..., en[:, 0]], tmax[..., en[:, 1]]),
                         tmax[..., en[:, 2]])
    emin = torch.minimum(torch.minimum(tmin[..., en[:, 0]], tmin[..., en[:, 1]]),
                         tmin[..., en[:, 2]])
    emax = torch.where(mesh.elem_layer_mask, emax, -big)
    emin = torch.where(mesh.elem_layer_mask, emin, big)
    # a3: cluster bounds over adjacent elements, +-1 layer on the interior
    nie = mesh.nod_in_elem
    valid = nie >= 0
    safe = torch.where(valid, nie, 0)
    cl_max = cl_min = None
    for kk in range(nie.shape[-1]):
        vx = torch.where(valid[:, kk], emax[..., safe[:, kk]], -big)
        vn = torch.where(valid[:, kk], emin[..., safe[:, kk]], big)
        cl_max = vx if cl_max is None else torch.maximum(cl_max, vx)
        cl_min = vn if cl_min is None else torch.minimum(cl_min, vn)
    up_max = torch.cat([cl_max[..., :1, :], cl_max[..., :-1, :]], -2)
    dn_max = torch.cat([cl_max[..., 1:, :], cl_max[..., -1:, :]], -2)
    up_min = torch.cat([cl_min[..., :1, :], cl_min[..., :-1, :]], -2)
    dn_min = torch.cat([cl_min[..., 1:, :], cl_min[..., -1:, :]], -2)
    lay = torch.arange(mesh.nl - 1, device=lo.device)[:, None]
    interior = (lay >= 1) & (lay <= (mesh.nlevels_node - 3)[None, :])
    vmax = torch.where(interior,
                       torch.maximum(cl_max, torch.maximum(up_max, dn_max)),
                       cl_max)
    vmin = torch.where(interior,
                       torch.minimum(cl_min, torch.minimum(up_min, dn_min)),
                       cl_min)
    return (torch.where(nmask, vmax - lo, 0.0),
            torch.where(nmask, vmin - lo, 0.0))


def fct_bounds(ttf, lo, mesh: MeshTables):
    """Admissible FCT increments (inc_max, inc_min) [.., nl-1, N]: node,
    element and cluster bounds of (lo, ttf), widened by +-1 layer inside
    the column (ref oce_adv_tra_fct.F90, vlimit=1)."""
    if lo.device.type == "cpu":
        return fct_bounds_plain(ttf, lo, mesh)
    kernels.cuda_only(lo, "fct_bounds")
    dev, dt = lo.device, lo.dtype
    L, N = lo.shape[-2:]
    E = mesh.n_elems
    K = mesh.nod_in_elem.shape[1]
    lof = lo.reshape(-1, L, N).contiguous()
    T = lof.shape[0]
    ttff = ttf.reshape(T, L, N).contiguous()
    kernels.require(lof, "lo", (T, mesh.nl - 1, N), dt, dev)
    kernels.require(ttff, "ttf", (T, L, N), dt, dev)
    kernels.require(mesh.node_layer_mask, "node_layer_mask", (L, N),
                    torch.bool, dev)
    kernels.require(mesh.elem_layer_mask, "elem_layer_mask", (L, E),
                    torch.bool, dev)
    kernels.require(mesh.elem_nodes, "elem_nodes", (E, 3), torch.int32, dev)
    kernels.require(mesh.nod_in_elem, "nod_in_elem", (N, K), torch.int32, dev)
    kernels.require(mesh.nlevels_node, "nlevels_node", (N,), torch.int32, dev)
    tep_max = torch.empty((T, L, E), dtype=dt, device=dev)
    tep_min = torch.empty_like(tep_max)
    inc_max = torch.empty_like(lof)
    inc_min = torch.empty_like(lof)
    kernels.launch("fct_bounds", dev, ttff, lof, T, L, N, E,
                   mesh.node_layer_mask, mesh.elem_layer_mask,
                   mesh.elem_nodes, mesh.nod_in_elem, K, mesh.nlevels_node,
                   tep_max, tep_min, inc_max, inc_min, kernels.float_code(dt))
    return inc_max.reshape(lo.shape), inc_min.reshape(lo.shape)


def fct_limiter(ttf, lo, adf_h, adf_v, mesh: MeshTables, dt):
    """Zalesak FCT (ref oce_tra_adv_fct.F90:58-349, vlimit=1); returns the
    limited antidiffusive fluxes (adf_h, adf_v)."""
    flux_eps = 1e-16
    nmask = mesh.node_layer_mask
    inc_max, inc_min = fct_bounds(ttf, lo, mesh)

    # b1: positive/negative antidiffusive sums
    pv = torch.clamp_min(adf_v[..., :-1, :], 0.0) \
        + torch.clamp_min(-adf_v[..., 1:, :], 0.0)
    mv = torch.clamp_max(adf_v[..., :-1, :], 0.0) \
        + torch.clamp_max(-adf_v[..., 1:, :], 0.0)
    hplus, hminus = edge_signed_reduce2(adf_h, mesh)
    fplus = pv + hplus
    fminus = mv + hminus

    # b2: limiting factors
    av = torch.where(mesh.areasvol[:-1] > 0, mesh.areasvol[:-1], 1.0)
    fplus = torch.where(nmask, torch.clamp_max(
        inc_max / (fplus * dt / av + flux_eps), 1.0), 0.0)
    fminus = torch.where(nmask, torch.clamp_max(
        inc_min / (fminus * dt / av - flux_eps), 1.0), 0.0)

    # b3 vertical: donor/receiver cells (ref :284-313)
    ones = torch.ones_like(fplus[..., :1, :])
    fplus_up = torch.cat([ones, fplus[..., :-1, :]], -2)
    fminus_up = torch.cat([ones, fminus[..., :-1, :]], -2)
    pos = adf_v[..., :-1, :] >= 0.0
    lev = torch.arange(mesh.nl - 1, device=lo.device)[:, None]
    ae_v = torch.where(lev == 0, torch.where(pos, fplus, fminus),
                       torch.where(pos, torch.minimum(fminus_up, fplus),
                                   torch.minimum(fplus_up, fminus)))
    ae_v = torch.clamp_max(ae_v, 1.0)
    adf_v = torch.cat([adf_v[..., :-1, :] * ae_v, adf_v[..., -1:, :]], -2)

    # b3 horizontal: donor/receiver factors at the edge endpoints
    n0, n1 = mesh.edges[:, 0], mesh.edges[:, 1]
    ae_h = torch.where(adf_h >= 0.0,
                       torch.minimum(fplus[..., n0], fminus[..., n1]),
                       torch.minimum(fminus[..., n0], fplus[..., n1]))
    return adf_h * torch.clamp_max(ae_h, 1.0), adf_v


def flux2dtracer(flux_h, flux_v, mesh: MeshTables, dt, ttf, lo, hnode,
                 hnode_new):
    """FCT fluxes -> tracer increments (dttf_h, dttf_v) (ref
    oce_tra_adv_flux2dtracer :201-269)."""
    av = torch.where(mesh.areasvol[:-1] > 0, mesh.areasvol[:-1], 1.0)
    nmask = mesh.node_layer_mask
    dttf_v = (flux_v[..., :-1, :] - flux_v[..., 1:, :]) * dt / av
    dttf_v = dttf_v - ttf * hnode + lo * hnode_new
    dttf_h = edge_divergence(flux_h, mesh) * dt / av
    return torch.where(nmask, dttf_h, 0.0), torch.where(nmask, dttf_v, 0.0)


# --------------------------------------------------------------------------
# diffusion
# --------------------------------------------------------------------------
def diff_hor(gx, gy, helem, Ki_node, mesh: MeshTables, dt):
    """Explicit horizontal diffusion, no Redi terms (ref :934-1077).
    gx/gy are the current-step tracer gradients on elements, Ki_node [N]."""
    et1, et2 = mesh.edge_tri[:, 0], mesh.edge_tri[:, 1]
    has2 = et2 >= 0
    et2s = torch.where(has2, et2, 0)
    dX1, dY1 = mesh.edge_cross_dxdy[:, 0], mesh.edge_cross_dxdy[:, 1]
    dX2, dY2 = mesh.edge_cross_dxdy[:, 2], mesh.edge_cross_dxdy[:, 3]
    n0, n1 = mesh.edges[:, 0], mesh.edges[:, 1]
    lmask = mesh.elem_layer_mask
    m1 = lmask[:, et1]
    m2 = lmask[:, et2s] & has2[None, :]
    both = m1 & m2

    he = torch.where(lmask, helem, 0.0)
    gx1, gy1, h1 = gx[..., et1], gy[..., et1], he[:, et1]
    gx2, gy2, h2 = gx[..., et2s], gy[..., et2s], he[:, et2s]
    Kh = (0.5 * (Ki_node[n0] + Ki_node[n1]))[None, :]

    # shared layers: mean gradient and h; single-sided: one element
    c_both = ((dX2 - dX1)[None] * Kh * 0.5 * (gy1 + gy2)
              - (dY2 - dY1)[None] * Kh * 0.5 * (gx1 + gx2)) * 0.5 * (h1 + h2)
    c_el1 = (-dX1[None] * Kh * gy1 + dY1[None] * Kh * gx1) * h1
    c_el2 = (dX2[None] * Kh * gy2 - dY2[None] * Kh * gx2) * h2
    c = torch.where(both, c_both, torch.where(m1, c_el1, 0.0)
                    + torch.where(m2 & ~m1, c_el2, 0.0))
    av = torch.where(mesh.areasvol[:-1] > 0, mesh.areasvol[:-1], 1.0)
    return torch.where(mesh.node_layer_mask,
                       edge_divergence(c, mesh) * dt / av, 0.0)


def bc_surface(tracer_id: int, t_surf, forcing, dt, is_nonlinfs: float):
    """Surface boundary source (ref bc_surface :1154-1195)."""
    if tracer_id == 0:
        return -dt * (forcing.heat_flux / vcpw
                      + t_surf * forcing.water_flux * is_nonlinfs)
    if tracer_id == 1:
        return dt * (forcing.virtual_salt + forcing.relax_salt
                     - forcing.real_salt_flux * is_nonlinfs)
    raise NotImplementedError(f"tracer id {tracer_id}: passive tracers are "
                              "not ported yet: ROADMAP queue 1 item 15")


def diff_ver_impl(t, Kv, hnode_new, zbar_n_bot, mesh: MeshTables, dt,
                  surf_bc):
    """Implicit vertical diffusion of tracers t [.., nl-1, N] sharing one
    diffusivity Kv [nl, N] (ref diff_ver_part_impl_ale :398-860);
    ``surf_bc`` [.., N] is the bc_surface source of the top row."""
    nl = mesh.nl
    lay = torch.arange(nl - 1, device=t.device)[:, None]
    lmask = mesh.node_layer_mask
    is_surf = lay == (mesh.ulevels_node - 1)[None, :]
    is_bot = lay == (mesh.nlevels_node - 2)[None, :]

    # actual interface/mid depths from hnode_new (ref :536-548)
    hm = torch.where(lmask, hnode_new, 0.0)
    hsum = torch.cumsum(torch.flip(hm, (0,)), 0)
    zbar_n = torch.cat([zbar_n_bot[None, :] + torch.flip(hsum, (0,)),
                        zbar_n_bot[None, :]], 0)
    Z_n = 0.5 * (zbar_n[:-1] + zbar_n[1:])
    dZ = Z_n[:-1] - Z_n[1:]
    dZ = torch.where(dZ == 0, 1.0, dZ)
    av = torch.where(mesh.areasvol[:-1] > 0, mesh.areasvol[:-1], 1.0)
    ratio_up = mesh.area[:-1] / av
    ratio_dn = mesh.area[1:] / av

    a = torch.zeros_like(hnode_new)
    a[1:] = -Kv[1:-1] / dZ * dt
    a = torch.where(is_surf, 0.0, a * ratio_up)
    c = torch.zeros_like(hnode_new)
    c[:-1] = -Kv[1:-1] / dZ * dt
    c = torch.where(is_bot, 0.0, c * ratio_dn)
    h = torch.where(lmask, hnode_new, 1.0)
    b = -a - c + h

    zrow = torch.zeros_like(t[..., :1, :])
    t_up = torch.cat([zrow, t[..., :-1, :]], -2)
    t_dn = torch.cat([t[..., 1:, :], zrow], -2)
    rhs = -a * t_up - (b - h) * t - torch.where(is_bot, 0.0, c * t_dn)
    rhs = rhs + torch.where(is_surf, surf_bc[..., None, :], 0.0)

    a = torch.where(lmask, a, 0.0)
    c = torch.where(lmask, c, 0.0)
    b = torch.where(lmask, b, 1.0)
    rhs = torch.where(lmask, rhs, 0.0)
    return t + torch.where(lmask, tridiag_solve(a, b, c, rhs), 0.0)
