# Frozen copy of fesom2_tpu_torch/core/tracers.py, lines 1-880 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""Tracer transport: the horizontal schemes (upwind, MUSCL, MFCT), the
vertical ones (upwind, centred, QR4C, PPM), the FCT limiter, implicit
vertical advection of the w split, horizontal and Redi diffusion,
implicit vertical diffusion, shortwave penetration, the salt plume and
the surface sources of T, S and the passive tracers.

The port of ``fesom2_tpu/core/tracers.py`` (ref driver
``src/oce_adv_tra_driver.F90:41-269``; adv_tra_hor_{upw1:57,muscl:215,
mfct:485} ``oce_adv_tra_hor.F90``; adv_tra_ver_{upw1:231,qr4c:286,
ppm:361,cdiff:542}, adv_tra_vert_impl :83 ``oce_adv_tra_ver.F90``;
oce_tra_adv_fct ``oce_adv_tra_fct.F90:58-349``; fill_up_dn_grad
``oce_muscl_adv.F90:286-447``; diff_part_hor_redi, diff_ver_part_redi_expl,
diff_ver_part_impl_ale, bc_surface ``oce_ale_tracer.F90``;
cal_shortwave_rad ``oce_shortwave_pene.F90``; cal_rejected_salt,
app_rejected_salt ``oce_spp.F90``).

Tracers are stacked on a leading axis, [T, nl-1, N].  Sign convention:
``flux_h[.., Ed]`` is positive INTO edge node 0.

``fct_bounds`` (the limiter's steps a1-a3) runs a hand-written CUDA
kernel on a CUDA tensor; ``fct_bounds_plain`` beside it serves CPU
tensors only.
"""
from __future__ import annotations

import math

import torch

from ..constants import density_0, g, r_earth, rhoice, rhowat, vcpw
from ..mesh import MeshTables
from ..mesh.cluster import level_chunk
from .ops import (tridiag_solve, elem_to_node_mean, edge_divergence,
                  edge_signed_reduce2, halo_fix_node_pair, halo_fix_nodes,
                  take_row)
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


def tracer_gradient_z(t, Z_3d, mesh: MeshTables):
    """d t / dz on interfaces [..., nl, N], zero at the surface and bottom."""
    dz = Z_3d[:-1] - Z_3d[1:]
    g = (t[..., :-1, :] - t[..., 1:, :]) / torch.where(dz == 0, 1.0, dz)
    interior = mesh.node_level_mask[1:-1] & mesh.node_layer_mask[1:]
    zrow = torch.zeros_like(t[..., :1, :])
    return torch.cat([zrow, torch.where(interior, g, 0.0), zrow], -2)


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
def fill_up_dn_grad(gx, gy, mesh: MeshTables, st: TracerStatics):
    """The four MUSCL edge gradient components (gx_up, gx_dn, gy_up,
    gy_dn) [.., nl-1, Ed], unfolded (ref oce_muscl_adv.F90:286-447): the
    up/downwind triangles' gradients on the layers both share, else the
    node-averaged gradients of the edge's two nodes."""
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
    return (torch.where(use_tri, gxy[0][..., ups], gn[0][..., n0]),
            torch.where(use_tri, gxy[0][..., dns], gn[0][..., n1]),
            torch.where(use_tri, gxy[1][..., ups], gn[1][..., n0]),
            torch.where(use_tri, gxy[1][..., dns], gn[1][..., n1]))


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
                       dtype, boundary_fallback: bool = True):
    """Interface values (tm1, tm2) from the endpoint values and R1/R2
    (ref oce_adv_tra_hor.F90:262-309).  MUSCL drops the high-order
    correction at nodes within ``nboundary_lay`` of the lateral boundary
    (``boundary_fallback``); MFCT keeps it everywhere (ref :485-734)."""
    common = 2.0 * (t2 - t1)
    if not boundary_fallback:
        return t1 + (common + R1) / 6.0, t2 - (common + R2) / 6.0
    n0, n1 = mesh.edges[:, 0], mesh.edges[:, 1]
    nz1 = torch.arange(mesh.nl - 1, device=t1.device)[:, None] + 1
    c1 = (st.nboundary_lay[n0][None, :] >= nz1).to(dtype)
    c2 = (st.nboundary_lay[n1][None, :] >= nz1).to(dtype)
    return (t1 + (common + R1) / 6.0 * c1,
            t2 - (common + R2) / 6.0 * c2)


def _mpow(x, moment: int):
    """x ** do_Xmoment of the reconstructed face values: moment 2 gives
    the transport of the squared tracer that the DVD diagnostic takes
    (ref oce_adv_tra_hor.F90:144, oce_adv_tra_ver.F90:278)."""
    return x * x if moment == 2 else x


def _muscl_flux(tm1, tm2, vflux, num_ord, moment: int = 1):
    """-(the MUSCL expression) of the interface values (ref :310-320)."""
    av = torch.abs(vflux)
    cHO = (vflux + av) * _mpow(tm1, moment) + (vflux - av) * _mpow(tm2,
                                                                   moment)
    return -(0.5 * (1.0 - num_ord) * cHO
             + vflux * num_ord * _mpow(0.5 * (tm1 + tm2), moment))


def adv_hor_upw1(t, u, v, helem, mesh: MeshTables, flux_prev=None,
                 vflux=None, moment: int = 1):
    """First-order upwind horizontal flux [.., nl-1, Ed] (ref
    adv_tra_hor_upw1 oce_adv_tra_hor.F90:57-213); ``vflux`` is the
    caller's ``_edge_vflux`` of (u, v, helem), if it has one."""
    if vflux is None:
        vflux = _edge_vflux(u, v, helem, mesh)
    av = torch.abs(vflux)
    flux = -(0.5 * (_mpow(t[..., mesh.edges[:, 0]], moment) * (vflux + av)
                    + _mpow(t[..., mesh.edges[:, 1]], moment)
                    * (vflux - av)))
    if flux_prev is not None:
        flux = flux - flux_prev
    return flux


def adv_hor_muscl(t, u, v, helem, mesh: MeshTables, st: TracerStatics, eg,
                  num_ord, flux_prev=None, boundary_fallback: bool = True,
                  vflux=None):
    """MUSCL horizontal flux from the four-component edge gradients ``eg``
    of ``fill_up_dn_grad`` (ref adv_tra_hor_muscl :215-485; with
    ``boundary_fallback=False`` the MFCT scheme :485-734).  No model path
    calls it: the step folds the gradients first (``adv_hor_muscl_r``)."""
    if vflux is None:
        vflux = _edge_vflux(u, v, helem, mesh)
    dx, dy = _muscl_dxdy(mesh)
    tm1, tm2 = _muscl_reconstruct(t[..., mesh.edges[:, 0]],
                                  t[..., mesh.edges[:, 1]],
                                  dx * eg[0] + dy * eg[2],
                                  dx * eg[1] + dy * eg[3], mesh, st, t.dtype,
                                  boundary_fallback)
    flux = _muscl_flux(tm1, tm2, vflux, num_ord)
    if flux_prev is not None:
        flux = flux - flux_prev
    return flux


def adv_hor_muscl_r(t, vflux, mesh: MeshTables, st: TracerStatics, rec,
                    num_ord, boundary_fallback: bool = True,
                    moment: int = 1):
    """MUSCL (or, without ``boundary_fallback``, MFCT) horizontal flux of
    t from the folded pair ``rec`` = (R1, R2) of ``fill_up_dn_grad_r``:
    the high-order flux of a step without the FCT limiter."""
    tm1, tm2 = _muscl_reconstruct(t[..., mesh.edges[:, 0]],
                                  t[..., mesh.edges[:, 1]], rec[0], rec[1],
                                  mesh, st, t.dtype, boundary_fallback)
    return _muscl_flux(tm1, tm2, vflux, num_ord, moment)


def adv_hor_lo_ho(t, tAB, vflux, mesh: MeshTables, st: TracerStatics,
                  rec, num_ord, scheme: str = "MUSCL", moment: int = 1):
    """Low-order upwind flux of t and the antidiffusive flux of tAB
    (already minus the low-order flux): returns (flux_lo, flux_adf) (ref
    oce_adv_tra_driver.F90:83-135).  The high-order scheme is MUSCL or
    MFCT; any other name is the upwind scheme on tAB (UPW1)."""
    n0, n1 = mesh.edges[:, 0], mesh.edges[:, 1]
    av = torch.abs(vflux)
    flux_lo = -0.5 * (_mpow(t[..., n0], moment) * (vflux + av)
                      + _mpow(t[..., n1], moment) * (vflux - av))
    if scheme in ("MUSCL", "MFCT"):
        tm1, tm2 = _muscl_reconstruct(tAB[..., n0], tAB[..., n1], rec[0],
                                      rec[1], mesh, st, t.dtype,
                                      boundary_fallback=(scheme == "MUSCL"))
        return flux_lo, _muscl_flux(tm1, tm2, vflux, num_ord,
                                    moment) - flux_lo
    tm1, tm2 = tAB[..., n0], tAB[..., n1]
    expr = 0.5 * ((vflux + av) * _mpow(tm1, moment)
                  + (vflux - av) * _mpow(tm2, moment))
    return flux_lo, -expr - flux_lo


# --------------------------------------------------------------------------
# vertical advection
# --------------------------------------------------------------------------
def _surface_flux(t, w, mesh: MeshTables, moment: int = 1):
    """The flux through each column's top interface.  It is raised to
    ``moment`` like every other face, where the reference leaves it at
    the first moment (oce_adv_tra_ver.F90:263), so that a uniform tracer
    has no DVD in the top layer (``fesom2_tpu/core/tracers.py:318-326``)."""
    uln0 = (mesh.ulevels_node - 1).long()
    return take_row(w, uln0) * _mpow(take_row(t, uln0), moment) \
        * take_row(mesh.area, uln0)


def adv_ver_upw1(t, w, mesh: MeshTables, flux_prev=None, moment: int = 1):
    """First-order upwind vertical flux [.., nl, N] (ref :231-284)."""
    nln = mesh.nlevels_node
    uln0 = mesh.ulevels_node - 1
    lev = torch.arange(mesh.nl, device=t.device)[:, None]
    aw = torch.abs(w)
    t_above = _mpow(torch.cat([t[..., :1, :], t], -2), moment)
    t_below = _mpow(torch.cat([t, t[..., -1:, :]], -2), moment)
    interior = 0.5 * (t_below * (w + aw) + t_above * (w - aw)) * mesh.area
    expr = torch.where(lev == uln0[None, :],
                       _surface_flux(t, w, mesh, moment)[..., None, :],
                       interior)
    expr = torch.where(lev < uln0[None, :], 0.0, expr)
    expr = torch.where(lev >= (nln - 1)[None, :], 0.0, expr)
    flux = -expr
    if flux_prev is not None:
        flux = flux - flux_prev
    return flux


def adv_ver_qr4c(t, w, Z3, zb3, mesh: MeshTables, num_ord, flux_prev=None,
                 moment: int = 1):
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
    # the centred and surface rows take the moment too, where the
    # reference raises only the inner faces (:352-354): a uniform tracer
    # then has no DVD (``fesom2_tpu/core/tracers.py:379-382``)
    Tup = (w + aw) * _mpow(Tmean1, moment) + (w - aw) * _mpow(Tmean2, moment)
    inner = (0.5 * (1.0 - num_ord) * Tup
             + num_ord * _mpow(0.5 * (Tmean1 + Tmean2), moment) * w) * area
    centered = _mpow(0.5 * (tm1 + t0), moment) * w * area

    is_surf = lev == uln0[None, :]
    is_bot = (lev >= (nln - 1)[None, :]) | (lev < uln0[None, :])
    is_cent = (lev == uln0[None, :] + 1) | (lev == (nln - 2)[None, :])
    expr = torch.where(is_cent, centered, inner)
    expr = torch.where(is_surf,
                       _surface_flux(t, w, mesh, moment)[..., None, :], expr)
    expr = torch.where(is_bot, 0.0, expr)
    flux = -expr
    if flux_prev is not None:
        flux = flux - flux_prev
    return flux


def adv_ver_cdiff(t, w, mesh: MeshTables, flux_prev=None, moment: int = 1):
    """Centred-difference vertical flux [.., nl, N] (ref adv_tra_ver_cdiff
    :542-590)."""
    nl = mesh.nl
    nln = mesh.nlevels_node
    uln0 = mesh.ulevels_node - 1
    lev = torch.arange(nl, device=t.device)[:, None]
    tm1 = torch.cat([t[..., :1, :], t], -2)[..., :nl, :]
    t0 = torch.cat([t, t[..., -1:, :]], -2)[..., :nl, :]
    interior = _mpow(0.5 * (tm1 + t0), moment) * w * mesh.area
    expr = torch.where(lev == uln0[None, :],
                       _surface_flux(t, w, mesh, moment)[..., None, :],
                       interior)
    expr = torch.where(lev < uln0[None, :], 0.0, expr)
    expr = torch.where(lev >= (nln - 1)[None, :], 0.0, expr)
    flux = -expr
    if flux_prev is not None:
        flux = flux - flux_prev
    return flux


def _ppm_slope(hm, h0, hp, tm, t0, tp):
    """The monotonised slope of layer 0 from its neighbours (ref :432-455)."""
    d = h0 / (hm + h0 + hp) * (
        (2.0 * hm + h0) / (hp + h0) * (tp - t0)
        + (h0 + 2.0 * hp) / (hm + h0) * (t0 - tm))
    lim = torch.minimum(torch.abs(d),
                        torch.minimum(2.0 * torch.abs(tp - t0),
                                      2.0 * torch.abs(t0 - tm))) * torch.sign(d)
    return torch.where((tp - t0) * (t0 - tm) > 0.0, lim, 0.0)


def adv_ver_ppm(t, w, hnode_old, hnode_new, mesh: MeshTables, dt,
                flux_prev=None, moment: int = 1):
    """Piecewise-parabolic vertical flux [.., nl, N] (Colella & Woodward
    1984; ref adv_tra_vert_ppm oce_adv_tra_ver.F90:361-538): the interface
    values of the non-uniform grid (eq. 1.6-1.8) on ``hnode_new``, the
    monotonised parabola of each layer, and the CFL-weighted upwind flux
    on ``hnode_old``.  Tracers on leading axes are independent (JAX maps
    the function over them)."""
    nl = mesh.nl
    nln = mesh.nlevels_node
    lev = torch.arange(nl, device=t.device)[:, None]
    lmask = mesh.node_layer_mask
    hN = torch.where(lmask, hnode_new, 1.0)
    hO = torch.where(lmask, hnode_old, 1.0)

    def iface(arr, s):
        """Layer i-1+s on the interface axis [.., nl, N], edge-padded."""
        first, last = arr[..., :1, :], arr[..., -1:, :]
        padded = torch.cat([first, first, arr, last, last], -2)
        return padded[..., 1 + s:1 + s + nl, :]

    tA, tB, tC, tD = (iface(t, s) for s in (-1, 0, 1, 2))
    hA, hB, hC, hD = (iface(hN, s) for s in (-1, 0, 1, 2))
    deltaj = _ppm_slope(hA, hB, hC, tA, tB, tC)
    deltajp1 = _ppm_slope(hB, hC, hD, tB, tC, tD)
    tv = (tB + hB / (hB + hC) * (tC - tB)
          + 1.0 / (hA + hB + hC + hD) * (
              (2.0 * hC * hB) / (hB + hC)
              * ((hA + hB) / (2.0 * hB + hC) - (hD + hC) / (2.0 * hC + hB))
              * (tC - tB)
              - hB * (hA + hB) / (2.0 * hB + hC) * deltajp1
              + hC * (hC + hD) / (hB + 2.0 * hC) * deltaj))

    # the special interfaces (ref :407-416); the surface row is ulevels-1
    uln0 = (mesh.ulevels_node - 1).long()
    t_up = torch.cat([t[..., :1, :], t], -2)[..., :nl, :]     # t[i-1]
    t_dn = torch.cat([t, t[..., -1:, :]], -2)[..., :nl, :]    # t[i]
    tv = torch.where(lev <= uln0[None, :], take_row(t, uln0)[..., None, :],
                     tv)
    tv = torch.where(lev == uln0[None, :] + 1, 0.5 * (t_up + t_dn), tv)
    tv = torch.where(lev == (nln - 2)[None, :],
                     torch.where(w >= 0, t_dn, t_up), tv)
    bot_t = take_row(t_dn, (nln - 2).long())
    tv = torch.where(lev >= (nln - 1)[None, :], bot_t[..., None, :], tv)

    # the monotonised parabola of each layer (ref :499-520)
    aL, aR = tv[..., :-1, :], tv[..., 1:, :]
    over = (aR - t) * (t - aL) <= 0.0
    aL = torch.where(over, t, aL)
    aR = torch.where(over, t, aR)
    steepL = (aR - aL) * (t - 0.5 * (aL + aR)) > (aR - aL) ** 2 / 6.0
    aL = torch.where(steepL, 3.0 * t - 2.0 * aR, aL)
    steepR = (aR - aL) * (t - 0.5 * (aR + aL)) < -(aR - aL) ** 2 / 6.0
    aR = torch.where(steepR, 3.0 * t - 2.0 * aL, aR)
    aj = 6.0 * (t - 0.5 * (aL + aR))

    # the interface fluxes (ref :522-536): from the layer below where
    # W > 0, from the layer above where W < 0; the moment is taken of the
    # negated reconstruction (ref :517-525), so under moment 2 the sign
    # goes, as in the reference and the JAX package
    w_lay = w[:-1]
    x_up = torch.clamp_max(w_lay * dt / hO, 1.0)
    from_below = _mpow(-aL - 0.5 * x_up * (aR - aL + (1.0 - 2.0 / 3.0 * x_up)
                                           * aj), moment) \
        * mesh.area[:-1] * w_lay
    w_dn = w[1:]
    x_dn = torch.clamp_max(-w_dn * dt / hO, 1.0)
    from_above = _mpow(-aR + 0.5 * x_dn * (aR - aL - (1.0 - 2.0 / 3.0 * x_dn)
                                           * aj), moment) \
        * mesh.area[1:] * w_dn
    zrow = torch.zeros_like(t[..., :1, :])
    tvert = torch.cat([torch.where(w_lay > 0, from_below, 0.0), zrow], -2) \
        + torch.cat([zrow, torch.where(w_dn < 0, from_above, 0.0)], -2)
    surf = -_mpow(take_row(tv, uln0), moment) * take_row(w, uln0) \
        * take_row(mesh.area, uln0)
    tvert = torch.where(lev == uln0[None, :], surf[..., None, :], tvert)
    tvert = torch.where(lev < uln0[None, :], 0.0, tvert)
    flux = torch.where(lev >= (nln - 1)[None, :], 0.0, tvert)
    if flux_prev is not None:
        flux = flux - flux_prev
    return flux


def adv_vert_impl(t, w, hnode_new, mesh: MeshTables, dt):
    """Implicit upwind vertical advection by the w split's implicit part
    w [nl, N] of tracers t [.., nl-1, N] (ref adv_tra_vert_impl :83-230):
    one tridiagonal system per column, shared by the tracers."""
    lay = torch.arange(mesh.nl - 1, device=t.device)[:, None]
    lmask = mesh.node_layer_mask
    is_surf = lay == 0
    is_bot = lay == (mesh.nlevels_node - 2)[None, :]
    av = torch.where(mesh.areasvol[:-1] > 0, mesh.areasvol[:-1], 1.0)
    ratio_up = dt * mesh.area[:-1] / av
    ratio_dn = dt * mesh.area[1:] / av
    wu, wd = w[:-1], w[1:]
    a = torch.where(is_surf, 0.0, torch.clamp_max(wu, 0.0) * ratio_up)
    b_up = torch.where(is_surf, wu * ratio_up,
                       torch.clamp_min(wu, 0.0) * ratio_up)
    b_dn = torch.where(is_bot, 0.0, -torch.clamp_max(wd, 0.0) * ratio_dn)
    c = torch.where(is_bot, 0.0, -torch.clamp_min(wd, 0.0) * ratio_dn)
    h = torch.where(lmask, hnode_new, 1.0)
    b = h + b_up + b_dn

    zrow = torch.zeros_like(t[..., :1, :])
    t_up = torch.cat([zrow, t[..., :-1, :]], -2)
    t_dn = torch.cat([t[..., 1:, :], zrow], -2)
    rhs = -a * t_up - (b - h) * t - c * torch.where(is_bot, 0.0, t_dn)
    a = torch.where(lmask, a, 0.0)
    c = torch.where(lmask, c, 0.0)
    b = torch.where(lmask, b, 1.0)
    rhs = torch.where(lmask, rhs, 0.0)
    return t + torch.where(lmask, tridiag_solve(a, b, c, rhs), 0.0)


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


def fct_bounds_work(ntr: int, levels: int, n_nodes: int, m_max: int,
                    itemsize: int, list_len: int, tile_nodes: int) -> tuple:
    """(bytes, flops) of one call on ttf, lo [ntr, levels, N]: both read,
    inc_max and inc_min written, the [M, N] neighbour words, the node
    words and ``nlevels_node`` [N], the tiles' neighbour lists
    (``list_len`` entries) and pointers.  Per output level and neighbour
    a max, a min and their two accumulations; 4 compares of the +-1 layer
    rule and 2 subtractions."""
    tiles = -(-n_nodes // tile_nodes)
    nbytes = (4 * ntr * levels * n_nodes * itemsize
              + n_nodes * 4 * (m_max + 2) + 4 * (list_len + tiles + 1))
    return nbytes, (4 * m_max + 6) * ntr * levels * n_nodes


def fct_bounds(ttf, lo, mesh: MeshTables):
    """Admissible FCT increments (inc_max, inc_min) [.., nl-1, N]: node,
    element and cluster bounds of (lo, ttf), widened by +-1 layer inside
    the column (ref oce_adv_tra_fct.F90, vlimit=1)."""
    return halo_fix_node_pair(*fct_bounds_plain(ttf, lo, mesh))


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


def flux2dtracer(flux_h, flux_v, mesh: MeshTables, dt, ttf=None, lo=None,
                 hnode=None, hnode_new=None):
    """Fluxes -> tracer increments (dttf_h, dttf_v) (ref
    oce_tra_adv_flux2dtracer :201-269); with the FCT low-order solution
    ``lo`` the vertical increment is taken against it."""
    av = torch.where(mesh.areasvol[:-1] > 0, mesh.areasvol[:-1], 1.0)
    nmask = mesh.node_layer_mask
    dttf_v = (flux_v[..., :-1, :] - flux_v[..., 1:, :]) * dt / av
    if lo is not None:
        dttf_v = dttf_v - ttf * hnode + lo * hnode_new
    dttf_h = edge_divergence(flux_h, mesh) * dt / av
    return torch.where(nmask, dttf_h, 0.0), torch.where(nmask, dttf_v, 0.0)


# --------------------------------------------------------------------------
# diffusion
# --------------------------------------------------------------------------
def diff_hor(gx, gy, helem, Ki_node, mesh: MeshTables, dt, tr_z=None,
             slope_tapered=None):
    """Explicit horizontal diffusion (ref :934-1077).  gx/gy are the
    current-step tracer gradients on elements; Ki_node is [N] or layered
    [nl-1, N].  With ``tr_z`` [.., nl, N] and ``slope_tapered``
    [3, nl-1, N] the Redi cross terms Kh (Sx Tz, Sy Tz) are added to the
    gradients (isredi=1, ref :984-991)."""
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
    Kh = 0.5 * (Ki_node[..., n0] + Ki_node[..., n1])
    if Ki_node.dim() == 1:
        Kh = Kh[None, :]
    if tr_z is not None and slope_tapered is not None:
        # Tz at the layer mid from its two interfaces, averaged over the
        # edge's two nodes
        Tz_lay = 0.5 * (tr_z[..., :-1, :] + tr_z[..., 1:, :])
        SxTz_n = Tz_lay * slope_tapered[0]
        SyTz_n = Tz_lay * slope_tapered[1]
        SxTz = 0.5 * (SxTz_n[..., n0] + SxTz_n[..., n1])
        SyTz = 0.5 * (SyTz_n[..., n0] + SyTz_n[..., n1])
        gx1, gy1 = gx1 + SxTz, gy1 + SyTz
        gx2, gy2 = gx2 + SxTz, gy2 + SyTz

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


def depths_from_thickness(hnode, mesh: MeshTables, zbot=None):
    """Interface and mid depths (zbar_n [nl, N], Z_n [nl-1, N]) of the
    layer thicknesses ``hnode``, stacked up from the bottom ``zbot``
    (default: the node bottom, partial cells included) (ref :536-548)."""
    zbot = mesh.zbar_n_bot if zbot is None else zbot
    hm = torch.where(mesh.node_layer_mask, hnode, 0.0)
    hsum = torch.cumsum(torch.flip(hm, (0,)), 0)
    zbar_n = torch.cat([zbot[None, :] + torch.flip(hsum, (0,)), zbot[None, :]],
                       0)
    return zbar_n, 0.5 * (zbar_n[:-1] + zbar_n[1:])


def diff_ver_redi_expl(gx, gy, slope_tapered, Ki_layered, hnode_new,
                       mesh: MeshTables, dt):
    """Explicit vertical Redi flux from the horizontal gradients (ref
    :860-934): a tracer increment [.., nl-1, N].  gx/gy are the element
    gradients of the current step."""
    nie = mesh.nod_in_elem
    valid = nie >= 0
    safe = torch.where(valid, nie, 0)
    w = torch.where(valid, mesh.elem_area[safe], 0.0)
    wl = torch.where(mesh.elem_layer_mask[:, safe], w[None], 0.0)
    av = torch.where(mesh.areasvol[:-1] > 0, mesh.areasvol[:-1], 1.0)
    gxy = torch.stack([gx, gy])
    acc = None
    for kk in range(nie.shape[-1]):
        v = gxy[..., safe[:, kk]] * wl[..., kk]
        acc = v if acc is None else acc + v
    txy = halo_fix_nodes(acc / 3.0 / av)
    tx, ty = txy[0], txy[1]

    zbar_n, Z_n = depths_from_thickness(hnode_new, mesh)
    dZ = Z_n[:-1] - Z_n[1:]
    dZ = torch.where(dZ == 0, 1.0, dZ)
    ks = Ki_layered * (slope_tapered[0] * tx + slope_tapered[1] * ty)
    fa = (Z_n[:-1] - zbar_n[1:-1]) * ks[..., :-1, :]
    fb = (zbar_n[1:-1] - Z_n[1:]) * ks[..., 1:, :]
    vd = (fa + fb) / dZ * mesh.area[1:-1]
    lev = torch.arange(mesh.nl, device=gx.device)[:, None]
    interior = (lev >= 1) & (lev <= (mesh.nlevels_node - 2)[None, :])
    zrow = torch.zeros_like(vd[..., :1, :])
    vd_full = torch.where(interior, torch.cat([zrow, vd, zrow], -2), 0.0)
    out = (vd_full[..., :-1, :] - vd_full[..., 1:, :]) * dt / av
    return torch.where(mesh.node_layer_mask, out, 0.0)


def shortwave_penetration(shortwave, a_ice, zbar_3d, mesh: MeshTables,
                          albw: float, chl_const: float = 0.1):
    """Visible shortwave through the interfaces, Morel & Antoine (1994)
    with the Sweeney et al. (2005) coefficients at constant chlorophyll
    (ref cal_shortwave_rad oce_shortwave_pene.F90:1-95).  Returns (sw_3d
    [nl, N], the temperature flux through each interface in K m/s; dheat
    [N], to add to heat_flux: the visible part leaves the surface flux and
    is deposited at depth).  No penetration under ice."""
    c = math.log10(max(chl_const, 0.02))
    c2, c3, c4, c5 = c * c, c ** 3, c ** 4, c ** 5
    v1 = 0.008 * c + 0.132 * c2 + 0.038 * c3 - 0.017 * c4 - 0.007 * c5
    v2 = 0.679 - v1
    v1 = 0.321 + v1
    sc1 = 1.54 - 0.197 * c + 0.166 * c2 - 0.252 * c3 - 0.055 * c4 + 0.042 * c5
    sc2 = 7.925 - 6.644 * c + 3.662 * c2 - 1.815 * c3 - 0.218 * c4 \
        + 0.502 * c5

    swsurf = torch.where(a_ice <= 0.0, (1.0 - albw) * shortwave * 0.54, 0.0)
    swflux = swsurf / vcpw
    aux = v1 * torch.exp(zbar_3d / sc1) + v2 * torch.exp(zbar_3d / sc2)
    lev = torch.arange(mesh.nl, device=aux.device)[:, None]
    # zero from the first interface where aux < 1e-5 (the reference exits
    # its loop there) and at and below the bottom interface
    dead = torch.cumsum((aux < 1e-5).to(aux.dtype), 0) > 0
    sw = torch.where(dead | (lev >= (mesh.nlevels_node - 1)[None, :]), 0.0,
                     swflux[None, :] * aux)
    return torch.cat([swflux[None, :], sw[1:]], 0), swsurf


def sw_3d_source(sw_3d, mesh: MeshTables, dt):
    """Layer temperature source [nl-1, N] of the interface flux divergence
    (ref oce_ale_tracer.F90:784-790)."""
    ratio = mesh.area[1:] / torch.where(mesh.areasvol[:-1] > 0,
                                        mesh.areasvol[:-1], 1.0)
    src = (sw_3d[:-1] - sw_3d[1:] * ratio) * dt
    return torch.where(mesh.node_layer_mask, src, 0.0)


def salt_plume(S, state, mesh: MeshTables, forcing, cfg):
    """Salt-plume parameterisation (ref cal_rejected_salt /
    app_rejected_salt oce_spp.F90:1-69): in the Northern Hemisphere the
    brine that growing ice rejects leaves the surface layer and is spread
    over the mixed layer (the layers down to the first with drho/dz >=
    0.01 or Z < -50 m, the Nguyen 2011 criterion) with (Z_1 - Z_k)^5
    weights.  S [nl-1, N]; returns the new salinity.  Each column's salt
    (S h areasvol summed) is kept to rounding."""
    dt = cfg.dt
    n_distr = 5
    drhodz_cri = 0.01
    S0 = S[0]
    rej = torch.where(forcing.thdgr > 0.0,
                      (S0 - cfg.ice.Sice) * forcing.thdgr * (rhoice / rhowat)
                      * dt * mesh.area[0], 0.0)
    apply = (rej > 0.0) & (S0 >= 10.0) & (mesh.geo_coords[:, 1] > 0.0)

    # the mixed layer: down to the first layer of the criterion, above the
    # bottom layer
    drhodz = state.bvfreq[:-1] * density_0 / g
    lay = torch.arange(mesh.nl - 1, device=S.device)[:, None]
    cond = (drhodz >= drhodz_cri) | (state.Z_3d < -50.0) \
        | (lay >= (mesh.nlevels_node - 2)[None, :])
    n_cont = torch.argmax(cond.to(torch.uint8), 0)
    recv = (lay >= 1) & (lay <= n_cont[None, :])

    w = mesh.area[:-1] * state.hnode \
        * (state.Z_3d[0][None, :] - state.Z_3d) ** n_distr
    w = torch.where(recv, w, 0.0)
    wsum = w.sum(0)
    ok = apply & (n_cont >= 1) & (wsum > 0.0)
    w = w / torch.where(wsum > 0, wsum, 1.0)[None, :]

    hsafe = torch.where(mesh.node_layer_mask, state.hnode, 1.0)
    asafe = torch.where(mesh.areasvol[:-1] > 0, mesh.areasvol[:-1], 1.0)
    dS = rej[None, :] * w / asafe / hsafe
    dS = torch.cat([(-rej / asafe[0] / hsafe[0])[None, :], dS[1:]], 0)
    return torch.where(ok[None, :] & mesh.node_layer_mask, S + dS, S)


def bc_surface(tracer_id: int, t_surf, forcing, dt, is_nonlinfs: float):
    """Surface boundary source (ref bc_surface :1154-1195): heat and
    salt, the rain-water tracer (id 101) fed by liquid precipitation
    (ref :1178), none for the region-restored tracers (301-303) and any
    other id."""
    if tracer_id == 0:
        return -dt * (forcing.heat_flux / vcpw
                      + t_surf * forcing.water_flux * is_nonlinfs)
    if tracer_id == 1:
        return dt * (forcing.virtual_salt + forcing.relax_salt
                     - forcing.real_salt_flux * is_nonlinfs)
    if tracer_id == 101:
        return dt * forcing.prec_rain
    return torch.zeros_like(t_surf)


def diff_ver_impl(t, Kv, hnode_new, zbar_n_bot, mesh: MeshTables, dt,
                  surf_bc, w_i=None, sw_source=None, Ki_layered=None,
                  slope3=None):
    """Implicit vertical diffusion of tracers t [.., nl-1, N] sharing one
    diffusivity Kv [nl, N] (ref diff_ver_part_impl_ale :398-860).
    ``surf_bc`` [.., N] is the bc_surface source of the top row;
    ``sw_source`` [.., nl-1, N] a source added to every row; ``w_i`` adds
    the implicit vertical advection of the w split; with ``Ki_layered``
    and the tapered slope magnitude ``slope3`` [nl-1, N] the Redi K33 =
    Ki S^2 is added to Kv on the interior interfaces (ref :548-590)."""
    nl = mesh.nl
    lay = torch.arange(nl - 1, device=t.device)[:, None]
    lmask = mesh.node_layer_mask
    is_surf = lay == (mesh.ulevels_node - 1)[None, :]
    is_bot = lay == (mesh.nlevels_node - 2)[None, :]

    zbar_n, Z_n = depths_from_thickness(hnode_new, mesh, zbar_n_bot)
    dZ = Z_n[:-1] - Z_n[1:]
    dZ = torch.where(dZ == 0, 1.0, dZ)
    av = torch.where(mesh.areasvol[:-1] > 0, mesh.areasvol[:-1], 1.0)
    ratio_up = mesh.area[:-1] / av
    ratio_dn = mesh.area[1:] / av

    Kv_in = Kv[1:-1]
    if Ki_layered is not None and slope3 is not None:
        # K33 at each interior interface: the thickness-weighted mean of
        # Ki S^2 of the two layers around it (ref :548-556)
        ks2 = Ki_layered * slope3 ** 2
        wa = (Z_n[:-1] - zbar_n[1:-1]) / dZ
        wb = (zbar_n[1:-1] - Z_n[1:]) / dZ
        Ty = wa * ks2[:-1] + wb * ks2[1:]
        Kv_in = Kv_in + torch.where(torch.isfinite(Ty), Ty, 0.0)
    a = torch.zeros_like(hnode_new)
    a[1:] = -Kv_in / dZ * dt
    a = torch.where(is_surf, 0.0, a * ratio_up)
    c = torch.zeros_like(hnode_new)
    c[:-1] = -Kv_in / dZ * dt
    c = torch.where(is_bot, 0.0, c * ratio_dn)
    h = torch.where(lmask, hnode_new, 1.0)
    b = -a - c + h
    if w_i is not None:
        wu, wd = w_i[:-1], w_i[1:]
        a = a + torch.where(is_surf, 0.0, torch.clamp_max(wu, 0.0)) * dt \
            * ratio_up
        b = b + torch.where(is_surf, wu, torch.clamp_min(wu, 0.0)) * dt \
            * ratio_up
        b = b - torch.where(is_bot, 0.0, torch.clamp_max(wd, 0.0)) * dt \
            * ratio_dn
        c = c - torch.where(is_bot, 0.0, torch.clamp_min(wd, 0.0)) * dt \
            * ratio_dn

    zrow = torch.zeros_like(t[..., :1, :])
    t_up = torch.cat([zrow, t[..., :-1, :]], -2)
    t_dn = torch.cat([t[..., 1:, :], zrow], -2)
    rhs = -a * t_up - (b - h) * t - torch.where(is_bot, 0.0, c * t_dn)
    rhs = rhs + torch.where(is_surf, surf_bc[..., None, :], 0.0)
    if sw_source is not None:
        rhs = rhs + sw_source

    a = torch.where(lmask, a, 0.0)
    c = torch.where(lmask, c, 0.0)
    b = torch.where(lmask, b, 1.0)
    rhs = torch.where(lmask, rhs, 0.0)
    return t + torch.where(lmask, tridiag_solve(a, b, c, rhs), 0.0)
