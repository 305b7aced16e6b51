"""Optional diagnostics (ref ``src/gen_modules_diag.F90``, namelist
&diag_list): the curl of the surface stress, the 3D relative vorticity,
the energy-budget fields, the density-space MOC binning and the global
salt integral.

The port of ``fesom2_tpu/core/diagnostics.py``.  The assemblies go
through the port's assembly ops (``edge_divergence``,
``elem_to_node_mean``), which launch their kernels on a CUDA tensor.
The density-class binning of ``diag_dens_moc`` runs the hand-written
CUDA kernel ``csrc/dens_moc_bin.cu`` on a CUDA tensor (one thread an
element: no [nl-1, S, E] overlap tensor is ever formed);
``dens_moc_bin_plain`` beside it, the JAX package's chain over chunks of
elements, serves CPU tensors only.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .. import kernels
from ..constants import density_0, vcpw
from ..mesh import MeshTables
from . import eos
from .dynamics import relative_vorticity
from .ops import edge_divergence, elem_to_node_mean, scalar_gradient, take_row
from .state import Forcing, OceanState

# standard density classes (sigma_2) of the density-space MOC
# (ref gen_modules_diag.F90:38-49)
STD_DENS = np.array([
    0.0000, 30.00000, 30.55556, 31.11111, 31.36000, 31.66667, 31.91000,
    32.22222, 32.46000, 32.77778, 33.01000, 33.33333, 33.56000, 33.88889,
    34.11000, 34.44444, 34.62000, 35.00000, 35.05000, 35.10622, 35.20319,
    35.29239, 35.37498, 35.41300, 35.45187, 35.52380, 35.59136, 35.65506,
    35.71531, 35.77247, 35.82685, 35.87869, 35.92823, 35.97566, 35.98000,
    36.02115, 36.06487, 36.10692, 36.14746, 36.18656, 36.22434, 36.26089,
    36.29626, 36.33056, 36.36383, 36.39613, 36.42753, 36.45806, 36.48778,
    36.51674, 36.54495, 36.57246, 36.59500, 36.59932, 36.62555, 36.65117,
    36.67621, 36.68000, 36.70071, 36.72467, 36.74813, 36.75200, 36.77111,
    36.79363, 36.81570, 36.83733, 36.85857, 36.87500, 36.87940, 36.89985,
    36.91993, 36.93965, 36.95904, 36.97808, 36.99682, 37.01524, 37.03336,
    37.05119, 37.06874, 37.08602, 37.10303, 37.11979, 37.13630, 37.15257,
    37.16861, 37.18441, 37.50000, 37.75000, 40.00000])

# the five binned fields of diag_dens_moc, in the kernel's output order
DMOC_BINNED = ("std_dens_UDZ", "std_dens_VDZ", "std_dens_VOL", "std_dens_Z",
               "std_dens_W")


def _elem_mean(x: torch.Tensor, mesh: MeshTables) -> torch.Tensor:
    """The mean of a node field over each element's three nodes, [.., N]
    -> [.., E], as ``jnp.mean`` takes it: the sum times 1/3."""
    return x[..., mesh.elem_nodes].sum(-1) * (1.0 / 3.0)


def curl_stress_surf(forcing: Forcing, mesh: MeshTables) -> torch.Tensor:
    """Curl of the surface stress at nodes [N] (ref diag_curl_stress_surf
    :100-140)."""
    et1, et2 = mesh.edge_tri[:, 0], mesh.edge_tri[:, 1]
    has2 = et2 >= 0
    et2s = torch.where(has2, et2, 0)
    dX1, dY1 = mesh.edge_cross_dxdy[:, 0], mesh.edge_cross_dxdy[:, 1]
    dX2, dY2 = mesh.edge_cross_dxdy[:, 2], mesh.edge_cross_dxdy[:, 3]
    sx, sy = forcing.stress_x, forcing.stress_y
    c = dX1 * sx[et1] + dY1 * sy[et1] \
        + torch.where(has2, -dX2 * sx[et2s] - dY2 * sy[et2s], 0.0)
    av = mesh.areasvol[0]
    return edge_divergence(c, mesh) / torch.where(av > 0, av, 1.0)


def curl_vel3(state: OceanState, mesh: MeshTables) -> torch.Tensor:
    """3D relative vorticity at nodes [nl-1, N] (ref diag_curl_vel3
    :143-216; the assembly of ``relative_vorticity``)."""
    return relative_vorticity(state, mesh)


def diag_energy(state: OceanState, mesh: MeshTables, forcing: Forcing,
                cfg) -> Dict[str, torch.Tensor]:
    """Energy-budget fields (ref diag_energy :219-385): Reynolds products,
    the vertical shear and its Av-weighted products, surface and bottom
    stress work, the horizontal velocity-gradient tensor, rho and w*rho at
    interfaces."""
    lmask = mesh.elem_layer_mask
    nmask = mesh.node_layer_mask
    nl, E, N = mesh.nl, mesh.n_elems, mesh.n_nodes
    dev, dt = state.u.device, state.u.dtype
    out: Dict[str, torch.Tensor] = {}

    un, vn = state.unode, state.vnode
    out["u_x_u"] = torch.where(nmask, un * un, 0.0)
    out["u_x_v"] = torch.where(nmask, un * vn, 0.0)
    out["v_x_v"] = torch.where(nmask, vn * vn, 0.0)

    # element vertical shear (central differences at interior interfaces)
    hsafe = torch.where(lmask, state.helem, 1.0)
    hm = torch.where(lmask, state.helem, 0.0)
    Ze = -torch.cumsum(hm, 0) + hm / 2.0                 # element mid depths
    dZ = Ze[:-1] - Ze[1:]
    dZi = 1.0 / torch.where(dZ == 0, 1.0, dZ)
    lev = torch.arange(nl, device=dev)[:, None]
    nle = mesh.nlevels_elem.long()
    imask_e = (lev >= 1) & (lev <= (nle - 2)[None, :])
    zrow = torch.zeros((1, E), dtype=dt, device=dev)
    dudz = torch.cat([zrow, (state.u[:-1] - state.u[1:]) * dZi, zrow], 0)
    dvdz = torch.cat([zrow, (state.v[:-1] - state.v[1:]) * dZi, zrow], 0)
    dudz = torch.where(imask_e, dudz, 0.0)
    dvdz = torch.where(imask_e, dvdz, 0.0)
    out["dudz"], out["dvdz"] = dudz, dvdz
    out["av_dudz_sq"] = (dudz ** 2 + dvdz ** 2) * state.Av
    out["av_dudz"] = dudz * state.Av
    out["av_dvdz"] = dvdz * state.Av

    # surface and bottom stress work (C_d bottom drag, ref :276-283)
    C_d = cfg.dyn.C_d
    bot = torch.clamp_min(nle - 2, 0)
    ub = take_row(state.u, bot)
    vb = take_row(state.v, bot)
    spd = torch.sqrt(ub ** 2 + vb ** 2)
    out["stress_bott_x"] = -C_d * spd * ub
    out["stress_bott_y"] = -C_d * spd * vb
    out["utau_surf"] = (forcing.stress_x * state.u[0]
                        + forcing.stress_y * state.v[0]) / density_0
    out["utau_bott"] = out["stress_bott_x"] * ub + out["stress_bott_y"] * vb
    out["u_surf"], out["v_surf"] = state.u[0], state.v[0]
    out["u_bott"], out["v_bott"] = ub, vb

    # w*u at element interfaces (thickness-weighted, ref :291-296)
    we = _elem_mean(state.w, mesh)                        # [nl, E]
    iup = torch.clamp_min(torch.arange(nl - 1, device=dev) - 1, 0)
    h_up, h_lo = hsafe[iup], hsafe
    out["u_x_w"] = torch.where(lmask, we[:-1] * (state.u[iup] * h_up
                               + state.u * h_lo) / (h_up + h_lo), 0.0)
    out["v_x_w"] = torch.where(lmask, we[:-1] * (state.v[iup] * h_up
                               + state.v * h_lo) / (h_up + h_lo), 0.0)

    # the velocity-gradient tensor at nodes: the area-weighted mean over
    # the adjacent elements of the element gradients of Unode (ref
    # :322-343), the four through one call
    gux, guy = scalar_gradient(un, mesh)
    gvx, gvy = scalar_gradient(vn, mesh)
    grads = torch.where(lmask, torch.stack([gux, guy, gvx, gvy]), 0.0)
    for name, g in zip(("dudx", "dudy", "dvdx", "dvdy"),
                       elem_to_node_mean(grads, mesh)):
        out[name] = g

    # rho and w*rho at interfaces (thickness-weighted means, ref :300-317)
    rho = state.density_m_rho0
    hn = torch.where(nmask, state.hnode_new, 1.0)
    inner = (hn[1:] * rho[1:] + hn[:-1] * rho[:-1]) / (hn[1:] + hn[:-1])
    rhof = torch.cat([rho[:1], inner, torch.zeros_like(rho[:1])], 0)
    nb = (mesh.nlevels_node.long() - 1)[None, :]
    rho_bot = torch.gather(rho, 0, torch.clamp_min(nb - 1, 0))
    rhof = torch.where(lev == nb, rho_bot, rhof)
    rhof = torch.where(mesh.node_level_mask, rhof, 0.0)
    out["rhof"] = rhof
    out["wrhof"] = rhof * state.w
    return out


def density_dmoc(state: OceanState, cfg) -> torch.Tensor:
    """Potential density referenced to 2000 db (sigma_2 + 1000) at layers
    [nl-1, N] (ref pressure_bv oce_ale_pressure_bv.F90:195-201)."""
    bulk_0, bulk_pz, bulk_pz2, rhopot = eos.eos_components(
        state.tr[0], state.tr[1], cfg.dyn.state_equation, cfg.run.toy_ocean)
    if cfg.dyn.state_equation == 0:
        return rhopot
    rho = bulk_0 - 2000.0 * (bulk_pz - 2000.0 * bulk_pz2)
    return rho * rhopot / (rho - 200.0)


# --------------------------------------------------------------------------
# the density-class binning (kernel dens_moc_bin)
# --------------------------------------------------------------------------
def _layer_mask(ulevels_elem, nlevels_elem, layers: int) -> torch.Tensor:
    lay = torch.arange(layers, device=ulevels_elem.device)[:, None]
    return (lay < (nlevels_elem.long() - 1)[None, :]) \
        & (lay >= (ulevels_elem.long() - 1)[None, :])


def _class_edges(bins: torch.Tensor):
    """(lo, hi) [S]: class s spans [mid(s-1, s), mid(s, s+1)], the outer
    classes to -1e30 and 1e30."""
    mids = 0.5 * (bins[:-1] + bins[1:])
    big = torch.tensor([1e30], dtype=bins.dtype, device=bins.device)
    return torch.cat([-big, mids]), torch.cat([mids, big])


def dens_moc_bin_plain(dens, helem, u, v, elem_area, ulevels_elem,
                       nlevels_elem, bins, fer_u=None, fer_v=None,
                       chunk: Optional[int] = None) -> torch.Tensor:
    """The binning of ``fesom2_tpu/core/diagnostics.py:200-245`` as it
    stands, over chunks of ``chunk`` elements (each element's classes
    depend on that element alone, so the chunks keep the [nl-1, S, chunk]
    overlap tensors small without changing what is computed): returns
    [5, S, E], the rows ``DMOC_BINNED``."""
    L, E = helem.shape
    S = bins.shape[0]
    dt, dev = helem.dtype, helem.device
    lmask = _layer_mask(ulevels_elem, nlevels_elem, L)
    lo, hi = _class_edges(bins)
    if fer_u is not None:
        u = u + fer_u
    if fer_v is not None:
        v = v + fer_v
    hm = torch.where(lmask, helem, 0.0)
    udz = torch.where(lmask, u * helem, 0.0)
    vdz = torch.where(lmask, v * helem, 0.0)
    vol = hm * elem_area[None, :]
    zmid = torch.cumsum(hm, 0) - hm / 2.0
    z = -zmid * torch.where(lmask, 1.0, 0.0)
    dmin = torch.minimum(dens[:-1], dens[1:])
    dmax = torch.maximum(dens[:-1], dens[1:])
    dmid = 0.5 * (dmin + dmax)
    cls = torch.arange(S, device=dev)[None, :, None]
    out = torch.empty((5, S, E), dtype=dt, device=dev)
    chunk = chunk or max(1, (1 << 24) // (L * S))
    for e0 in range(0, E, chunk):
        sl = slice(e0, e0 + chunk)
        ov = torch.clamp(torch.minimum(dmax[:, None, sl], hi[None, :, None])
                         - torch.maximum(dmin[:, None, sl],
                                         lo[None, :, None]), min=0.0)
        wsum = ov.sum(1)
        nearest = cls == torch.argmin(
            torch.abs(bins[None, :, None] - dmid[:, None, sl]), 1)[:, None]
        w = torch.where((wsum > 1e-10)[:, None, :],
                        ov / torch.clamp_min(wsum, 1e-30)[:, None, :],
                        nearest.to(dt))
        w = torch.where(lmask[:, None, sl], w, 0.0)
        for k, x in enumerate((udz, vdz, vol, z)):
            out[k, :, sl] = torch.einsum("lse,le->se", w, x[:, sl])
        out[4, :, sl] = w.sum(0)
    return out


def dens_moc_bin_counts(dens, ulevels_elem, nlevels_elem, bins) -> tuple:
    """(active layers, classes in the runs of the layers whose interval is
    wider than 1e-10, layers binned to the nearest class, elements with an
    active layer, span widths) of these inputs, summed over the elements:
    the work ``dens_moc_bin`` does on them.  The span of an element runs
    from the first class any of its active layers sends weight to to the
    last (a run, or the nearest class), ``smax - smin`` classes wide, 0
    for an element without an active layer; span widths is the histogram
    of the elements' widths, a list of S + 1 counts."""
    lmask = _layer_mask(ulevels_elem, nlevels_elem, dens.shape[0] - 1)
    lo, hi = _class_edges(bins)
    S = bins.shape[0]
    dmin = torch.minimum(dens[:-1], dens[1:])
    dmax = torch.maximum(dens[:-1], dens[1:])
    a = torch.searchsorted(hi, dmin.contiguous(), right=True)
    b = torch.searchsorted(lo, dmax.contiguous())
    wide = lmask & (dmax - dmin > 1e-10)
    runs = torch.where(wide, torch.clamp_min(b - a, 0), 0)
    # the nearest class of the layers that take it (none [L, S, E] formed)
    narrow = lmask & ~wide
    nearest = torch.zeros_like(a)
    nearest[narrow] = torch.argmin(torch.abs(
        bins[None, :] - (0.5 * (dmin + dmax))[narrow][:, None]), 1)
    smin = torch.where(lmask, torch.where(wide, a, nearest), S).amin(0)
    smax = torch.where(lmask, torch.where(wide, b, nearest + 1), 0).amax(0)
    width = torch.where(lmask.any(0), smax - smin, 0)
    return (int(lmask.sum()), int(runs.sum()), int(narrow.sum()),
            int(lmask.any(0).sum()),
            torch.bincount(width.cpu(), minlength=S + 1).tolist())


def dens_moc_bin_work(n_elems: int, n_classes: int, itemsize: int,
                      active: int, runs: int, nearest: int, columns: int,
                      with_fer: bool) -> tuple:
    """(bytes, flops) of one ``dens_moc_bin`` call on inputs with the
    counts of ``dens_moc_bin_counts``.  Bytes: what the kernel must read,
    helem, u, v (fer_u, fer_v) and the upper interface density of each
    active layer, one more density row under each of the ``columns``
    elements with an active layer, elem_area and the levels (int32) of
    every element and the classes, once; the five [S, E] outputs written
    once.  Flops: 6 an active layer (8 with the bolus velocities: the
    running depth, zmid, udz, vdz, vol), 13 a class of a layer's run (its
    overlap twice, the weight sum, the weight, four products and five
    sums) and, for a layer binned to the nearest class, S distances and 7
    more."""
    nbytes = ((4 + 2 * int(with_fer)) * active + columns
              + (1 + 5 * n_classes) * n_elems + n_classes) * itemsize \
        + 8 * n_elems
    flops = (8 if with_fer else 6) * active + 13 * runs \
        + (n_classes + 7) * nearest
    return nbytes, flops


def dens_moc_bin(dens, helem, u, v, elem_area, ulevels_elem, nlevels_elem,
                 bins, fer_u=None, fer_v=None) -> torch.Tensor:
    """The density-class binning [5, S, E] (rows ``DMOC_BINNED``) of the
    layer intervals of the interface densities ``dens`` [nl, E], weighted
    by the transports (u + fer_u, v + fer_v) helem, the volume helem *
    elem_area and the mid depth [nl-1, E].  On CUDA tensors one launch of
    ``dens_moc_bin``; on CPU tensors ``dens_moc_bin_plain``."""
    if dens.device.type == "cpu":
        return dens_moc_bin_plain(dens, helem, u, v, elem_area, ulevels_elem,
                                  nlevels_elem, bins, fer_u, fer_v)
    kernels.cuda_only(dens, "dens_moc_bin")
    dev, dt = dens.device, dens.dtype
    nl, E = dens.shape
    S = bins.shape[0]
    if S > 128:
        raise ValueError(f"dens_moc_bin: {S} classes (at most 128)")
    kernels.require(dens, "dens", (nl, E), dt, dev)
    for name, x in (("helem", helem), ("u", u), ("v", v), ("fer_u", fer_u),
                    ("fer_v", fer_v)):
        if x is not None:
            kernels.require(x, name, (nl - 1, E), dt, dev)
    kernels.require(elem_area, "elem_area", (E,), dt, dev)
    kernels.require(ulevels_elem, "ulevels_elem", (E,), torch.int32, dev)
    kernels.require(nlevels_elem, "nlevels_elem", (E,), torch.int32, dev)
    kernels.require(bins, "bins", (S,), dt, dev)
    out = torch.empty((5, S, E), dtype=dt, device=dev)
    kernels.launch("dens_moc_bin", dev, dens, helem, u, v, fer_u, fer_v,
                   elem_area, ulevels_elem, nlevels_elem, bins, out, nl, E, S,
                   kernels.float_code(dt))
    return out


def dens_moc_bin_plan(dtype, n_classes: int) -> dict:
    """The launch ``dens_moc_bin`` makes for ``n_classes`` classes: block,
    classes a chunk, chunks and dynamic shared bytes."""
    import ctypes
    res = (ctypes.c_int * 4)()
    kernels.library().fesom_dens_moc_bin_plan(
        n_classes, kernels.float_code(dtype), ctypes.addressof(res))
    return dict(zip(("block", "chunk", "chunks", "shared_bytes"), res))


def interface_density(state: OceanState, mesh: MeshTables,
                      cfg) -> torch.Tensor:
    """sigma_2 at element interfaces [nl, E]: the element means of
    ``density_dmoc`` interpolated by thickness between layers, extrapolated
    to the surface and to each element's bottom (ref :438-452)."""
    lmask = mesh.elem_layer_mask
    hsafe = torch.where(lmask, state.helem, 1.0)
    dmoc = density_dmoc(state, cfg) - 1000.0                 # [nl-1, N]
    aux = _elem_mean(dmoc, mesh)                             # [nl-1, E]
    inner = (aux[1:] * hsafe[:-1] + aux[:-1] * hsafe[1:]) \
        / (hsafe[:-1] + hsafe[1:])
    top = inner[0] + (inner[0] - inner[1]) * hsafe[0] / hsafe[1]
    dens = torch.cat([top[None], inner, torch.zeros_like(top)[None]], 0)
    nbE = (mesh.nlevels_elem.long() - 1)[None, :]
    lev = torch.arange(mesh.nl, device=dens.device)[:, None]
    d_m1 = torch.gather(dens, 0, torch.clamp_min(nbE - 1, 0))
    d_m2 = torch.gather(dens, 0, torch.clamp_min(nbE - 2, 0))
    h_m1 = torch.gather(hsafe, 0, torch.clamp_min(nbE - 2, 0))
    h_m2 = torch.gather(hsafe, 0, torch.clamp_min(nbE - 3, 0))
    return torch.where(lev == nbE, d_m1 + (d_m1 - d_m2) * h_m1 / h_m2, dens)


def diag_dens_moc(state: OceanState, mesh: MeshTables, cfg,
                  forcing: Optional[Forcing] = None, fer_u=None, fer_v=None,
                  sw_alpha=None, sw_beta=None) -> Dict[str, torch.Tensor]:
    """Density-space MOC binning (ref diag_densMOC :387-632): each
    (element, layer) interval [dmin, dmax] of the interface densities
    deposits transport, volume and depth into the std_dens classes with
    the exact-overlap weights (``dens_moc_bin``).

    Returns the [S, E] fields ``DMOC_BINNED`` (views of one [5, S, E]
    tensor), the classes ``std_dens`` [S] and, with ``forcing`` and
    ``sw_alpha``/``sw_beta`` (their surface row is read), the surface
    buoyancy-flux binning ``std_dens_flux_H``, ``_R``, ``_W`` [S, E]:
    each element's flux in its surface class (ref :476-484)."""
    dt = state.u.dtype
    bins = torch.as_tensor(STD_DENS, device=state.u.device).to(dt)
    dens = interface_density(state, mesh, cfg)
    binned = dens_moc_bin(dens, state.helem, state.u, state.v,
                          mesh.elem_area.to(dt), mesh.ulevels_elem,
                          mesh.nlevels_elem, bins, fer_u, fer_v)
    out = dict(zip(DMOC_BINNED, binned))
    out["std_dens"] = bins
    if forcing is not None and sw_alpha is not None:
        surf_bin = torch.argmin(torch.abs(bins[:, None] - dens[0][None, :]),
                                0)
        area = mesh.elem_area
        hf = _elem_mean(sw_alpha[0] * forcing.heat_flux, mesh) / vcpw * area
        rf = _elem_mean(sw_beta[0] * forcing.relax_salt, mesh) * area
        wf = _elem_mean(sw_beta[0] * forcing.water_flux * state.tr[1, 0],
                        mesh) * area
        flux = torch.zeros((3, bins.shape[0], mesh.n_elems), dtype=dt,
                           device=bins.device)
        flux.scatter_(1, surf_bin.expand(3, 1, -1),
                      torch.stack([hf, rf, wf])[:, None, :])
        out["std_dens_flux_H"], out["std_dens_flux_R"], \
            out["std_dens_flux_W"] = flux
    return out


def salt3d_integral(state: OceanState, mesh: MeshTables) -> torch.Tensor:
    """Global volume integral of salinity, a 0-d tensor (ref
    compute_diagnostics :649-657, integrate_nod gen_support.F90)."""
    vol = torch.where(mesh.node_layer_mask,
                      state.hnode * mesh.areasvol[:-1], 0.0)
    return (state.tr[1] * vol).sum()


def compute_diagnostics(state: OceanState, mesh: MeshTables, cfg,
                        forcing: Forcing) -> Dict[str, torch.Tensor]:
    """Every field the &diag_list flags ask for, in one dict (ref
    compute_diagnostics :635-660; ``fesom2_tpu/core/diagnostics.py:
    261-290``)."""
    out: Dict[str, torch.Tensor] = {}
    d = cfg.diag
    if d.lcurt_stress_surf:
        out["curl_stress_surf"] = curl_stress_surf(forcing, mesh)
    if d.ldiag_curl_vel3:
        out["curl_vel3"] = curl_vel3(state, mesh)
    if d.ldiag_energy:
        out.update(diag_energy(state, mesh, forcing, cfg))
    if d.ldiag_salt3D:
        out["salt3D_int"] = salt3d_integral(state, mesh)
    if d.ldiag_dMOC:
        # the surface row of alpha and beta is all the binning reads
        al, be = eos.sw_alpha_beta(state.tr[0, :1], state.tr[1, :1],
                                   state.Z_3d[:1])
        out.update(diag_dens_moc(state, mesh, cfg, forcing=forcing,
                                 sw_alpha=al, sw_beta=be))
    if d.ldiag_DVD and state.dvd_h.shape[0] >= 2:
        # computed in the tracer step (``model._dvd``); exposed here as
        # streams (ref io_meandata.F90:503-513)
        out["tr_dvd_horiz_T"] = state.dvd_h[0]
        out["tr_dvd_vert_T"] = state.dvd_v[0]
        out["tr_dvd_horiz_S"] = state.dvd_h[1]
        out["tr_dvd_vert_S"] = state.dvd_v[1]
    return out
