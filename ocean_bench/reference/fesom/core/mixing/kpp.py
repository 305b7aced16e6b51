# Frozen copy of fesom2_tpu_torch/core/mixing/kpp.py, lines 1-432 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""FESOM-tuned K-Profile Parameterization (Large et al. 1994) vertical mixing.

The port of ``fesom2_tpu/core/mixing/kpp.py`` (ref
``src/oce_ale_mixing_kpp.F90``: oce_mixing_KPP :240-436, bldepth
:479-661, wscale :664-729, ri_iwmix :732-844, ddmix :857-934, blmix_kpp
:936-1122, enhance :1129-1190).

The column part of ``oce_mixing_kpp`` (interior mixing, boundary-layer
depth, the blmix profile, the enhancement and the combine) runs the
hand-written CUDA kernel ``csrc/kpp_column.cu`` on a CUDA tensor (a
block a tile of node columns staged in shared memory, the levels in
parallel); ``kpp_column_plain`` beside it, the same code in torch, serves
CPU tensors only.  Torch keeps the gathers around it: the
node stress before it, the element mean of the viscosity after it.
"""
from __future__ import annotations

import math
from dataclasses import replace

import torch

from ...constants import g, density_0, vcpw
from ...mesh import MeshTables
from ..ops import column_levels, elem_to_node_mean_flat, take_row
from ..state import OceanState, Forcing
from .. import eos

# constants (ref :48-74, :97-169)
epsilon_kpp = 0.1
vonk = 0.4
conc1 = 5.0
cstar = 10.0
conam, concm, conc2, zetam = 1.257, 8.380, 16.0, -0.2
conas, concs, conc3, zetas = -28.86, 98.96, 16.0, -1.0
cekman, cmonob = 0.7, 1.0
Riinfty = 0.8
minmix = 3.0e-3


def guard_eps(dtype) -> float:
    """Division guard of the KPP formulas: the reference's 1e-40 in f64;
    1e-30 in f32, where 1e-40 is subnormal and would be flushed to zero on
    some devices (every x/(y+eps) guard would then divide by zero)."""
    return 1.0e-40 if torch.finfo(dtype).bits >= 64 else 1.0e-30


def _wscale(zehat, us):
    """Turbulent velocity scales (wm, ws), LMD94 eq. B1, analytic."""
    epsln = guard_eps(zehat.dtype)
    u3 = us ** 3
    zeta = zehat / (u3 + epsln)
    stable_wm = vonk * us / (1.0 + conc1 * zeta)
    wm_uns = torch.where(zeta > zetam,
                         vonk * us * torch.abs(1.0 - conc2 * zeta) ** 0.25,
                         vonk * torch.abs(conam * u3 - concm * zehat)
                         ** (1.0 / 3.0))
    ws_uns = torch.where(zeta > zetas,
                         vonk * us * torch.sqrt(torch.abs(1.0 - conc3 * zeta)),
                         vonk * torch.abs(conas * u3 - concs * zehat)
                         ** (1.0 / 3.0))
    wm = torch.where(zehat >= 0.0, stable_wm, wm_uns)
    ws = torch.where(zehat >= 0.0, stable_wm, ws_uns)
    return wm, ws


def _edge_copy(x, nln):
    """Row 0 <- row 1 and the bottom interface nln-1 <- nln-2."""
    x = torch.cat([x[1:2], x[1:]], 0)
    lev = torch.arange(x.shape[0], device=x.device)[:, None]
    return torch.where(lev == (nln - 1)[None, :], take_row(x, nln - 2)[None],
                       x)


def _ri_iwmix(unode, vnode, bvfreq, Z_3d, nln, cfg):
    """Interior mixing from local shear instability (ref :732-844):
    (viscA, diffK) [nl, N]."""
    epsln = guard_eps(unode.dtype)
    dz = Z_3d[:-1] - Z_3d[1:]
    dz_inv = 1.0 / torch.where(dz == 0, 1.0, dz)
    du = (unode[:-1] - unode[1:]) * dz_inv
    dv = (vnode[:-1] - vnode[1:]) * dz_inv
    shear = du * du + dv * dv
    Ri = torch.clamp_min(bvfreq[1:-1], 0.0) / (shear + epsln)
    ratio = torch.clamp_max(torch.clamp_min(Ri, 0.0) / Riinfty, 1.0)
    frit = (1.0 - ratio * ratio) ** 3
    zero = torch.zeros_like(unode[:1])
    viscA = torch.cat([zero, cfg.dyn.visc_sh_limit * frit + cfg.dyn.A_ver,
                       zero], 0)
    diffK = torch.cat([zero, cfg.tra.diff_sh_limit * frit + cfg.tra.K_ver,
                       zero], 0)
    lev = torch.arange(viscA.shape[0], device=unode.device)[:, None]
    imask = lev <= (nln - 1)[None, :]
    return (torch.where(imask, _edge_copy(viscA, nln), 0.0),
            torch.where(imask, _edge_copy(diffK, nln), 0.0))


def _ddmix(diffK, alpha, beta, T, S, nln):
    """Double-diffusive interior mixing (ref ddmix :857-934): salt
    fingering and diffusive convection (LMD94 eqns. 31-34) from the
    vertical differences across each interface, as the JAX package's
    deliberate deviation from the reference's absolute-value form
    (``fesom2_tpu/core/mixing/kpp.py:96-107``).  Returns (diffK_T, diffK_S)."""
    Rrho0 = 1.9
    dsfmax = 1.0e-4
    visc_mol = 1.5e-6
    nl = diffK.shape[0]
    lev = torch.arange(nl, device=diffK.device)[:, None]
    zero = torch.zeros_like(T[:1])
    aDT = torch.cat([zero, alpha[:-1] * (T[:-1] - T[1:]), zero], 0)
    bDS = torch.cat([zero, beta[:-1] * (S[:-1] - S[1:]), zero], 0)

    finger = (aDT > bDS) & (bDS > 0.0)
    Rrho_f = torch.clamp_max(aDT / torch.where(bDS == 0, 1.0, bDS), Rrho0)
    dd = 1.0 - (Rrho_f - 1.0) / (Rrho0 - 1.0)
    dd = dsfmax * dd * dd * dd
    addT = torch.where(finger, 0.7 * dd, 0.0)
    addS = torch.where(finger, dd, 0.0)

    dconv = (aDT < 0.0) & (aDT > bDS)
    Rrho_d = aDT / torch.where(bDS == 0, 1.0, bDS)
    Rsafe = torch.where(dconv, Rrho_d, 1.0)
    ddc = visc_mol * 0.909 * torch.exp(
        4.6 * torch.exp(-0.54 * (1.0 / Rsafe - 1.0)))
    prandtl = torch.where(Rsafe > 0.5, (1.85 - 0.85 / Rsafe) * Rsafe,
                          0.15 * Rsafe)
    addT = addT + torch.where(dconv, ddc, 0.0)
    addS = addS + torch.where(dconv, prandtl * ddc, 0.0)

    interior = (lev >= 1) & (lev <= (nln - 2)[None, :])
    diffT = diffK + torch.where(interior, addT, 0.0)
    diffS = diffK + torch.where(interior, addS, 0.0)
    return _edge_copy(diffT, nln), _edge_copy(diffS, nln)


def kpp_constants(cfg):
    """(Vtc, cg) of bldepth and blmix, from the configuration."""
    Vtc = cfg.dyn.concv * math.sqrt(0.2 / concs / epsilon_kpp) / vonk ** 2 \
        / cfg.dyn.Ricr
    cg = cstar * vonk * (concs * vonk * epsilon_kpp) ** (1.0 / 3.0)
    return Vtc, cg


def kpp_column_plain(unode, vnode, bvfreq, dbsfc, zbar_3d, Z_3d, hnode,
                     ustar, Bo, coriolis_node, nlevels_node, cfg,
                     double_diffusion: bool = False, alpha=None, beta=None,
                     T=None, S=None):
    """The column part of KPP (ref :240-414): returns (viscA, Kv, Kv_s,
    kpp_nonloc), all [nl, N]; Kv_s is None without double diffusion, which
    needs alpha, beta, T and S [nl-1, N]."""
    epsln = guard_eps(unode.dtype)
    nl = zbar_3d.shape[0]
    nln = nlevels_node.long()
    lev = torch.arange(nl, device=unode.device)[:, None]
    lmask_lvl = lev <= (nln - 1)[None, :]
    Ricr = cfg.dyn.Ricr
    Vtc, cg = kpp_constants(cfg)

    # ---- surface-referenced shear dVsq [nl, N] (ref :267-315) -----------
    u_i = torch.cat([unode[:1], 0.5 * (unode[:-1] + unode[1:]), unode[-1:]],
                    0)
    v_i = torch.cat([vnode[:1], 0.5 * (vnode[:-1] + vnode[1:]), vnode[-1:]],
                    0)
    dVsq = (unode[0][None, :] - u_i) ** 2 + (vnode[0][None, :] - v_i) ** 2
    dVsq = torch.cat([torch.zeros_like(dVsq[:1]), dVsq[1:]], 0)
    dVsq = torch.where(lev == (nln - 1)[None, :], take_row(dVsq, nln - 2)[None],
                       dVsq)

    # ---- interior mixing -------------------------------------------------
    viscA, diffK = _ri_iwmix(unode, vnode, bvfreq, Z_3d, nln, cfg)
    if double_diffusion:
        diffK, diffS = _ddmix(diffK, alpha, beta, T, S, nln)
    else:
        diffS = diffK

    # ---- bldepth (ref :479-661) ------------------------------------------
    zb = torch.abs(zbar_3d)
    bfsfc = Bo
    stable = 0.5 + 0.5 * torch.sign(bfsfc)
    sigma0 = stable + (1.0 - stable) * epsilon_kpp
    zehat = vonk * sigma0[None, :] * zb * bfsfc[None, :]
    _, ws_all = _wscale(zehat, ustar[None, :])
    Vtsq = zb * ws_all * torch.sqrt(torch.abs(bvfreq)) * Vtc
    Ritop = zb * dbsfc
    Rib = Ritop / (dVsq + Vtsq + epsln)
    valid = (lev >= 1) & lmask_lvl
    exceed = (Rib > Ricr) & valid
    has = exceed.any(0)
    kbl = torch.where(has, torch.argmax(exceed.to(torch.uint8), 0), nln - 1)
    Rib_k = take_row(Rib, kbl)
    Rib_km1 = take_row(torch.cat([torch.zeros_like(Rib[:1]), Rib[:-1]], 0), kbl)
    Rib_km1 = torch.where(kbl == 1, 0.0, Rib_km1)
    zk = take_row(zb, kbl)
    zkm1 = take_row(zb, torch.clamp_min(kbl - 1, 0))
    hbl_interp = zkm1 + (zk - zkm1) * (Ricr - Rib_km1) \
        / (Rib_k - Rib_km1 + epsln)
    hbl = torch.where(has, hbl_interp, take_row(zb, nln - 1))

    # Ekman / Monin-Obukhov limits (ref :594-604)
    hekman = cekman * ustar / torch.clamp_min(torch.abs(coriolis_node), epsln)
    hmonob = cmonob * ustar ** 3 / vonk / (bfsfc + epsln)
    hlimit = stable * torch.minimum(hekman, hmonob)
    lim = bfsfc > 0.0
    hbl = torch.where(lim, torch.minimum(hbl, hlimit), hbl)
    hbl = torch.where(lim, torch.maximum(hbl, zb[1]), hbl)

    # new kbl: first level with |zbar| > hbl (ref :615-625)
    deeper = (zb > hbl[None, :]) & valid
    kbl = torch.where(deeper.any(0), torch.argmax(deeper.to(torch.uint8), 0),
                      nln - 1)
    dzup_k = take_row(zb, kbl) - take_row(zb, torch.clamp_min(kbl - 1, 0))
    caseA = 0.5 + 0.5 * torch.sign(take_row(zb, kbl) - 0.5 * dzup_k - hbl)

    # ---- blmix (ref :936-1122) -------------------------------------------
    h = torch.where(lev[:-1] < (nln - 1)[None, :], hnode, 0.0)
    dthick = torch.cat([0.5 * h[:1], 0.5 * (h[:-1] + h[1:]),
                        torch.zeros_like(h[:1])], 0)
    botth = 0.5 * take_row(h, torch.clamp_min(nln - 2, 0))
    dthick = torch.where(lev == (nln - 1)[None, :], botth[None, :], dthick)
    dthick = torch.clamp_min(dthick, 1e-12)

    sigma_h = stable + (1.0 - stable) * epsilon_kpp
    zehat_h = vonk * sigma_h * hbl * bfsfc
    wm_h, ws_h = _wscale(zehat_h, ustar)

    kn = torch.where(caseA > 0.5, kbl - 1, kbl)
    kn = torch.minimum(kn, nln - 2)
    knm1 = torch.clamp_min(kn - 1, 0)
    knp1 = torch.minimum(kn + 1, nln - 1)

    Z3abs = torch.abs(Z_3d)
    Z3abs_full = torch.cat([Z3abs, Z3abs[-1:]], 0)
    delhat = take_row(Z3abs_full, kn) - hbl
    R = 1.0 - delhat / take_row(dthick, kn)

    def interp_interior(col):
        dvdzup = (take_row(col, knm1) - take_row(col, kn)) / take_row(dthick, kn)
        dvdzdn = (take_row(col, kn) - take_row(col, knp1)) / take_row(dthick, knp1)
        p = 0.5 * ((1.0 - R) * (dvdzup + torch.abs(dvdzup))
                   + R * (dvdzdn + torch.abs(dvdzdn)))
        return p, take_row(col, kn) + p * delhat

    viscp, visch = interp_interior(viscA)
    diftp, difth = interp_interior(diffK)
    if double_diffusion:
        difsp, difsh = interp_interior(diffS)

    f1 = stable * conc1 * bfsfc / (ustar ** 4 + epsln)
    gat1m = visch / (hbl + epsln) / (wm_h + epsln)
    dat1m = torch.clamp_max(-viscp / (wm_h + epsln) + f1 * visch, 0.0)
    gat1t = difth / (hbl + epsln) / (ws_h + epsln)
    dat1t = torch.clamp_max(-diftp / (ws_h + epsln) + f1 * difth, 0.0)
    if double_diffusion:
        gat1s = difsh / (hbl + epsln) / (ws_h + epsln)
        dat1s = torch.clamp_max(-difsp / (ws_h + epsln) + f1 * difsh, 0.0)

    # shape functions on all interfaces, masked to nz < kbl
    sig_full = Z3abs_full / (hbl[None, :] + epsln)
    sigma_i = stable[None, :] * sig_full \
        + (1.0 - stable[None, :]) * torch.clamp_max(sig_full, epsilon_kpp)
    zehat_i = vonk * sigma_i * hbl[None, :] * bfsfc[None, :]
    wm_i, ws_i = _wscale(zehat_i, ustar[None, :])
    a1 = sig_full - 2.0
    a2 = 3.0 - 2.0 * sig_full
    a3 = sig_full - 1.0
    in_bl = (lev >= 1) & (lev < kbl[None, :]) & lmask_lvl

    def blmc(w_i, gat1, dat1):
        G = a1 + a2 * gat1[None, :] + a3 * dat1[None, :]
        return torch.where(in_bl, hbl * w_i * sig_full * (1.0 + sig_full * G),
                           0.0)
    blmc_m = blmc(wm_i, gat1m, dat1m)
    blmc_t = blmc(ws_i, gat1t, dat1t)
    if double_diffusion:
        blmc_s = blmc(ws_i, gat1s, dat1s)
    ghats = torch.where(in_bl, (1.0 - stable[None, :]) * cg
                        / (ws_i * hbl[None, :] + epsln), 0.0)

    # dkm1: diffusivities at level kbl-1 (ref :1087-1110)
    sig_k = take_row(zb, torch.clamp_min(kbl - 1, 0)) / (hbl + epsln)
    sigma_k = stable * sig_k + (1.0 - stable) * torch.clamp_max(sig_k,
                                                                epsilon_kpp)
    zehat_k = vonk * sigma_k * hbl * bfsfc
    wm_k, ws_k = _wscale(zehat_k, ustar)
    a1k, a2k, a3k = sig_k - 2.0, 3.0 - 2.0 * sig_k, sig_k - 1.0

    def dkm1(w_k, gat1, dat1):
        G = a1k + a2k * gat1 + a3k * dat1
        return hbl * w_k * sig_k * (1.0 + sig_k * G)

    # ---- enhance at k = kbl-1 (ref :1129-1190) ---------------------------
    k_enh = torch.clamp_min(kbl - 1, 0)
    zk0 = take_row(zbar_3d, k_enh)
    zk1 = take_row(zbar_3d, torch.clamp_max(k_enh + 1, nl - 1))
    delta = (hbl + zk0) / torch.where(zk0 - zk1 == 0, 1.0, zk0 - zk1)
    one_hot = lev == k_enh[None, :]

    def enhanced(interior, bl, dkm1v):
        at_k = take_row(interior, k_enh)
        dkmp5 = caseA * at_k + (1.0 - caseA) * take_row(bl, k_enh)
        dstar = (1.0 - delta) ** 2 * dkm1v + delta ** 2 * dkmp5
        newv = (1.0 - delta) * at_k + delta * dstar
        return torch.where(one_hot, newv[None, :], bl)

    blmc_m = enhanced(viscA, blmc_m, dkm1(wm_k, gat1m, dat1m))
    blmc_t = enhanced(diffK, blmc_t, dkm1(ws_k, gat1t, dat1t))
    ghats = torch.where(one_hot, (1.0 - caseA)[None, :] * ghats, ghats)

    # ---- combine (ref :393-414) ------------------------------------------
    Kv = torch.where(in_bl, torch.maximum(diffK, blmc_t), diffK)
    Kv = torch.where(lmask_lvl, Kv, 0.0)
    Kv_s = None
    if double_diffusion:
        blmc_s = enhanced(diffS, blmc_s, dkm1(ws_k, gat1s, dat1s))
        Kv_s = torch.where(in_bl, torch.maximum(diffS, blmc_s), diffS)
        Kv_s = torch.where(lmask_lvl, Kv_s, 0.0)
    viscA = torch.where(in_bl, torch.maximum(viscA, blmc_m), viscA)

    # nonlocal transport coefficient min(ghats*blmc, 1), zero at the
    # surface and bottom interfaces (ref oce_ale_tracer.F90:688-781)
    nonloc = torch.clamp_max(ghats * blmc_t, 1.0)
    nonloc = torch.where((lev >= 1) & (lev < (nln - 1)[None, :]), nonloc, 0.0)
    return viscA, Kv, Kv_s, nonloc


def kpp_column_work(nl: int, n_nodes: int, wet_cells: int,
                    double_diffusion: bool, itemsize: int) -> tuple:
    """(bytes, flops) of one call on columns of ``nl`` levels of which
    ``wet_cells`` layers are wet (a column ends at its bottom, so these
    inputs need no more): the 4 layer fields (8 with double diffusion)
    and the 3 interface fields read on the wet cells, ustar, Bo, the
    Coriolis parameter and ``nlevels_node`` [N], and the 3 outputs (4
    with double diffusion) [nl, N] written whole.  About 200 flops per
    wet cell (bulk Richardson number, both velocity scales with their
    roots, interior mixing, the matching polynomials), 60 more with
    double diffusion."""
    fields = (8 if double_diffusion else 4) + 3
    outs = 4 if double_diffusion else 3
    nbytes = (fields * wet_cells + 3 * n_nodes + outs * nl * n_nodes) \
        * itemsize + 4 * n_nodes
    return nbytes, (260 if double_diffusion else 200) * wet_cells


def kpp_column(unode, vnode, bvfreq, dbsfc, zbar_3d, Z_3d, hnode, ustar, Bo,
               coriolis_node, nlevels_node, cfg,
               double_diffusion: bool = False, alpha=None, beta=None, T=None,
               S=None):
    """``kpp_column_plain`` on a CPU tensor; on a CUDA tensor the kernel
    ``csrc/kpp_column.cu`` or a raise.  Columns hold at least one wet
    layer (``nlevels_node >= 2``)."""
    return kpp_column_plain(unode, vnode, bvfreq, dbsfc, zbar_3d, Z_3d,
                            hnode, ustar, Bo, coriolis_node, nlevels_node,
                            cfg, double_diffusion, alpha, beta, T, S)


def _node_stress(forcing: Forcing, mesh: MeshTables):
    """Squared stress magnitude averaged from elements to nodes."""
    sxy = elem_to_node_mean_flat(
        torch.stack([forcing.stress_x, forcing.stress_y]), mesh)
    return sxy[0] ** 2 + sxy[1] ** 2


def column_inputs(state: OceanState, mesh: MeshTables, cfg,
                  forcing: Forcing):
    """The arguments of ``kpp_column`` / ``kpp_column_plain`` for this
    state: the surface friction velocity from the node stress, the surface
    buoyancy forcing Bo (ref :341-351), and with double diffusion the
    expansion coefficients of every layer."""
    dd = bool(getattr(cfg.tra, "double_diffusion", False))
    T, S = state.tr[0], state.tr[1]
    if dd:
        alpha, beta = eos.sw_alpha_beta(T, S, state.Z_3d)
        a0, b0 = alpha[0], beta[0]
    else:
        # the surface row is all the buoyancy forcing needs
        alpha = beta = None
        a0, b0 = eos.sw_alpha_beta(T[0], S[0], state.Z_3d[0])
    ustar = torch.sqrt(torch.sqrt(_node_stress(forcing, mesh)) / density_0)
    Bo = -g * (a0 * forcing.heat_flux / vcpw
               + b0 * forcing.water_flux * S[0])
    return (state.unode, state.vnode, state.bvfreq, state.dbsfc,
            state.zbar_3d, state.Z_3d, state.hnode, ustar, Bo,
            mesh.coriolis_node, column_levels(mesh), cfg, dd, alpha, beta,
            T if dd else None, S if dd else None)


def oce_mixing_kpp(state: OceanState, mesh: MeshTables, cfg,
                   forcing: Forcing) -> OceanState:
    """Full KPP: interior Ri mixing, boundary-layer profile and
    enhancement; Av on elements with its surface floor (ref :418-424)."""
    viscA, Kv, Kv_s, nonloc = kpp_column(*column_inputs(state, mesh, cfg,
                                                        forcing))
    Av_e = viscA[:, mesh.elem_nodes].mean(-1)
    lev = torch.arange(mesh.nl, device=Av_e.device)[:, None]
    Av_e = torch.where(lev <= (mesh.nlevels_elem - 1)[None, :], Av_e, 0.0)
    Av_e = torch.cat([torch.clamp_min(Av_e[:1], minmix), Av_e[1:]], 0)
    out = replace(state, Av=Av_e, Kv=Kv, kpp_nonloc=nonloc)
    if Kv_s is not None:
        out = replace(out, Kv_s=Kv_s)
    return out
