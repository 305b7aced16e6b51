"""Mechanical redistribution: ice strength and ridging.

The port of ``fesom2_tpu/ice/icepack/ridge.py``: the physics of
icepack_mechred (Lipscomb et al. 2007) with the reference configuration
kstrength=1 (Rothrock '75), krdg_partic=1 (exponential participation,
astar=0.05), krdg_redist=1 (exponential redistribution, lambda =
mu_rdg*sqrt(h)); driven per dynamics step like ``icedrv_step.F90``
step_dyn_ridge :537-613.

Deviations, as in the JAX package: ridge porosity does not add seawater
volume (solid ice volume is conserved exactly); ridging runs one pass with
a donor-area cap instead of Icepack's iteration-to-convergence.
"""
from __future__ import annotations

import math

import torch

from . import constants as c

gravit = 9.8
fsnowrdg = 0.5          # fraction of snow on ridging ice that survives


def _participation(cfg, aicen):
    """Exponential participation function b(h) ~ exp(-G/astar).

    Returns (apartic0 [N] open-water participation,
    apartic [ncat, N])."""
    ncat = aicen.shape[0]
    aice0 = torch.clamp(1.0 - aicen.sum(0), 0.0, 1.0)
    astar = c.astar_partic
    norm = 1.0 - math.exp(-1.0 / astar)
    G = [aice0]
    for n in range(ncat):
        G.append(G[-1] + aicen[n])
    apartic0 = (1.0 - torch.exp(-G[0] / astar)) / norm
    apartic = torch.stack([
        (torch.exp(-G[n] / astar) - torch.exp(-G[n + 1] / astar)) / norm
        for n in range(ncat)])
    return apartic0, apartic


def _ridge_shapes(cfg, hicen):
    """Per donor category: hrmin, lambda, hrmean, krdg (area factor)."""
    hi = torch.clamp_min(hicen, c.puny)
    hrmin = torch.minimum(2.0 * hi, hi + c.maxraft)
    lam = cfg.mu_rdg * torch.sqrt(hi)
    hrmean = torch.maximum(hrmin + lam, hi * (1.0 + c.puny))
    krdg = hrmean / hi
    return hrmin, lam, hrmean, krdg


def _thick(aicen, vicen):
    return torch.where(aicen > c.puny,
                       vicen / torch.clamp_min(aicen, c.puny), 0.0)


def ice_strength(cfg, aicen, vicen):
    """[N] ice strength P [N/m].  kstrength=1: Rothrock '75 energetics;
    kstrength=0: Hibler '79 P*·h·exp(-C*(1-a))."""
    aice = aicen.sum(0)
    vice = vicen.sum(0)
    if cfg.kstrength == 0:
        return cfg.P_star * vice * torch.exp(-cfg.C_star * (1.0 - aice))

    hicen = _thick(aicen, vicen)
    apartic0, apartic = _participation(cfg, aicen)
    hrmin, lam, hrmean, krdg = _ridge_shapes(cfg, hicen)
    aksum = apartic0 + (apartic * (1.0 - 1.0 / krdg)).sum(0)
    h2rdg = hrmin ** 2 + 2.0 * hrmin * lam + 2.0 * lam ** 2
    Cp = 0.5 * gravit * (c.rhow - c.rhoi) * c.rhoi / c.rhow
    pe = (apartic * (-hicen ** 2 + h2rdg / krdg)).sum(0)
    P = cfg.Cf * Cp * pe / torch.clamp_min(aksum, c.puny)
    return torch.clamp_min(torch.where(aice > c.puny, P, 0.0), 0.0)


def _gain(x, w):
    """sum over donors d of x[d] * w[d] into each receiver: x [d, ..., N]
    (a row or rows per donor), w [d, r, N] -> [r, ..., N]; the sum is
    taken in donor order."""
    out = None
    for d in range(w.shape[0]):
        term = x[d][None] * (w[d] if x.dim() == 2 else w[d][:, None, :])
        out = term if out is None else out + term
    return out


def ridge_ice(cfg, aicen, vicen, vsnon, Tsfcn, qin, qsn,
              rdg_conv, rdg_shear, dt, hin_max, ta=None, tv=None):
    """One ridging pass.  rdg_conv = -min(div,0), rdg_shear =
    0.5*(Delta-|div|), both [N, 1/s] from the rheology.

    Aux tracers: ta [ncat,Ka,N] / tv [ncat,Kv,N] follow the donor losses;
    on the ridged (receiving) portion each tracer is either conserved
    (cfg.ta_ridge_keep / tv_ridge_keep True: FY, iage) or destroyed
    (ponds drain, level ice becomes deformed ice).

    Returns (arrays..., [ta, tv,] dfresh, dfhocn) — snow crushed into the
    ocean; aux stacks appear iff one was passed."""
    had_aux = ta is not None or tv is not None
    ncat = aicen.shape[0]
    nslyr = qsn.shape[1]
    dtype, dev = aicen.dtype, aicen.device

    hicen = _thick(aicen, vicen)
    apartic0, apartic = _participation(cfg, aicen)
    hrmin, lam, hrmean, krdg = _ridge_shapes(cfg, hicen)
    aksum = torch.clamp_min(apartic0 + (apartic * (1.0 - 1.0 / krdg)).sum(0),
                            c.puny)

    closing = torch.clamp_min(c.Cs_shear * rdg_shear + rdg_conv, 0.0)
    rdg = closing * dt / aksum
    # cap: no donor loses more than its area, open water included
    cap = torch.full_like(rdg, 1e30)
    aice0 = torch.clamp(1.0 - aicen.sum(0), 0.0, 1.0)
    cap = torch.where(apartic0 > c.puny,
                      torch.minimum(cap, aice0
                                    / torch.clamp_min(apartic0, c.puny)),
                      cap)
    for n in range(ncat):
        ok = apartic[n] > c.puny
        cap = torch.where(ok, torch.minimum(
            cap, 0.99 * aicen[n] / torch.clamp_min(apartic[n], c.puny)), cap)
    rdg = torch.minimum(rdg, cap)

    # donor losses (simultaneous, from the initial state)
    ardg = apartic * rdg[None, :]                       # [ncat, N]
    ardg = torch.where(aicen > c.puny, ardg, 0.0)
    fa = ardg / torch.clamp_min(aicen, c.puny)          # area fraction lost
    virdg = vicen * fa
    vsrdg = vsnon * fa
    vs_kept = vsrdg * fsnowrdg
    anew = ardg / krdg                                  # ridged area created

    # receiver split matrices [ncat_d, ncat_r, N]
    Hl = torch.tensor(hin_max[:-1], device=dev).to(dtype)[None, :, None]
    Hr = torch.tensor(hin_max[1:], device=dev).to(dtype)[None, :, None]
    hm = hrmin[:, None, :]
    lm = torch.clamp_min(lam[:, None, :], c.puny)

    def E(x):
        return torch.exp(-torch.clamp_min(x - hm, 0.0) / lm)

    a_lo = torch.maximum(Hl, hm)
    a_hi = torch.maximum(Hr, hm)
    farea = E(a_lo) - E(a_hi)
    fvol = ((a_lo + lm) * E(a_lo) - (a_hi + lm) * E(a_hi)) \
        / torch.clamp_min(hrmean[:, None, :], c.puny)
    # top category receives the tail exactly (Hr = 999.9 makes E ~ 0)
    fn = torch.clamp_min(farea.sum(1, keepdim=True), c.puny)
    vn = torch.clamp_min(fvol.sum(1, keepdim=True), c.puny)
    farea = farea / fn
    fvol = fvol / vn

    dA = anew[:, None, :] * farea                       # [d, r, N]
    dV = virdg[:, None, :] * fvol
    dVs = vs_kept[:, None, :] * farea

    gain_a = dA.sum(0)                                  # [ncat_r, N]
    gain_v = dV.sum(0)
    gain_vs = dVs.sum(0)
    keep = 1.0 - fa

    a_new = aicen * keep + gain_a
    v_new = vicen * keep + gain_v
    vs_new = vsnon * keep + gain_vs

    # mix intensive tracers
    q_gain = _gain(qin, dV)
    qin_new = torch.where(v_new[:, None, :] > c.puny,
                          (qin * (vicen * keep)[:, None, :] + q_gain)
                          / torch.clamp_min(v_new[:, None, :], c.puny), qin)
    qs_gain = _gain(qsn, dVs)
    qsn_new = torch.where(vs_new[:, None, :] > c.puny,
                          (qsn * (vsnon * keep)[:, None, :] + qs_gain)
                          / torch.clamp_min(vs_new[:, None, :], c.puny), qsn)
    t_gain = _gain(Tsfcn, dA)
    Tsf_new = torch.where(a_new > c.puny,
                          (Tsfcn * aicen * keep + t_gain)
                          / torch.clamp_min(a_new, c.puny), Tsfcn)

    # snow pushed into the ocean: water + (negative) heat
    vs_lost = (vsrdg - vs_kept).sum(0)
    es_lost = ((qsn * (vsnon / nslyr)[:, None, :]).sum(1)
               * (1.0 - fsnowrdg) * fa).sum(0)
    dfresh = c.rhos * vs_lost / dt
    dfhocn = es_lost / dt

    if not had_aux:
        return (a_new, v_new, vs_new, Tsf_new, qin_new, qsn_new,
                dfresh, dfhocn)

    N = aicen.shape[1]
    if ta is None:
        ta = aicen.new_zeros((ncat, 0, N))
    if tv is None:
        tv = aicen.new_zeros((ncat, 0, N))
    if ta.shape[1]:
        keep_a = torch.tensor([1.0 if k else 0.0 for k in cfg.ta_ridge_keep],
                              dtype=dtype, device=dev)[None, :, None]
        ta_gain = _gain(ta, dA) * keep_a
        ta = torch.where(a_new[:, None, :] > c.puny,
                         (ta * (aicen * keep)[:, None, :] + ta_gain)
                         / torch.clamp_min(a_new[:, None, :], c.puny), ta)
    if tv.shape[1]:
        keep_v = torch.tensor([1.0 if k else 0.0 for k in cfg.tv_ridge_keep],
                              dtype=dtype, device=dev)[None, :, None]
        tv_gain = _gain(tv, dV) * keep_v
        tv = torch.where(v_new[:, None, :] > c.puny,
                         (tv * (vicen * keep)[:, None, :] + tv_gain)
                         / torch.clamp_min(v_new[:, None, :], c.puny), tv)
    return (a_new, v_new, vs_new, Tsf_new, qin_new, qsn_new, ta, tv,
            dfresh, dfhocn)
