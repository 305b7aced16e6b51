# Frozen copy of fesom2_tpu_torch/ice/icepack/fsd.py, lines 1-169 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""Floe size distribution (FSD) tracers.

The port of ``fesom2_tpu/ice/icepack/fsd.py``.  Reference behavior: the
optional FSD tracer family of the Icepack library, whose hooks the
reference driver declares (``src/icepack_drivers/icedrv_main.F90:49``
nfsd, ``:677-697``), after Roach et al. 2018 and Horvat & Tziperman 2015.

Per thickness category n, ``afsd[k]`` is the fraction of the category's
area occupied by floes whose radius falls in size bin k; ``sum_k afsd = 1``
wherever the category has ice.  The bins ride the generic area-weighted
aux-tracer machinery (state.IcepackConfig.area_tracers).  Column
processes: new ice (through ponds.dilute_on_new_ice), radial growth and
lateral melt (an upwind flux between adjacent bins plus the perimeter area
term), welding (binned Smoluchowski coagulation with a constant kernel),
and the feedback of the mean inverse diameter on the lateral-melt closure.
"""
from __future__ import annotations

import numpy as np
import torch

from . import constants as c

# Icepack's standard 12-category floe radius boundaries [m] (lims of
# icepack_fsd::icepack_init_fsd_bounds; Roach et al. 2018 sec. 2.2)
FSD_BOUNDS_12 = np.array([
    6.65000000e-02, 5.31030847e+00, 1.42865861e+01, 2.90576686e+01,
    5.24122136e+01, 8.78691405e+01, 1.39518470e+02, 2.11635752e+02,
    3.08037274e+02, 4.31203059e+02, 5.81277225e+02, 7.55141047e+02,
    9.45812834e+02])


def fsd_bounds(nfsd: int) -> np.ndarray:
    """Floe radius bin boundaries [m], nfsd+1 values."""
    if nfsd == 12:
        return FSD_BOUNDS_12.copy()
    # other bin counts: geometric spacing over the same span
    return np.geomspace(FSD_BOUNDS_12[0], FSD_BOUNDS_12[-1], nfsd + 1)


def fsd_centers(lims: np.ndarray) -> np.ndarray:
    return 0.5 * (lims[1:] + lims[:-1])


def fsd_widths(lims: np.ndarray) -> np.ndarray:
    return lims[1:] - lims[:-1]


def _row(values, like) -> torch.Tensor:
    """A [1, nfsd, 1] tensor of ``values`` in ``like``'s dtype."""
    return torch.as_tensor(values, device=like.device).to(like.dtype)[
        None, :, None]


def afsd_normalize(afsd, aicen):
    """Renormalize so sum_k afsd = 1 where the category has ice, 0 where
    not.  afsd [ncat, nfsd, N], aicen [ncat, N]."""
    afsd = torch.clamp_min(afsd, 0.0)
    s = afsd.sum(1, keepdim=True)
    has = (aicen > c.puny)[:, None, :]
    # ice present but empty distribution (fresh start): all area in the
    # largest bin, the quiescent new-ice convention
    fallback = torch.zeros_like(afsd)
    fallback[:, -1] = 1.0
    out = torch.where(s > c.puny, afsd / torch.clamp_min(s, c.puny),
                      fallback)
    return torch.where(has, out, 0.0)


def fsd_radial_evolve(afsd, dr, lims):
    """Advect the distribution in floe-size space by a radial change dr
    (positive growth, negative melt) over the step.

    afsd [ncat, nfsd, N]; dr [ncat, N] (metres of radius change).
    Upwind transfer between adjacent bins (fraction |dr|/width of the
    donor bin crosses the boundary) plus the within-bin perimeter area
    term f <- f*(1 + 2 dr/r) (Roach et al. 2018 eq. 2).  The result is
    renormalized by the caller."""
    w = _row(fsd_widths(lims), afsd)
    r = _row(fsd_centers(lims), afsd)
    drx = dr[:, None, :]                                       # [ncat,1,N]
    move = torch.clamp(drx / w, -1.0, 1.0)
    up = torch.clamp_min(move, 0.0)      # toward larger floes
    dn = torch.clamp_min(-move, 0.0)     # toward smaller floes
    out = afsd * (1.0 - up) * (1.0 - dn)
    # gain from the smaller neighbor (growth) and larger neighbor (melt);
    # the largest bin retains its outgoing growth flux, the smallest its
    # outgoing melt flux (true area loss is rside's job)
    fu, fd = afsd * up, afsd * dn
    gain_up = torch.cat([torch.zeros_like(afsd[:, :1]), fu[:, :-1]], 1)
    gain_dn = torch.cat([fd[:, 1:], torch.zeros_like(afsd[:, :1])], 1)
    keep_top = torch.cat([torch.zeros_like(fu[:, :-1]), fu[:, -1:]], 1)
    keep_bot = torch.cat([fd[:, :1], torch.zeros_like(fd[:, 1:])], 1)
    out = out + gain_up + gain_dn + keep_top + keep_bot
    # perimeter area term
    out = out * torch.clamp_min(1.0 + 2.0 * drx / r, 0.0)
    return torch.clamp_min(out, 0.0)


def _weld_targets(lims: np.ndarray) -> np.ndarray:
    """T[i,j]: bin index receiving the floe formed by welding a bin-i and a
    bin-j floe (area-conserving merge: r_new = sqrt(ri^2 + rj^2))."""
    r = fsd_centers(lims)
    rn = np.sqrt(r[:, None] ** 2 + r[None, :] ** 2)
    return np.clip(np.searchsorted(lims, rn, side="right") - 1,
                   0, len(r) - 1)


def fsd_weld(afsd, aicen, freezing, dt, kweld, lims):
    """Floe welding (Roach et al. 2018b): in freezing conditions floes in
    contact merge.  Ordered-pair Smoluchowski step with constant kernel:
    a fraction dt*kweld*aice*afsd_j of bin i's area welds onto bin-j floes
    and lands in the merged bin T[i,j]; every bin loses at rate
    dt*kweld*aice (times its content) and the total is conserved."""
    nfsd = afsd.shape[1]
    T = _weld_targets(lims)
    onehot = torch.as_tensor(np.eye(nfsd)[T], device=afsd.device).to(
        afsd.dtype)                                         # [i, j, k]
    rate = torch.clamp(dt * kweld * aicen, 0.0, 0.5) \
        * freezing.to(afsd.dtype)                           # [ncat, N]
    tot = afsd.sum(1, keepdim=True)                         # [ncat, 1, N]
    loss = afsd * tot * rate[:, None, :]                    # [ncat, i, N]
    # gain_k = sum_i afsd_i * (onehot[i]^T @ afsd)_k, bin by bin
    gain = torch.zeros_like(afsd)
    for i in range(nfsd):
        redist = torch.einsum("jk,cjn->ckn", onehot[i], afsd)
        gain = gain + afsd[:, i, None, :] * redist
    gain = gain * rate[:, None, :]
    return torch.clamp_min(afsd - loss + gain, 0.0)


def fsd_lateral_melt_scale(afsd, lims, floediam=None):
    """Per-category multiplier on the Steele (1992) rside: the FSD's
    area-weighted mean inverse diameter over the constant-floediam
    assumption.  scale = floediam * sum_k afsd_k / (2 r_k)."""
    if floediam is None:
        floediam = c.floediam
    r = _row(fsd_centers(lims), afsd)
    inv_d = (afsd / (2.0 * r)).sum(1)                       # [ncat, N]
    s = afsd.sum(1)
    # empty distribution -> neutral scale 1
    return torch.where(s > c.puny,
                       floediam * inv_d / torch.clamp_min(s, c.puny), 1.0)


def fsd_mean_radius(afsd, aicen, lims):
    """Aggregate area-weighted mean floe radius [m] (history field
    fsdrad of the reference driver's FSD output)."""
    r = _row(fsd_centers(lims), afsd)
    num = (aicen[:, None, :] * afsd * r).sum((0, 1))
    den = (aicen[:, None, :] * afsd).sum((0, 1))
    return torch.where(den > c.puny, num / torch.clamp_min(den, c.puny),
                       0.0)


def fsd_radial_growth_rate(ipc, afsd, aicen, vicen, dvfraz, dt, lims):
    """Radial growth dr [m per step] of existing floes in freezing
    conditions, from the frazil production rate: the new-ice volume grows
    laterally on the existing floe perimeter (Horvat & Tziperman 2015
    lead-region closure, collapsed to its perimeter scaling), capped at
    half the smallest bin width per step."""
    r = _row(fsd_centers(lims), afsd)
    P = (2.0 * afsd / r).sum(1)                             # [ncat, N]
    hi = torch.where(aicen > c.puny,
                     vicen / torch.clamp_min(aicen, c.puny), 0.0)
    dr = dvfraz[None, :] * dt / torch.clamp_min(hi * P, c.puny)
    wmin = float(fsd_widths(lims).min())
    dr = torch.clamp(dr, 0.0, 0.5 * wmin)
    return torch.where((aicen > c.puny) & (dvfraz[None, :] > 0.0), dr, 0.0)
