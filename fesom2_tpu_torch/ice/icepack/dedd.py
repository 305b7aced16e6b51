"""Delta-Eddington multiple-scattering shortwave for sea ice
(shortwave='dEdd').

The port of ``fesom2_tpu/ice/icepack/dedd.py``.  Reference behavior: the
Icepack delta-Eddington solver selected by ``shortwave='dEdd'`` in
``config/namelist.icepack`` (Briegleb & Light 2007, NCAR/TN-472+STR):

- each ice category is decomposed into snow-covered / ponded / bare
  sub-columns (area fractions from the patchy-snow and pond tracers);
- each sub-column is a stack of homogeneous layers (snow SSL + snow
  interior | pond water | ice SSL + nilyr ice interior layers) with
  3-band inherent optical properties (extinction k, single-scattering
  albedo w, asymmetry g);
- per layer the IOPs are delta-scaled (f = g^2) and the Eddington
  two-stream reflectance/transmittance of the layer is formed
  (Meador & Weaver 1980 diffuse form), then layers are combined with the
  adding method, giving the column albedo, per-layer absorption, and
  transmission to the ocean, all energy-conserving by construction.

The deviations of the JAX package hold here too: all incident shortwave
is treated as diffuse; the IOP table is a compact 3-band representative
of the B&L07/Icepack tables.
"""
from __future__ import annotations

import math

import torch

# 3 bands: visible 0.2-0.7um, near-IR 0.7-1.19um, near-IR 1.19-5um.
# Diffuse spectral fractions of downwelling SW at the surface (B&L07).
BAND_FRAC = (0.481, 0.342, 0.177)

# IOPs per (material, band): extinction k [1/m], single-scatter albedo w,
# asymmetry g.  Representative of the B&L07 tables.
IOPS = {
    # fine-grained dry snow (r~180um): k = 3*rho_s/(2*rho_i*r) ~ 3000/m
    "snow_ssl": dict(k=(3000.0, 3000.0, 3000.0), w=(0.99999, 0.999, 0.985),
                     g=(0.89, 0.89, 0.89)),
    "snow_int": dict(k=(3000.0, 3000.0, 3000.0), w=(0.99997, 0.998, 0.98),
                     g=(0.89, 0.89, 0.89)),
    # granular drained surface layer of bare ice
    "ice_ssl": dict(k=(1000.0, 1000.0, 1100.0), w=(0.999, 0.985, 0.87),
                    g=(0.94, 0.94, 0.94)),
    # interior (congelation) ice: brine/bubble scattering ~ 15-80/m
    "ice_int": dict(k=(15.0, 25.0, 80.0), w=(0.995, 0.94, 0.55),
                    g=(0.94, 0.94, 0.94)),
    # melt-pond water: pure absorber (vis weak, nir strong)
    "pond": dict(k=(0.3, 15.0, 500.0), w=(0.40, 0.0, 0.0),
                 g=(0.0, 0.0, 0.0)),
}

H_SSL_SNOW = 0.040       # snow surface-scattering layer depth [m]
H_SSL_ICE = 0.050        # ice SSL depth [m]
ALB_OCN_BAND = (0.06, 0.06, 0.06)   # under-ice/under-column ocean albedo


def _clip(x, lo, hi):
    return min(max(x, lo), hi)


def _layer_rt(tau, w, g):
    """Delta-scaled Eddington two-stream diffuse reflectance/transmittance
    of one homogeneous layer (Meador & Weaver 1980 eq. 25-26 with the
    Eddington gamma's; delta scaling f=g^2).  ``tau`` a tensor, ``w`` and
    ``g`` numbers (the IOP table's), as in the JAX package, where they are
    weak scalars."""
    f = g * g
    wf = _clip(w * f, 0.0, 0.9999)
    tau_s = (1.0 - wf) * tau
    w_s = _clip((1.0 - f) * w / (1.0 - wf), 0.0, 0.99999)
    g_s = g / (1.0 + g)
    g1 = 0.25 * (7.0 - w_s * (4.0 + 3.0 * g_s))
    g2 = -0.25 * (1.0 - w_s * (4.0 - 3.0 * g_s))
    g2 = max(g2, 1e-8)                  # conservative-scattering guard
    k = math.sqrt(max(g1 * g1 - g2 * g2, 1e-12))
    kt = torch.clamp(k * tau_s, 0.0, 40.0)  # exp overflow guard
    ep, em = torch.exp(kt), torch.exp(-kt)
    D = (k + g1) * ep + (k - g1) * em
    R = g2 * (ep - em) / D
    T = 2.0 * k / D
    return R, T


def _adding_stack(layers, alb_bottom):
    """Combine a top-to-bottom list of (R, T) layers over a bottom boundary
    of reflectance alb_bottom with the adding method.

    Returns (R_top, absorbed [per layer list], T_bottom): the stack albedo,
    the fraction of unit incident flux absorbed in each layer, and the
    fraction transmitted into the bottom boundary."""
    n = len(layers)
    # below-stack reflectance at each interface, bottom-up
    Rb = [None] * (n + 1)
    Rb[n] = alb_bottom
    for i in range(n - 1, -1, -1):
        R, T = layers[i]
        denom = 1.0 - R * Rb[i + 1]
        denom = torch.where(denom > 1e-6, denom, 1e-6)
        Rb[i] = R + T * T * Rb[i + 1] / denom
    # downward/upward diffuse fluxes at interfaces, top-down
    D = [None] * (n + 1)
    U = [None] * (n + 1)
    D[0] = 1.0
    U[0] = Rb[0]
    for i in range(n):
        R, T = layers[i]
        denom = 1.0 - R * Rb[i + 1]
        denom = torch.where(denom > 1e-6, denom, 1e-6)
        D[i + 1] = D[i] * T / denom
        U[i + 1] = D[i + 1] * Rb[i + 1]
    absorbed = []
    for i in range(n):
        a = (D[i] + U[i + 1]) - (D[i + 1] + U[i])
        absorbed.append(torch.clamp_min(a, 0.0))
    return Rb[0], absorbed, D[n] * (1.0 - alb_bottom)


def _column(kind_layers, band):
    """[(material, thickness), ...] -> [(R, T), ...] for one band."""
    out = []
    for mat, h in kind_layers:
        p = IOPS[mat]
        tau = p["k"][band] * torch.clamp_min(h, 0.0)
        out.append(_layer_rt(tau, p["w"][band], p["g"][band]))
    return out


def dedd_shortwave(cfg, hi, hs, Tsf, fsw, apnd=None, hpnd=None):
    """Delta-Eddington shortwave for all categories.

    hi/hs/Tsf [ncat, N]; fsw [N] incoming SW; apnd/hpnd [ncat, N] pond
    area fraction (of the category) and depth, or None.
    Returns (albedo, fswsfc, iabs [ncat, nilyr, N], fswthru) matching the
    ccsm3_shortwave interface: fswsfc = SW absorbed at the surface (SSL +
    snow/pond layers), iabs = SW absorbed per interior ice layer, fswthru
    = SW transmitted to the ocean below the ice."""
    nilyr = cfg.nilyr
    if apnd is None:
        apnd = torch.zeros_like(hi)
        hpnd = torch.zeros_like(hi)
    fsnow = hs / (hs + cfg.snowpatch)              # patchy snow fraction
    fpond = torch.clamp(apnd, 0.0, 1.0) * (1.0 - fsnow)
    fbare = torch.clamp(1.0 - fsnow - fpond, 0.0, 1.0)

    h_ssl_i = torch.clamp_max(0.5 * hi, H_SSL_ICE)
    h_int = torch.clamp_min(hi - h_ssl_i, 0.0) / nilyr
    hs_ssl = torch.clamp_max(0.5 * hs, H_SSL_SNOW)
    hs_int = torch.clamp_min(hs - hs_ssl, 0.0)

    ice_layers = [("ice_ssl", h_ssl_i)] + \
        [("ice_int", h_int) for _ in range(nilyr)]
    stacks = {
        "snow": ([("snow_ssl", hs_ssl), ("snow_int", hs_int)] + ice_layers,
                 fsnow),
        "bare": (ice_layers, fbare),
        "pond": ([("pond", hpnd)] + [("ice_int", hi / nilyr)
                                     for _ in range(nilyr)], fpond),
    }

    albedo = 0.0
    fswsfc = 0.0
    fswthru = 0.0
    iabs = 0.0
    for name, (layers, frac) in stacks.items():
        alb_b = 0.0
        sfc_b = 0.0
        thru_b = 0.0
        il_b = []
        for b in range(3):
            rt = _column(layers, b)
            R0, absorbed, Tb = _adding_stack(rt, ALB_OCN_BAND[b])
            n_sfc = len(layers) - nilyr     # layers above the interior ice
            sfc_abs = sum(absorbed[:n_sfc])
            wb = BAND_FRAC[b]
            alb_b = alb_b + wb * R0
            sfc_b = sfc_b + wb * sfc_abs
            thru_b = thru_b + wb * Tb
            il_b.append([wb * a for a in absorbed[n_sfc:]])
        il = [sum(vals) for vals in zip(*il_b)]       # nilyr entries
        albedo = albedo + frac * alb_b
        fswsfc = fswsfc + frac * sfc_b
        fswthru = fswthru + frac * thru_b
        iabs = iabs + frac * torch.stack(il, 0)       # [nilyr, ncat, N]

    # thin-ice blend toward open water (the dEdd columns assume optically
    # thick ice below the SSL; same arctan ramp as ccsm3)
    fh = torch.clamp_max(torch.arctan(4.0 * hi)
                         / math.atan(4.0 * cfg.ahmax), 1.0)
    alb_ocn = sum(w * a for w, a in zip(BAND_FRAC, ALB_OCN_BAND))
    albedo = fh * albedo + (1.0 - fh) * alb_ocn
    fswthru = fh * fswthru + (1.0 - fh) * (1.0 - alb_ocn)
    fswsfc = fswsfc * fh
    iabs = iabs * fh[None]                       # [nilyr, ncat, N]

    # scale fractions by the incident flux; interface layout [ncat,nilyr,N]
    iabs = torch.movedim(iabs, 0, 1) * fsw
    fswsfc = fsw * fswsfc
    fswthru = fsw * fswthru
    # keep the column budget exact: any residual rounding goes to the sfc
    resid = fsw * (1.0 - albedo) - (fswsfc + iabs.sum(1) + fswthru)
    fswsfc = fswsfc + resid
    return albedo, fswsfc, iabs, fswthru
