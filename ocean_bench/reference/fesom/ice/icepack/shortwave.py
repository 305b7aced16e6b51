# Frozen copy of fesom2_tpu_torch/ice/icepack/shortwave.py, lines 1-53 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""CCSM3 albedo and shortwave absorption (shortwave='ccsm3',
albedo_type='ccsm3', config/namelist.icepack:55-70).

The port of ``fesom2_tpu/ice/icepack/shortwave.py``.  Computes, per
category: broadband albedo, SW absorbed at the surface, SW absorbed inside
each ice layer (Beer's law for the penetrating visible fraction), and SW
transmitted to the ocean.
"""
from __future__ import annotations

import math

import torch


def ccsm3_shortwave(cfg, hi, hs, Tsf, fsw):
    """All inputs broadcastable to [ncat, N]; fsw is incoming SW [W/m^2].

    Returns (albedo, fswsfc, iabs [ncat, nilyr, N], fswthru)."""
    nilyr = cfg.nilyr
    fh = torch.clamp_max(torch.arctan(4.0 * hi)
                         / math.atan(4.0 * cfg.ahmax), 1.0)

    albiv = cfg.albicev * fh + cfg.albocn * (1.0 - fh)
    albin = cfg.albicei * fh + cfg.albocn * (1.0 - fh)
    albsv = torch.full_like(hi, cfg.albsnowv)
    albsn = torch.full_like(hi, cfg.albsnowi)

    # near-melt reduction over the last dT_mlt degrees
    warm = torch.clamp((Tsf + cfg.dT_mlt) / cfg.dT_mlt, 0.0, 1.0)
    albiv = albiv + cfg.dalb_mlt * warm * fh
    albin = albin + cfg.dalb_mlt * warm * fh
    albsv = albsv + cfg.dalb_mltv * warm
    albsn = albsn + cfg.dalb_mlti * warm

    fsnow = hs / (hs + cfg.snowpatch)
    albv = albiv * (1.0 - fsnow) + albsv * fsnow
    albn = albin * (1.0 - fsnow) + albsn * fsnow
    albedo = cfg.frac_vis * albv + (1.0 - cfg.frac_vis) * albn

    avis = cfg.frac_vis * fsw * (1.0 - albv)
    anir = (1.0 - cfg.frac_vis) * fsw * (1.0 - albn)

    # visible light penetrates bare ice only
    fswpen = avis * cfg.i0vis * (1.0 - fsnow)
    fswsfc = avis + anir - fswpen

    # Beer's-law absorption per layer
    z = torch.arange(nilyr + 1, dtype=hi.dtype, device=hi.device) / nilyr
    trans = torch.exp(-cfg.kappav * z[None, :, None] * hi[:, None, :])
    iabs = fswpen[:, None, :] * (trans[:, :-1, :] - trans[:, 1:, :])
    fswthru = fswpen * trans[:, -1, :]
    return albedo, fswsfc, iabs, fswthru
