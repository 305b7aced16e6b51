"""Skeletal-layer sea-ice biogeochemistry (skl_bgc).

The port of ``fesom2_tpu/ice/icepack/bgc.py``.  Reference behavior: the
skeletal-layer BGC option of the Icepack library, whose hooks the
reference driver declares (``src/icepack_drivers/icedrv_main.F90:61-62``,
``:395``, ``:557``, ``:668``), after Arrigo et al. 1993 and the Icepack
skl_bgc description.  Three tracers per category in the area-weighted aux
stack (skeletal-layer concentrations, mmol/m^3): ice algae (as nitrogen),
nitrate and silicate; photosynthesis limited by light (the transmitted
shortwave) and nutrients, uptake, mortality and remineralization, and
exchange with a prescribed mixed layer through a piston velocity.
"""
from __future__ import annotations

import torch

from . import constants as c

# tracer storage order within the ta block
BGC_NAMES = ("bgc_N", "bgc_NO3", "bgc_Sil")
N_BGC = len(BGC_NAMES)

sk_l = 0.03          # skeletal layer thickness [m]
pv_mol = 1.0e-6      # background molecular piston velocity [m/s]
pv_grow = 1.44       # piston velocity per unit interface speed (growth)
pv_melt = 1.0        # ... (melt; full flushing of the retreating layer)


def bgc_defaults(ipc):
    """New-ice / initial skeletal concentrations [mmol/m^3]."""
    return {"bgc_N": ipc.bgc_N_seed, "bgc_NO3": ipc.bgc_NO3_ocn,
            "bgc_Sil": ipc.bgc_Sil_ocn}


def skl_bgc_step(ipc, algN, NO3, Sil, aicen, vicen, fswthru, dhi_dt,
                 T_bot, dt):
    """Advance the skeletal ecosystem one step.

    algN/NO3/Sil [ncat, N]: skeletal-layer concentrations (mmol/m^3);
    fswthru [ncat, N]: shortwave transmitted through the category [W/m^2];
    dhi_dt [ncat, N]: net ice thickness tendency [m/s] (positive growth);
    T_bot [N]: ice-bottom (ocean freezing) temperature [C].

    Returns (algN, NO3, Sil, flux_N, flux_NO3, flux_Sil) with fluxes in
    mmol/m^2/s INTO the ocean, per grid area."""
    has = (aicen > c.puny) & (vicen > c.puny)

    # --- growth --------------------------------------------------------
    f_light = fswthru / (fswthru + ipc.bgc_K_par)
    f_NO3 = NO3 / (NO3 + ipc.bgc_K_NO3)
    f_Sil = Sil / (Sil + ipc.bgc_K_Sil)
    lim = torch.minimum(f_light, torch.minimum(f_NO3, f_Sil))
    mu = ipc.bgc_mu_max / 86400.0 \
        * torch.exp(ipc.bgc_grow_Tdep * T_bot)[None, :] * lim
    grow = mu * algN * dt                                   # mmol N/m^3
    # cap uptake at the available nutrient
    grow = torch.minimum(grow, NO3 * (1.0 - c.puny))
    grow = torch.minimum(grow, Sil * (1.0 - c.puny) / ipc.bgc_R_Si2N)

    # --- mortality / remineralization ---------------------------------
    mort = ipc.bgc_mort / 86400.0 * algN * dt
    mort = torch.minimum(mort, algN * (1.0 - c.puny))
    remin = ipc.bgc_fr_resp * mort
    loss = mort - remin                                     # sinks out

    algN2 = algN + grow - mort
    NO32 = NO3 - grow + remin
    Sil2 = Sil - grow * ipc.bgc_R_Si2N

    # --- ocean exchange ------------------------------------------------
    gr = torch.clamp_min(dhi_dt, 0.0)
    ml = torch.clamp_min(-dhi_dt, 0.0)
    pv = pv_mol + pv_grow * gr + pv_melt * ml               # [m/s]
    relax = 1.0 - torch.exp(-pv * dt / sk_l)
    dNO3 = relax * (ipc.bgc_NO3_ocn - NO32)
    dSil = relax * (ipc.bgc_Sil_ocn - Sil2)
    # algae are flushed out on melt only (no oceanic seed population)
    dalg = -relax * torch.where(ml > 0.0, algN2, 0.0) * 0.5
    NO33 = NO32 + dNO3
    Sil3 = Sil2 + dSil
    algN3 = torch.clamp_min(algN2 + dalg, 0.0)

    algN3 = torch.where(has, algN3, 0.0)
    NO33 = torch.where(has, NO33, 0.0)
    Sil3 = torch.where(has, Sil3, 0.0)

    # grid-mean fluxes into the ocean [mmol/m^2/s]: layer-volume scaled
    w = aicen * sk_l / dt
    flux_N = (w * (loss - dalg)).sum(0)
    flux_NO3 = (w * -dNO3).sum(0)
    flux_Sil = (w * -dSil).sum(0)
    return algN3, NO33, Sil3, flux_N, flux_NO3, flux_Sil
