# Frozen copy of fesom2_tpu_torch/forcing/bulk.py, lines 1-96 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""NCAR (Large & Yeager 2004/2009) bulk transfer coefficients, vectorised.

The port of ``fesom2_tpu/forcing/bulk.py``.  Reference:
``src/gen_bulk_formulae.F90`` ncar_ocean_fluxes_mode :115-290.  The
per-node fixed-point loop is a fixed count of vector iterations (the
reference exits early on convergence; 5 iterations bound it).
"""
from __future__ import annotations

import math

import torch

from ..ice.state import inv_rhoair, tmelt

grav = 9.80
vonkarm = 0.40
q1 = 640380.0
q2 = -5107.4
u10min = 0.3


def _cd_n10(u10):
    hl1 = (2.7 / u10 + 0.142 + 0.0764 * u10 - 3.14807e-10 * u10 ** 6) / 1.0e3
    return torch.where(u10 < 33.0, hl1, 2.34e-3)      # LY2009 eqn. 11


def _psi(zeta):
    x2 = torch.clamp_min(torch.sqrt(torch.abs(1.0 - 16.0 * zeta)), 1.0)
    x = torch.sqrt(x2)
    psi_m_un = torch.log((1.0 + 2.0 * x + x2) * (1.0 + x2) / 8.0) \
        - 2.0 * (torch.arctan(x) - math.atan(1.0))
    psi_h_un = 2.0 * torch.log((1.0 + x2) / 2.0)
    psi_m = torch.where(zeta > 0, -5.0 * zeta, psi_m_un)
    psi_h = torch.where(zeta > 0, -5.0 * zeta, psi_h_un)
    return psi_m, psi_h


def ncar_ocean_fluxes(tair_C, sst_C, shum, u_wind, v_wind, u_w, v_w,
                      z_wind=10.0, z_tair=10.0, z_shum=10.0, n_itts=5):
    """Return (cd, ch, ce) transfer coefficients at measurement height."""
    t = tair_C + tmelt
    ts = sst_C + tmelt
    q = shum
    qs = 0.98 * q1 * inv_rhoair * torch.exp(q2 / ts)
    tv = t * (1.0 + 0.608 * q)
    u = torch.clamp_min(torch.sqrt((u_wind - u_w) ** 2 + (v_wind - v_w) ** 2),
                        u10min)
    u10, t10, q10 = u, t, q

    cd_n10 = _cd_n10(u10)
    cd_n10_rt = torch.sqrt(cd_n10)
    ce_n10 = 34.6 * cd_n10_rt * 1.0e-3
    stab = 0.5 + torch.sign(t - ts) * 0.5
    ch_n10 = (18.0 * stab + 32.7 * (1.0 - stab)) * cd_n10_rt * 1.0e-3
    cd, ch, ce = cd_n10, ch_n10, ce_n10

    for _ in range(n_itts):
        cd_rt = torch.sqrt(cd)
        ustar = cd_rt * u
        tstar = (ch / cd_rt) * (t10 - ts)
        qstar = (ce / cd_rt) * (q10 - qs)
        bstar = grav * (tstar / tv + qstar / (q10 + 1.0 / 0.608))
        us2 = ustar * ustar + 1e-30

        def zeta_of(z):
            zeta = vonkarm * bstar * z / us2
            return torch.sign(zeta) * torch.clamp_max(torch.abs(zeta), 10.0)

        # a height shared with the wind's shares its stability function
        zeta_u = zeta_of(z_wind)
        psi_m_u, psi_h_u = _psi(zeta_u)
        psi_h_t = psi_h_u if z_tair == z_wind else _psi(zeta_of(z_tair))[1]
        psi_h_q = psi_h_u if z_shum == z_wind else _psi(zeta_of(z_shum))[1]

        u10 = u / (1.0 + cd_n10_rt * (math.log(z_wind / 10.0) - psi_m_u)
                   / vonkarm)
        u10 = torch.clamp_min(u10, u10min)
        t10 = t - tstar / vonkarm * (math.log(z_tair / z_wind) + psi_h_u
                                     - psi_h_t)
        q10 = q - qstar / vonkarm * (math.log(z_shum / z_wind) + psi_h_u
                                     - psi_h_q)
        tv = t10 * (1.0 + 0.608 * q10)

        cd_n10 = _cd_n10(u10)
        cd_n10_rt = torch.sqrt(cd_n10)
        ce_n10 = 34.6 * cd_n10_rt * 1.0e-3
        stab = 0.5 + torch.sign(zeta_u) * 0.5
        ch_n10 = (18.0 * stab + 32.7 * (1.0 - stab)) * cd_n10_rt * 1.0e-3

        xx = (math.log(z_wind / 10.0) - psi_m_u) / vonkarm
        cd = cd_n10 / (1.0 + cd_n10_rt * xx) ** 2
        xx = (math.log(z_wind / 10.0) - psi_h_u) / vonkarm
        ch = ch_n10 / (1.0 + ch_n10 * xx / cd_n10_rt) * torch.sqrt(cd / cd_n10)
        ce = ce_n10 / (1.0 + ce_n10 * xx / cd_n10_rt) * torch.sqrt(cd / cd_n10)
    return cd, ch, ce
