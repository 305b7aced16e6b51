"""GM (Gent-McWilliams after Ferrari et al. 2010) bolus velocities and
Redi isoneutral mixing.

The port of ``fesom2_tpu/core/gm_redi.py`` (ref ``src/oce_fer_gm.F90``:
fer_solve_Gamma :8-123, fer_gamma2vel :125-157, init_Redi_GM :159-341;
``src/oce_ale_pressure_bv.F90``: compute_sigma_xy :2826-2900,
compute_neutral_slope :2905-2950).  The two streamfunction solves of
``fer_solve_gamma`` share one tridiagonal operator and run as one batched
``tridiag_solve``.
"""
from __future__ import annotations

import torch

from ..constants import g, density_0, pi
from ..mesh import MeshTables
from .ale import _nlevels_node_min
from .ops import column_sum, tridiag_solve, elem_to_node_mean
from .state import OceanState
from .tracers import depths_from_thickness
from . import eos


def compute_sigma_xy(state: OceanState, mesh: MeshTables):
    """Area-averaged nodal density gradients [2, nl-1, N] (ref
    :2826-2900); the four element gradients go to the nodes in one
    elem_to_node_mean."""
    alpha, beta = eos.sw_alpha_beta(state.tr[0], state.tr[1], state.Z_3d)
    ts = state.tr[:2][..., mesh.elem_nodes]                 # [2, L, E, 3]
    gx = (ts * mesh.gradient_sca[:, 0:3]).sum(-1)
    gy = (ts * mesh.gradient_sca[:, 3:6]).sum(-1)
    txy = elem_to_node_mean(torch.stack([gx, gy]), mesh)    # [2, 2, L, N]
    m = mesh.node_layer_mask
    sig_x = torch.where(m, (-alpha * txy[0, 0] + beta * txy[0, 1])
                        * density_0, 0.0)
    sig_y = torch.where(m, (-alpha * txy[1, 0] + beta * txy[1, 1])
                        * density_0, 0.0)
    return torch.stack([sig_x, sig_y])


def compute_neutral_slope(sigma_xy, bvfreq, mesh: MeshTables):
    """Neutral slope and its tanh-tapered form, each [3, nl-1, N] (x, y,
    magnitude) (ref :2905-2950)."""
    eps, S_cr, S_d = 5.0e-6, 1.0e-2, 1.0e-3
    lay = torch.arange(mesh.nl - 1, device=bvfreq.device)[:, None]
    active = (lay >= 1) & (lay <= (mesh.nlevels_node - 2)[None, :])
    denom = torch.clamp_min(bvfreq[:-1] + bvfreq[1:], eps ** 2)
    ro_z_inv = 2.0 * g / density_0 / denom
    s1 = torch.where(active, sigma_xy[0] * ro_z_inv, 0.0)
    s2 = torch.where(active, sigma_xy[1] * ro_z_inv, 0.0)
    s3 = torch.sqrt(s1 ** 2 + s2 ** 2)
    c = 0.5 * (1.0 + torch.tanh((S_cr - s3) / S_d))
    c = torch.where((bvfreq[:-1] <= 0.0) | (bvfreq[1:] <= 0.0), 0.0, c)
    tapered = torch.stack([s1 * c, s2 * c, s3 * c])
    return torch.stack([s1, s2, s3]), tapered


def init_redi_gm(state: OceanState, mesh: MeshTables, cfg, neutral_slope):
    """Horizontal and vertical (Ferreira) scaling of the GM and Redi
    diffusivities (ref :159-341 with scaling_Ferreira and
    scaling_resolution; Rossby scaling off).  Returns (fer_c [N],
    fer_K [nl, N], Ki [nl-1, N]).

    With K_GM_rampmax = K_GM_rampmin the ramp divides by zero; as in the
    JAX package, the infinite ramp is discarded by the select that
    follows (no resolution is below a negative ramp), and nothing raises.
    """
    d = cfg.dyn
    nl = mesh.nl
    reso = mesh.resolution
    # first baroclinic wave speed c1 (ref :186-192)
    bv_sqrt = torch.sqrt(torch.clamp_min(state.bvfreq, 0.0))
    hmask = torch.where(mesh.node_layer_mask, state.hnode_new, 0.0)
    c1 = column_sum(hmask * 0.5 * (bv_sqrt[:-1] + bv_sqrt[1:]))
    c1 = torch.clamp_min(c1 / pi, 0.5)
    scaling = torch.ones_like(reso)
    if d.scaling_resolution:
        scaling = scaling * (reso / 100000.0) \
            ** getattr(d, "K_GM_resscalorder", 2)
    ramp = torch.clamp_min((reso / 1000.0 - d.K_GM_rampmin)
                           / (d.K_GM_rampmax - d.K_GM_rampmin), 0.0)
    scaling = torch.where(reso / 1000.0 < d.K_GM_rampmax, scaling * ramp,
                          scaling)
    fer_scal = torch.clamp_max(scaling, 1.0)
    fer_k_surf = torch.clamp_min(fer_scal * d.K_GM_max, d.K_GM_min)
    fer_c = c1 * c1

    Ki_surf = cfg.tra.K_hor * (reso / 100000.0) ** 2
    if d.Redi and d.Fer_GM:
        Ki_surf = fer_k_surf

    # vertical Ferreira scaling (ref :259-341; K_GM_bvref=2: mean over the
    # mixed layer, whose index is the first level below |mld2|)
    lev = torch.arange(nl, device=reso.device)[:, None]
    deeper = torch.abs(state.zbar_3d) > torch.abs(state.mld2)[None, :]
    mld_ind = torch.clamp_min(torch.argmax(deeper.to(torch.uint8), 0), 1)
    in_ml = lev <= mld_ind[None, :]
    bv_ml = column_sum(torch.where(in_ml, state.bvfreq, 0.0)) / mld_ind
    bvref = torch.clamp_min(bv_ml, 1e-6)
    zscaling = torch.clamp(state.bvfreq / bvref[None, :], 0.2, 1.0)
    if d.scaling_FESOM14:
        ns3 = neutral_slope[2]
        ns3_lvl = torch.cat([ns3, ns3[-1:]], 0)
        zscaling = torch.where(ns3_lvl > 5.0e-3, 0.0, zscaling)
    fer_K = fer_k_surf[None, :] * zscaling
    Ki = Ki_surf[None, :] * 0.5 * (zscaling[:-1] + zscaling[1:])
    return fer_c, fer_K, Ki


def fer_solve_gamma(state: OceanState, mesh: MeshTables, sigma_xy, fer_c,
                    fer_K):
    """The eddy streamfunction Gamma [2, nl, N] (ref :8-123): per column,
    (fer_c d2/dz2 - max(N^2, 1e-8)) Gamma = (g/rho0) <sigma_xy> fer_K with
    Gamma = 0 at the surface and bottom; both components in one batched
    tridiagonal solve."""
    lev = torch.arange(mesh.nl, device=fer_c.device)[:, None]
    nln_min = _nlevels_node_min(mesh)
    zbar_n, Z_n = depths_from_thickness(state.hnode_new, mesh)
    dz_lvl = zbar_n[:-1] - zbar_n[1:]
    dz_lvl = torch.where(dz_lvl == 0, 1.0, dz_lvl)
    dz_mid = Z_n[:-1] - Z_n[1:]
    dz_mid = torch.where(dz_mid == 0, 1.0, dz_mid)

    interior = (lev >= 1) & (lev < (nln_min - 1)[None, :])
    zinv1 = 1.0 / dz_lvl
    zero = torch.zeros_like(Z_n[:1])
    a = torch.cat([zero, fer_c[None, :] * zinv1
                   / torch.cat([dz_mid, dz_mid[-1:]], 0)], 0)
    c = torch.cat([zero, fer_c[None, :] * zinv1[1:] / dz_mid, zero], 0)
    a = torch.where(interior, a, 0.0)
    c = torch.where(interior, c, 0.0)
    b = torch.where(interior, -a - c - torch.clamp_min(state.bvfreq, 1e-8),
                    1.0)

    r = g / density_0
    sig_mid = 0.5 * (torch.cat([sigma_xy[:, :1], sigma_xy], 1)
                     + torch.cat([sigma_xy, sigma_xy[:, -1:]], 1))
    rhs = torch.where(interior, r * sig_mid * fer_K, 0.0)     # [2, nl, N]
    gam = tridiag_solve(a, b, c, rhs)
    return torch.where(lev <= (nln_min - 1)[None, :], gam, 0.0)


def fer_gamma2vel(gamma, state: OceanState, mesh: MeshTables):
    """Bolus velocity on elements (u, v), each [nl-1, E] (ref :125-157)."""
    m = mesh.elem_layer_mask
    zinv = (1.0 / 3.0) / torch.where(m, state.helem, 1.0)
    dg = (gamma[:, :-1] - gamma[:, 1:])[..., mesh.elem_nodes].sum(-1) * zinv
    return torch.where(m, dg[0], 0.0), torch.where(m, dg[1], 0.0)
