# Frozen copy of fesom2_tpu_torch/core/eos.py, lines 1-257 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""Equation of state, hydrostatic pressure, Brunt-Vaisala frequency, MLD.

The port of ``fesom2_tpu/core/eos.py`` (ref ``src/oce_ale_pressure_bv.F90``:
densityJM_components :2589-2654, density_linear :2989-3019,
init_ref_density :3024-3069, pressure_bv :106-370, sw_alpha_beta
:2736-2821).

``pressure_bv`` runs the hand-written CUDA kernel ``csrc/pressure_bv.cu``
(a 32-node tile over all levels a block, the cells in parallel) on a
CUDA tensor; ``pressure_bv_plain`` beside it serves CPU tensors only.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from ..constants import g, density_0
from ..mesh import MeshTables
from .ops import column_levels, take_row
from .state import OceanState

# Jackett & McDougall (1992) coefficients (ref :2605-2636)
_JM = dict(
    a0=19092.56, at=209.8925, at2=-3.041638, at3=-1.852732e-3, at4=-1.361629e-5,
    as_=104.4077, ast=-6.500517, ast2=0.1553190, ast3=2.326469e-4,
    ass=-5.587545, asst=0.7390729, asst2=-1.909078e-2,
    ap=-4.721788e-1, apt=-1.028859e-2, apt2=2.512549e-4, apt3=5.939910e-7,
    aps=1.571896e-2, apst=2.598241e-4, apst2=-7.267926e-6, apss=-2.042967e-3,
    ap2=1.045941e-5, ap2t=-5.782165e-10, ap2t2=1.296821e-7,
    ap2s=-2.595994e-7, ap2st=-1.248266e-9, ap2st2=-3.508914e-9,
    b0=999.842594, bt=6.793952e-2, bt2=-9.095290e-3, bt3=1.001685e-4,
    bt4=-1.120083e-6, bt5=6.536332e-9,
    bs=0.824493, bst=-4.08990e-3, bst2=7.64380e-5, bst3=-8.24670e-7,
    bst4=5.38750e-9, bss=-5.72466e-3, bsst=1.02270e-4, bsst2=-1.65460e-6,
    bss2=4.8314e-4,
)


def density_jm_components(t, s):
    """Split-form JM EoS: returns (bulk_0, bulk_pz, bulk_pz2, rhopot)."""
    J = _JM
    s_sqrt = torch.sqrt(torch.clamp_min(s, 0.0))
    bulk_0 = (J["a0"] + t * (J["at"] + t * (J["at2"] + t * (J["at3"] + t * J["at4"])))
              + s * (J["as_"] + t * (J["ast"] + t * (J["ast2"] + t * J["ast3"]))
                     + s_sqrt * (J["ass"] + t * (J["asst"] + t * J["asst2"]))))
    bulk_pz = (J["ap"] + t * (J["apt"] + t * (J["apt2"] + t * J["apt3"]))
               + s * (J["aps"] + t * (J["apst"] + t * J["apst2"]) + s_sqrt * J["apss"]))
    bulk_pz2 = (J["ap2"] + t * (J["ap2t"] + t * J["ap2t2"])
                + s * (J["ap2s"] + t * (J["ap2st"] + t * J["ap2st2"])))
    rhopot = (J["b0"] + t * (J["bt"] + t * (J["bt2"] + t * (J["bt3"] + t * (J["bt4"] + t * J["bt5"]))))
              + s * (J["bs"] + t * (J["bst"] + t * (J["bst2"] + t * (J["bst3"] + t * J["bst4"])))
                     + s_sqrt * (J["bss"] + t * (J["bsst"] + t * J["bsst2"]))
                     + s * J["bss2"]))
    return bulk_0, bulk_pz, bulk_pz2, rhopot


def density_linear_components(t, s, toy_soufflet: bool):
    """Linear EoS split form (ref density_linear :2989-3019)."""
    if toy_soufflet:
        rho = density_0 - 0.00025 * (t - 10.0) * density_0
    else:
        rho = density_0 + 0.8 * (s - 34.0) - 0.2 * (t - 20.0)
    return torch.ones_like(t), torch.zeros_like(t), torch.zeros_like(t), rho


def eos_components(t, s, state_equation: int, toy_soufflet: bool = False):
    if state_equation == 0:
        return density_linear_components(t, s, toy_soufflet)
    return density_jm_components(t, s)


def reference_density(mesh: MeshTables, Z_3d, state_equation: int,
                      ref_T: float = 2.0, ref_S: float = 34.0,
                      toy_soufflet: bool = False):
    """density_ref(nz, node) (ref init_ref_density :3024-3069): always the
    JM profile at (ref_T, ref_S), whatever ``state_equation`` is."""
    t = torch.full_like(Z_3d, ref_T)
    s = torch.full_like(Z_3d, ref_S)
    b0, bpz, bpz2, rhopot = density_jm_components(t, s)
    z = torch.clamp_max(Z_3d, 0.0)
    # ref :3050 uses b0 + z*bpz + z*bpz2 (sic); kept for parity
    rho = b0 + z * bpz + z * bpz2
    return rho * rhopot / (rho + 0.1 * z)


def _eos_kind(cfg) -> int:
    """0: linear EoS, 1: Jackett-McDougall, 2: the soufflet linear EoS."""
    if cfg.dyn.state_equation == 1:
        return 1
    return 2 if cfg.run.toy_ocean and cfg.run.which_toy == "soufflet" else 0


# flops per wet cell by ``_eos_kind``, counted from pressure_bv_plain:
# the JM components cost about 110 (a linear form 4) and are applied at
# the cell's own depth and, for N^2, at the interfaces above and below
# (3 x about 10); pressure, N^2, dbsfc and the MLD test add about 25
_EOS_CELL_FLOPS = {0: 4 + 55, 1: 110 + 55, 2: 4 + 55}


def pressure_bv_work(levels: int, n_nodes: int, wet_cells: int, eos_kind: int,
                     itemsize: int) -> tuple:
    """(bytes, flops) of one call on [levels, N] layers of which
    ``wet_cells`` are wet (a column runs from its top to its bottom, so
    these inputs need no more): T, S, Z_3d, hnode, density_ref and zbar_3d
    read on the wet cells, ``nlevels_node`` and ``ulevels_node`` [N], the
    outputs written whole (rho and hpressure [L, N], bvfreq and dbsfc
    [L + 1, N], mld2 [N])."""
    nbytes = (6 * wet_cells + n_nodes) * itemsize + 8 * n_nodes \
        + (2 * levels + 2 * (levels + 1) + 1) * n_nodes * itemsize
    return nbytes, _EOS_CELL_FLOPS[eos_kind] * wet_cells


def pressure_bv(state: OceanState, mesh: MeshTables, cfg,
                density_ref) -> OceanState:
    """EoS + hydrostatic pressure + N^2 + MLD (ref pressure_bv :106-370);
    column-local.  ``density_ref`` is [nl-1, N].  Writes density_m_rho0,
    hpressure, bvfreq (with its surface and bottom copies), dbsfc (the
    buoyancy difference to the surface, for KPP) and mld2.  A column's
    surface is its top row, ``ulevels_node - 1`` (below the surface under
    an ice-shelf cavity)."""
    return pressure_bv_plain(state, mesh, cfg, density_ref)


def pressure_bv_plain(state: OceanState, mesh: MeshTables, cfg,
                      density_ref) -> OceanState:
    t = state.tr[0]
    s = state.tr[1]
    Z3 = state.Z_3d
    zb3 = state.zbar_3d
    se = cfg.dyn.state_equation
    toy = cfg.run.toy_ocean and cfg.run.which_toy == "soufflet"
    sef = 1.0 if se == 1 else 0.0
    nmask = mesh.node_layer_mask
    dev = Z3.device

    b0, bpz, bpz2, rhopot = eos_components(t, s, se, toy)
    rho = b0 + Z3 * (bpz + Z3 * bpz2)
    rho = rho * rhopot / (rho + 0.1 * Z3 * sef) - density_ref
    rho = torch.where(nmask, rho, 0.0)

    # the surface row of each column: 0 in open ocean, ulevels - 1 under
    # a cavity
    uln0 = (mesh.ulevels_node - 1).long()
    lay3 = torch.arange(mesh.nl - 1, device=dev)[:, None]
    top = lambda a: take_row(a, uln0)

    # buoyancy difference vs surface (for KPP bldepth, ref :222-231): the
    # surface water brought adiabatically to the local depth
    rho_srf = top(b0)[None, :] + Z3 * (top(bpz)[None, :]
                                       + Z3 * top(bpz2)[None, :])
    rho_srf = rho_srf * top(rhopot)[None, :] / (rho_srf + 0.1 * Z3 * sef)
    rho_full = rho + density_ref
    dbsfc_lay = -g * (rho_srf - rho_full) / torch.where(rho_full == 0, 1.0,
                                                        rho_full)
    dbsfc_lay = torch.where(nmask, dbsfc_lay, 0.0)
    nln = column_levels(mesh).long()
    lev = torch.arange(mesh.nl, device=dev)[:, None]
    dbsfc = torch.cat([dbsfc_lay, dbsfc_lay[-1:]], 0)[:mesh.nl]
    bot_db = torch.gather(dbsfc, 0, (nln - 2)[None, :])
    dbsfc = torch.where(lev == (nln - 1)[None, :], bot_db, dbsfc)
    dbsfc = torch.where(lev <= (nln - 1)[None, :], dbsfc, 0.0)

    # hydrostatic pressure at mid-levels (linfs and cavity path, ref
    # :269-293), from the column's top down
    h = state.hnode
    incr = 0.5 * g * (torch.roll(rho * h, 1, 0) + rho * h)
    incr = torch.where(lay3 <= uln0[None, :], 0.0, incr)
    hp = (-top(Z3) * top(rho) * g)[None, :] + torch.cumsum(incr, 0)
    hp = torch.where(nmask, hp, 0.0)

    # Brunt-Vaisala frequency on interfaces (ref :321-333)
    zbi = zb3[1:-1]
    bu = b0[:-1] + zbi * (bpz[:-1] + zbi * bpz2[:-1])
    bd = b0[1:] + zbi * (bpz[1:] + zbi * bpz2[1:])
    rho_up = bu * rhopot[:-1] / (bu + 0.1 * zbi * sef)
    rho_dn = bd * rhopot[1:] / (bd + 0.1 * zbi * sef)
    dz_inv = 1.0 / (Z3[:-1] - Z3[1:])
    bv_int = -g * dz_inv * (rho_up - rho_dn) / density_0
    bvfreq = torch.zeros_like(state.bvfreq)
    bvfreq[1:-1] = bv_int
    # boundary values (ref :364-365): the top interface <- the first
    # interior one, the bottom interface nzmax <- nzmax-1 (per column)
    bvfreq = torch.where(lev == uln0[None, :], take_row(bvfreq, uln0 + 1),
                         bvfreq)
    bot_val = torch.gather(bvfreq, 0, (nln - 2)[None, :])
    bvfreq = torch.where(lev == (nln - 1)[None, :], bot_val, bvfreq)
    bvfreq = torch.where((lev <= (nln - 1)[None, :]) & (lev >= uln0[None, :]),
                         bvfreq, 0.0)

    # MLD2: shallowest level with rhopot - rhopot(surface) > 0.125
    # (ref :340-358)
    exceed = (rhopot - top(rhopot)[None, :]) > 0.125
    exceed = torch.where(nmask, exceed, True)
    exceed = torch.where(lay3 <= uln0[None, :], False, exceed)
    idx = torch.argmax(exceed.to(torch.uint8), 0)           # first True
    idx = torch.maximum(idx, uln0 + 1)
    mld2 = torch.gather(Z3, 0, idx[None, :])[0]

    return replace(state, density_m_rho0=rho, hpressure=hp, bvfreq=bvfreq,
                   dbsfc=dbsfc, mld2=mld2)


def sw_alpha_beta(t, s, Z_3d):
    """Thermal expansion and haline contraction coefficients (alpha, beta)
    of the McDougall (1987) polynomial (ref :2736-2821), elementwise."""
    t1 = t * 1.00024
    s1 = s
    p1 = torch.abs(Z_3d)
    t1_2, p1_2 = t1 * t1, p1 * p1
    t1_3, p1_3 = t1_2 * t1, p1_2 * p1
    t1_4 = t1_3 * t1
    s35 = s1 - 35.0
    s35_2 = s35 * s35
    beta = (0.785567e-3 - 0.301985e-5 * t1 + 0.555579e-7 * t1_2
            - 0.415613e-9 * t1_3
            + s35 * (-0.356603e-6 + 0.788212e-8 * t1
                     + 0.408195e-10 * p1 - 0.602281e-15 * p1_2)
            + s35_2 * 0.515032e-8
            + p1 * (-0.121555e-7 + 0.192867e-9 * t1 - 0.213127e-11 * t1_2)
            + p1_2 * (0.176621e-12 - 0.175379e-14 * t1)
            + p1_3 * 0.121551e-17)
    a_over_b = (0.665157e-1 + 0.170907e-1 * t1 - 0.203814e-3 * t1_2
                + 0.298357e-5 * t1_3 - 0.255019e-7 * t1_4
                + s35 * (0.378110e-2 - 0.846960e-4 * t1
                         - 0.164759e-6 * p1 - 0.251520e-11 * p1_2)
                + s35_2 * (-0.678662e-5)
                + p1 * (0.380374e-4 - 0.933746e-6 * t1 + 0.791325e-8 * t1_2)
                + p1_2 * t1_2 * 0.512857e-12
                - p1_3 * 0.302285e-13)
    return a_over_b * beta, beta
