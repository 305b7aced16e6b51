# Frozen copy of fesom2_tpu_torch/toy/soufflet.py, lines 1-184 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""Soufflet et al. (2016) baroclinic zonal channel: analytic initial state
and zonal-mean relaxation.

The port of ``fesom2_tpu/toy/soufflet.py`` (ref
``src/toy_channel_soufflet.F90``: initial_state_soufflet :220-343,
relax_zonal_vel :45-76, relax_zonal_temp :78-103, compute_zonal_mean
:160-218).  ``setup_soufflet`` runs on the host in numpy.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import pi, g, density_0, r_earth
from ..mesh import MeshTables
from ..core.state import OceanState

# parameters (ref :18-37)
TAU_INV = 1.0 / 50.0 / 24.0 / 3600.0
LAT0 = 0.0
YSIZE = 2000000.0
XSIZE = 90018410.49779853
NYBINS = 100
LJET = 1600000.0
RHOMAX = 27.75
SB = 9.8e-6
ZSIZE = 4000.0
DRHO_NO, DRHO_SO = 1.41, 1.4
Z_NO, Z_SO = -400.0, -1000.0
DZ_NO, DZ_SO = 300.0, 700.0
DRHOSURF_NO, DRHOSURF_SO = 0.0, 1.5
ZSURF = -300.0


@dataclass(frozen=True)
class SouffletStatics:
    Tclim: torch.Tensor      # [nl-1, N]
    Uclim: torch.Tensor      # [nl-1, E]
    coriolis: torch.Tensor   # [E] beta-plane (ref :306-310)
    bpos: torch.Tensor       # [E] int32 meridional bin of each element
    bin_w: torch.Tensor      # [E] zeros (kept for field parity)
    node_nn: torch.Tensor    # [N, 2] int32 bins for node interpolation
    node_a: torch.Tensor     # [N] interpolation weight
    znum: torch.Tensor       # [nl-1, NYBINS] element counts per bin/layer


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _profiles(Z: np.ndarray):
    d_No = Z_NO + (Z - Z_NO) * np.sqrt(1 + 0.5 * (((Z - Z_NO) + np.abs(Z - Z_NO)) / 1.3 / DZ_NO) ** 2)
    d_So = Z_SO + (Z - Z_SO) * np.sqrt(1 + 0.5 * (((Z - Z_SO) + np.abs(Z - Z_SO)) / 1.3 / DZ_SO) ** 2)
    rho_No = (RHOMAX - SB * (Z + ZSIZE) - 0.5 * DRHO_NO * (1 + np.tanh((d_No - Z_NO) / DZ_NO))
              - 1.0 / (2 * np.tanh(1.0)) * DRHOSURF_NO * (1 + np.tanh((ZSURF - Z) / ZSURF)))
    rho_So = (RHOMAX - SB * (Z + ZSIZE) - 0.5 * DRHO_SO * (1 + np.tanh((d_So - Z_SO) / DZ_SO))
              - 1.0 / (2 * np.tanh(1.0)) * DRHOSURF_SO * (1 + np.tanh((ZSURF - Z) / ZSURF)))
    T_No = 10.0 - (rho_No - RHOMAX) / (0.00025 * density_0)
    T_So = 10.0 - (rho_So - RHOMAX) / (0.00025 * density_0)
    return T_No, T_So


def setup_soufflet(mesh: MeshTables, dtype=torch.float64):
    """Initial T and U + relaxation statics (ref :220-343); host numpy,
    results on the mesh's device.  Returns (T, U, statics)."""
    coords = _np(mesh.coords)
    en = _np(mesh.elem_nodes)
    nle = _np(mesh.nlevels_elem)
    nln = _np(mesh.nlevels_node)
    Z = _np(mesh.Z)
    zbar = _np(mesh.zbar)
    nl = mesh.nl
    E = mesh.n_elems
    dy = YSIZE / NYBINS / r_earth

    T_No, T_So = _profiles(Z)

    # meridional blending profile (ref :268-284)
    dst = (coords[:, 1] - LAT0) * r_earth
    yn = pi * (YSIZE / LJET) * (dst / YSIZE - 0.5) + pi / 2.0
    Fy = np.where(yn < 0, 1.0, np.where(yn > pi, 0.0,
                                        1.0 - (yn - np.sin(yn) * np.cos(yn)) / pi))
    T = T_So[:, None] + (T_No - T_So)[:, None] * (1.0 - Fy)[None, :]
    lay = np.arange(nl - 1)
    nmask = lay[:, None] < (nln - 1)[None, :]
    T = np.where(nmask, T, 0.0)
    Tclim = T.copy()

    # small perturbation (ref :293-300)
    pert = (-0.1 * np.sin(2 * pi * dst / YSIZE)[None, :]
            * np.exp(2 * Z / ZSIZE)[:, None]
            * (np.sin(8 * pi * coords[:, 0] * r_earth / XSIZE)
               + 0.5 * np.sin(3 * pi * coords[:, 0] * r_earth / XSIZE))[None, :])
    T = np.where(nmask, T + pert, 0.0)

    # beta-plane Coriolis on elements (ref :306-310)
    ecy = coords[en][:, :, 1].mean(1)
    dste = (ecy - LAT0) * r_earth - YSIZE / 2
    coriolis = 1.0e-4 + dste * 1.6e-11

    # geostrophically balanced zonal flow by thermal wind (ref :312-326)
    gsca = _np(mesh.gradient_sca)
    dTdy = (Tclim[:, en] * gsca[None, :, 3:6]).sum(-1)
    shear = (-(0.00025 * density_0) * g / density_0 / coriolis)[None, :] * dTdy
    emask = lay[:, None] < (nle - 1)[None, :]
    shear = np.where(emask, shear, 0.0)
    # U(k) = sum_{j>=k} shear(j)*(Z(j)-zbar(j+1)) + sum_{j>k} shear(j)*(zbar(j)-Z(j))
    inc_own = np.where(emask, shear * (Z[:, None] - zbar[1:, None]), 0.0)
    inc_up = np.where(emask, shear * (zbar[:-1, None] - Z[:, None]), 0.0)
    rev_own = np.flip(np.cumsum(np.flip(inc_own, 0), 0), 0)
    rev_up = np.flip(np.cumsum(np.flip(inc_up, 0), 0), 0)
    rev_up_below = np.concatenate([rev_up[1:], np.zeros((1, E))], 0)
    U = np.where(emask, rev_own + rev_up_below, 0.0)

    # zonal-mean bin structure (ref compute_zonal_mean_ini :105-158)
    bpos = np.clip(np.floor((ecy - LAT0) / dy).astype(np.int64), 0, NYBINS - 1)
    znum = np.zeros((nl - 1, NYBINS))
    for b in range(NYBINS):
        sel = bpos == b
        if sel.any():
            znum[:, b] = emask[:, sel].sum(1)
    # node interpolation bins (ref relax_zonal_temp :86-97)
    yy = coords[:, 1] - LAT0
    nn = np.where(yy < dy / 2, 0, np.floor(yy / dy - 0.5).astype(np.int64))
    nn1 = np.minimum(nn + 1, NYBINS - 1)
    a = np.where(yy < dy / 2, 0.0, yy / dy + 0.5 - (nn + 1))
    node_nn = np.stack([np.clip(nn, 0, NYBINS - 1), nn1], 1)

    dev = mesh.zbar.device
    f = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=dev).to(dtype)
    i = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=dev)
    statics = SouffletStatics(
        Tclim=f(Tclim), Uclim=f(U), coriolis=f(coriolis), bpos=i(bpos),
        bin_w=f(np.zeros(E)), node_nn=i(node_nn), node_a=f(a), znum=f(znum))
    return f(T), f(U), statics


def zonal_means(state: OceanState, mesh: MeshTables, st: SouffletStatics):
    """Per-bin zonal means of u and of the element-mean T: (zvel, ztem)
    [nl-1, NYBINS] (ref compute_zonal_mean :160-218).  The bin sums are a
    product with the [E, NYBINS] one-hot bin matrix."""
    emask = mesh.elem_layer_mask
    u = torch.where(emask, state.u, 0.0)
    Te = torch.where(emask, state.tr[0][:, mesh.elem_nodes].mean(-1), 0.0)
    bins = torch.arange(NYBINS, device=u.device)
    onehot = (st.bpos[:, None] == bins[None, :]).to(u.dtype)
    zvel = (u @ onehot) / (st.znum + 0.001)
    ztem = (Te @ onehot) / (st.znum + 0.001)
    return zvel, ztem


def _elem_interp(mesh: MeshTables, zfield):
    """Interpolate a [nl-1, NYBINS] zonal profile to element centers."""
    ecy = mesh.coords[:, 1][mesh.elem_nodes].mean(-1)
    dy = YSIZE / NYBINS / r_earth
    yy = ecy - LAT0
    nn = torch.where(yy < dy / 2, 0, torch.floor(yy / dy - 0.5).long())
    nn = torch.clamp(nn, 0, NYBINS - 1)
    nn1 = torch.clamp_max(nn + 1, NYBINS - 1)
    a = torch.where(yy < dy / 2, 0.0, yy / dy + 0.5 - (nn + 1))
    return (1.0 - a)[None, :] * zfield[:, nn] + a[None, :] * zfield[:, nn1]


def relax_zonal_vel(state: OceanState, mesh: MeshTables, st: SouffletStatics,
                    dt, u_rhs, zvel):
    """u_rhs += dt*tau_inv*(Uclim - Uzonal) (ref relax_zonal_vel :45-76)."""
    add = dt * TAU_INV * (st.Uclim - _elem_interp(mesh, zvel))
    return u_rhs + torch.where(mesh.elem_layer_mask, add, 0.0)


def relax_zonal_temp(state: OceanState, mesh: MeshTables, st: SouffletStatics,
                     dt, ztem):
    """T += dt*tau_inv*(Tclim - Tzonal) (ref relax_zonal_temp :78-103);
    returns the new tracer array."""
    nn = st.node_nn[:, 0]
    nn1 = st.node_nn[:, 1]
    a = st.node_a
    Tzon = (1.0 - a)[None, :] * ztem[:, nn] + a[None, :] * ztem[:, nn1]
    add = dt * TAU_INV * (st.Tclim - Tzon)
    tr = state.tr.clone()
    tr[0] = state.tr[0] + torch.where(mesh.node_layer_mask, add, 0.0)
    return tr
