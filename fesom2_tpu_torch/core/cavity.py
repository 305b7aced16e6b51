"""Ice-shelf cavity physics: the melt boundary conditions and the drag at
the shelf-ocean interface.

The port of ``fesom2_tpu/core/cavity.py`` (ref ``src/cavity_param.F90``:
the 3-equation model of Hellmer et al. 1997 with the RG4190 conduction
switch :123-301, the 2-equation model :308-350, the momentum fluxes
:356-397, the ice clean-up :401-438, the in-situ temperature of
potit/pttmpr/adlprt :460-562).  Every function is column-local over the
cavity nodes or elements (``ulevels > 1``); the others pass through as 0
or unchanged.
"""
from __future__ import annotations

import math
from dataclasses import replace

import torch

from ..constants import density_0, vcpw
from ..mesh import MeshTables
from .ops import take_row

# 3-equation model constants (ref :142-165)
_A_FP = -0.0575          # freezing-point coefficients (Foldvik & Kvinge 1974)
_B_FP = 0.0901
_C_FP = 7.61e-4
_PR = 13.8               # Prandtl number
_SC = 2432.0             # Schmidt number
_AK = 2.50e-3            # drag coefficient under the shelf
_UN = 1.95e-6            # kinematic viscosity [m2/s]
_TOB = -20.0             # ice-shelf internal temperature [C]
_RHOI = 920.0            # mean shelf-ice density
_CPW = 4180.0            # seawater heat capacity (Barnier et al. 1995)
_LHF = 3.33e5            # latent heat of fusion
_TDIF = 1.54e-6          # thermal diffusivity of the ice shelf
_CPI = 152.5 + 7.122 * (273.15 + _TOB)   # shelf-ice heat capacity


def adlprt(s, t, p):
    """Adiabatic temperature gradient [K/dbar] (UNESCO; ref :536-562)."""
    ds = s - 35.0
    return (((-2.1687e-16 * t + 1.8676e-14) * t - 4.6206e-13) * p
            + ((2.7759e-12 * t - 1.1351e-10) * ds
               + ((-5.4481e-14 * t + 8.7330e-12) * t - 6.7795e-10) * t
               + 1.8741e-8)) * p \
        + (-4.2393e-8 * t + 1.8932e-6) * ds \
        + ((6.6228e-10 * t - 6.8360e-8) * t + 8.5258e-6) * t + 3.5803e-5


def pttmpr(s, t, p, rfpres):
    """Potential temperature by 4th-order Runge-Kutta (ref :493-525)."""
    ct2, ct3 = 0.29289322, 1.707106781
    cq2a, cq2b = 0.58578644, 0.121320344
    cq3a, cq3b = 3.414213562, -4.121320344
    dp = rfpres - p
    dt = dp * adlprt(s, t, p)
    t = t + 0.5 * dt
    q = dt
    p = p + 0.5 * dp
    dt = dp * adlprt(s, t, p)
    t = t + ct2 * (dt - q)
    q = cq2a * dt + cq2b * q
    dt = dp * adlprt(s, t, p)
    t = t + ct3 * (dt - q)
    q = cq3a * dt + cq3b * q
    p = rfpres
    dt = dp * adlprt(s, t, p)
    return t + (dt - q - q) / 6.0


def potit(s, pt, pres, rfpres=0.0, n_iter: int = 12):
    """In-situ temperature from potential temperature by a fixed number of
    fixed-point iterations (ref :460-480)."""
    epsi = torch.zeros_like(pt)
    tin = pt
    for _ in range(n_iter):
        tin = pt + epsi
        ptd = pttmpr(s, tin, pres, rfpres) - pt
        epsi = epsi - ptd
    return tin


def cavity_heat_water_fluxes_3eq(state, mesh: MeshTables, density_ref):
    """The three-equation shelf-base melt model of Hellmer et al. (1997)
    (ref :123-301): (heat_flux, water_flux) [N], positive up, nonzero on
    cavity nodes only.  ``density_ref`` is the model's [nl-1, N]."""
    uln0 = mesh.ulevels_node - 1
    is_cav = mesh.ulevels_node > 1

    temp = take_row(state.tr[0], uln0)
    sal = torch.clamp_min(take_row(state.tr[1], uln0), 3.0)
    zice = torch.clamp_max(take_row(state.Z_3d, uln0), -0.1)   # (<0)

    tin = potit(sal, temp, torch.abs(zice))

    # turbulent exchange velocities, Jenkins (1991) (ref :191-207)
    vt1 = torch.sqrt(take_row(state.unode, uln0) ** 2
                     + take_row(state.vnode, uln0) ** 2)
    vt1 = torch.clamp_min(vt1, 0.001)
    re = 10.0 / _UN
    gats1 = math.sqrt(_AK) * vt1
    gats2 = 2.12 * torch.log(gats1 * re) - 9.0
    gat = gats1 / (gats2 + 12.5 * _PR ** (2.0 / 3.0))
    gas = gats1 / (gats2 + 12.5 * _SC ** (2.0 / 3.0))

    rhow = take_row(state.density_m_rho0, uln0) + take_row(density_ref, uln0)
    rhor = _RHOI / torch.where(rhow > 0, rhow, density_0)

    ep1 = _CPW * gat
    ep2 = _CPI * gas
    ep3 = _LHF * gas
    ep31 = -rhor * _CPI * _TDIF / zice
    ep4 = _B_FP + _C_FP * zice

    # freezing or melting (the RG4190 switch, ref :239-255)
    tf_test = _A_FP * sal + ep4
    freezing = tin < tf_test
    ex1 = torch.where(freezing, _A_FP * (ep1 + ep31), _A_FP * (ep1 - ep2))
    ex2 = torch.where(freezing,
                      ep1 * (tin - ep4) + ep3 + ep31 * (_TOB - ep4),
                      ep1 * (ep4 - tin) + ep2 * (_TOB + _A_FP * sal - ep4)
                      - ep3)
    ex3 = torch.where(freezing, ep3 * sal, sal * (ep2 * (ep4 - _TOB) + ep3))
    ex6 = torch.where(freezing, 0.5, -0.5).to(ex1.dtype)

    ex1 = torch.where(ex1 == 0, 1e-30, ex1)
    ex4 = ex2 / ex1
    ex5 = ex3 / ex1
    sr1 = torch.clamp_min(0.25 * ex4 * ex4 - ex5, 0.0)
    sr2 = ex6 * ex4
    sf1 = sr2 + torch.sqrt(sr1)
    sf2 = sr2 - torch.sqrt(sr1)
    # a negative salinity is unphysical: the positive root (ref :275-283)
    sf = torch.where(sf1 > 0.0, sf1, sf2)
    sf = torch.where(sf == 0, 1e-30, sf)
    tf = _A_FP * sf + ep4

    heat_flux = rhow * _CPW * gat * (tin - tf)        # [W/m2] positive up
    water_flux = gas * (sf - sal) / sf                # [m/s]
    return (torch.where(is_cav, heat_flux, 0.0),
            torch.where(is_cav, water_flux, 0.0))


def cavity_heat_water_fluxes_2eq(state, mesh: MeshTables):
    """The two-equation melt parameterisation (Hunter 2006; ref
    :308-350): (heat_flux, water_flux) [N], nonzero on cavity nodes."""
    uln0 = mesh.ulevels_node - 1
    is_cav = mesh.ulevels_node > 1
    gama = 1.0e-4
    L = 334000.0
    t_i = take_row(state.tr[0], uln0)
    s_i = take_row(state.tr[1], uln0)
    z = torch.abs(take_row(state.Z_3d, uln0))
    t_fz = 1.710523e-3 * torch.clamp_min(s_i, 0.0) ** 1.5 \
        - 2.154996e-4 * s_i ** 2 - 0.0575 * s_i - 7.53e-4 * z
    heat_flux = torch.where(is_cav, vcpw * gama * (t_i - t_fz), 0.0)
    water_flux = torch.where(is_cav, -heat_flux / (L * 1000.0), 0.0)
    return heat_flux, water_flux


def cavity_momentum_fluxes(state, mesh: MeshTables, cfg):
    """Quadratic drag of the shelf base against the top layer's flow (ref
    :356-397): (stress_x, stress_y) [E], 0 on open-ocean elements."""
    ule0 = mesh.ulevels_elem - 1
    is_cav = mesh.ulevels_elem > 1
    u_top = take_row(state.u, ule0)
    v_top = take_row(state.v, ule0)
    aux = torch.sqrt(u_top ** 2 + v_top ** 2) * density_0 * cfg.dyn.C_d
    return (torch.where(is_cav, -aux * u_top, 0.0),
            torch.where(is_cav, -aux * v_top, 0.0))


def cavity_ice_clean(ice, mesh: MeshTables):
    """No sea ice under the shelf: velocity, mass and concentration 0 at
    cavity nodes (ref :401-438)."""
    is_cav = mesh.ulevels_node > 1
    zero = lambda a: torch.where(is_cav, 0.0, a)
    return replace(ice, u_ice=zero(ice.u_ice), v_ice=zero(ice.v_ice),
                   m_ice=zero(ice.m_ice), m_snow=zero(ice.m_snow),
                   a_ice=zero(ice.a_ice))
