# Frozen copy of fesom2_tpu_torch/ice/evp.py, lines 1-912 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""Sea-ice dynamics: the three EVP rheologies of ``fesom2_tpu/ice/evp.py``.

mEVP (``whichEVP = 1``, the CI default; ``src/ice_maEVP.F90``
EVPdynamics_m :273-602), standard EVP (0; ``src/ice_EVP.F90``) and
adaptive EVP (2; ``ice_maEVP.F90`` EVPdynamics_a :785-888).  Each
pseudotime iteration: element stress update -> stress divergence gathered
to nodes -> node update with Coriolis and ocean drag -> Dirichlet coastal
BC.

``mevp_setup``, ``evp_setup`` and ``aevp_setup`` compute what is constant
over the subcycles once per step (plain torch ops) and pack it into two
tables, ``node_c`` [R, N] and ``elem_c`` [Q, E] (rows ``*_NODE_ROWS``,
``*_ELEM_ROWS``).  The subcycles are then ``mevp_subcycles``,
``evp_subcycles`` or ``aevp_subcycles``: on CUDA tensors one hand-written
cooperative kernel (``csrc/mevp_subcycle.cu``, one instantiation per
rheology) that runs all of them in one launch, grid barriers between the
element half and the node half, and updates the velocities and stresses
in place; on CPU tensors the plain loop (``*_subcycles_plain``: the
element half ``*_stress_plain`` then the node half ``*_node_plain``, the
loop body as torch ops in the kernel's order of operations).  A CUDA
tensor goes through the kernel or the call raises.  Adaptive EVP then
refreshes its per-element alpha and per-node beta from the converged
velocities (``aevp_refresh``, plain torch, once a step).

With Icepack the strength of its ridging closure (``ridge.ice_strength``,
a field on the nodes) replaces mEVP's Hibler P* closure: the element
pressure is the node mean of the strength (``mevp_setup``'s
``strength_node``, ``fesom2_tpu/ice/evp.py:67-70``); standard and adaptive
EVP drop the field, as the JAX package's ``evp_dynamics`` and
``aevp_dynamics`` do.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, replace
from typing import Optional

import torch

from ..constants import g, density_0
from ..core.ops import (on_subdomain, elem_contrib_to_nodes,
                        elem_contrib_to_nodes_plain, elem_slot_of,
                        halo_fix_nodes, in_dist_context)
from .state import IceState, IceForcing, OceanSurface, rhoice, rhosno

# rows of MevpTables.node_c and MevpTables.elem_c
NODE_ROWS = ("u0", "v0", "u_w", "v_w", "mass", "rhs_a", "rhs_m",
             "inv_thickness", "stress_x", "stress_y", "bc", "rdt_cor",
             "has_ice")
ELEM_ROWS = ("dx0", "dx1", "dx2", "dy0", "dy1", "dy2", "meancos",
             "pressure_fac", "ice_area", "has_ice")


@dataclass
class MevpTables:
    """What one step's subcycles share (``mevp_setup``)."""
    node_c: torch.Tensor     # [13, N], rows NODE_ROWS (has_ice as 1 or 0)
    elem_c: torch.Tensor     # [10, E], rows ELEM_ROWS
    en: torch.Tensor         # [3, E] int32 element nodes, vertex-major
    fuv: Optional[torch.Tensor]  # [2, E, 3] the kernel's scratch, or None
    det1: float              # alpha / (1 + alpha)
    vale: float              # 1 / ellipse^2
    delta_min: float
    rdt: float               # the ice time step
    rdt_cd: float            # rdt * Cd_oce_ice
    beta: float
    checked: bool = False    # the kernel's view of the tables was verified


def _scratch(dt, device, n_elems):
    """The kernel's divergence buffer [2, E, 3] on a card, None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    return torch.empty((2, n_elems, 3), dtype=dt, device=device)


def mevp_setup(ice: IceState, mesh, forcing: IceForcing,
               ocean: OceanSurface, cfg, strength_node=None) -> MevpTables:
    """The per-step precomputes of mEVP (``fesom2_tpu/ice/evp.py:33-81``):
    the elevation rhs, the node masses and thickness factors, the element
    pressure factor; ``mesh`` is the mesh or the ice subdomain, and the
    fields of ``ice``, ``forcing`` and ``ocean`` are numbered as it is.
    ``strength_node`` [N] (Icepack's ice strength) makes the element
    pressure the mean of its three nodes' strengths in place of the Hibler
    P* closure (ref ice_maEVP.F90:97-98, the __icepack branch)."""
    icfg = cfg.ice
    ice_dt = cfg.dt * icfg.ice_ave_steps
    alpha = icfg.alpha_evp
    det2 = 1.0 / (1.0 + alpha)
    det1 = alpha * det2
    en = mesh.elem_nodes.long()                # [E, 3]
    dx = mesh.gradient_sca[:, 0:3]             # [E, 3]
    dy = mesh.gradient_sca[:, 3:6]
    meancos = mesh.metric_factor / 3.0         # [E]
    area1 = mesh.area[0]                       # [N]
    area1s = torch.where(area1 > 0, area1, 1.0)

    # ---- elevation (+ ice loading) pressure rhs (ref :338-390) -----------
    eta_e = ocean.elevation[en]                # [E, 3]
    bb = g * mesh.elem_area / 3.0
    aa_e = bb * (dx * eta_e).sum(-1)
    bb_e = bb * (dy * eta_e).sum(-1)
    # both components in one assembly: rows [2, E, 3]
    rhs_a, rhs_m = elem_contrib_to_nodes(
        torch.stack([-aa_e, -bb_e])[..., None].expand(-1, -1, 3), mesh)

    # ---- per-node precomputes (ref :393-410) -----------------------------
    has_ice_n = ice.a_ice >= 0.01
    thick = (rhoice * ice.m_ice + rhosno * ice.m_snow) \
        / torch.clamp_min(ice.a_ice, 0.01)
    inv_thickness = torch.where(has_ice_n,
                                1.0 / torch.clamp_min(thick, 9.0), 0.0)
    mass = rhoice * ice.m_ice + rhosno * ice.m_snow
    mass = torch.where(has_ice_n, mass / ((1.0 + mass * mass) * area1s), 0.0)
    rhs_a = torch.where(has_ice_n, rhs_a / area1s, 0.0)
    rhs_m = torch.where(has_ice_n, rhs_m / area1s, 0.0)

    # ---- per-element pressure factor (ref :413-428) ----------------------
    msum = ice.m_ice[en].mean(-1)
    asum = ice.a_ice[en].mean(-1)
    has_ice_e = msum > 0.01
    if strength_node is not None:
        p_e = strength_node[en].mean(-1)
    else:
        p_e = icfg.Pstar * msum * torch.exp(-icfg.c_pressure * (1.0 - asum))
    pressure_fac = torch.where(has_ice_e, det2 * p_e, 0.0)
    ice_area = torch.where(has_ice_e, mesh.elem_area, 0.0)

    dt = ice.u_ice.dtype
    node_c = torch.stack([
        ice.u_ice, ice.v_ice, ocean.u_w, ocean.v_w, mass, rhs_a, rhs_m,
        inv_thickness, forcing.stress_atmice_x, forcing.stress_atmice_y,
        mesh.bc_index_node, ice_dt * mesh.coriolis_node, has_ice_n.to(dt)])
    elem_c = torch.cat([dx.T, dy.T, torch.stack([
        meancos, pressure_fac, ice_area, has_ice_e.to(dt)])])
    return MevpTables(
        node_c=node_c, elem_c=elem_c, en=mesh.elem_nodes.T.contiguous(),
        fuv=_scratch(dt, node_c.device, mesh.n_elems),
        det1=det1, vale=1.0 / icfg.ellipse ** 2, delta_min=icfg.delta_min,
        rdt=ice_dt, rdt_cd=ice_dt * icfg.Cd_oce_ice, beta=icfg.beta_evp)


def _sum3(a: torch.Tensor) -> torch.Tensor:
    """The sum over an element's three vertices, in vertex order."""
    return a[0] + a[1] + a[2]


def _strain_rates(uv: torch.Tensor, tab):
    """(eps1, eps2, eps12, delta) [E] of the velocities uv [2, N] at the
    elements' vertices, the rows dx, dy, meancos of ``tab.elem_c`` (rows
    0-6 of every rheology) and ``tab.vale``: the strain-rate invariants of
    all three rheologies (``fesom2_tpu/ice/evp.py:86-95``), in the
    kernel's order of operations."""
    e = tab.elem_c
    en = tab.en.long()
    ue, ve = uv[0][en], uv[1][en]                   # [3, E]
    dx, dy, meancos = e[0:3], e[3:6], e[6]
    eps11 = _sum3(dx * ue) - _sum3(ve) * meancos
    eps22 = _sum3(dy * ve)
    eps12 = 0.5 * (_sum3(dy * ue) + _sum3(dx * ve) + _sum3(ue) * meancos)
    eps1 = eps11 + eps22
    eps2 = eps11 - eps22
    delta = torch.sqrt(eps1 ** 2 + tab.vale * (eps2 ** 2 + 4.0 * eps12 ** 2))
    return eps1, eps2, eps12, delta


def _divergence(s11, s12, s22, e, ice_area):
    """The stress divergence each element adds to its vertices (ref
    :516-545), vertex-major [2, 3, E]; ``ice_area`` is the element's area
    where it has ice, else 0."""
    dx, dy, meancos = e[0:3], e[3:6], e[6]
    fu = -ice_area * (s11 * dx + s12 * (dy + meancos))
    fv = -ice_area * (s12 * dx + s22 * dy - s11 * meancos)
    return torch.stack([fu, fv])


def mevp_stress_plain(uv: torch.Tensor, sig: torch.Tensor, tab: MevpTables):
    """The element half of a subcycle (``fesom2_tpu/ice/evp.py:85-105``):
    strain rates from the velocities at the three vertices, the stress
    update where the element has ice, and the stress divergence each
    element adds to its vertices.  Returns (sig [3, E] new, fuv [2, 3, E])."""
    e = tab.elem_c
    pfac, ice_area = e[7], e[8]
    has_ice_e = e[9] > 0
    s11, s12, s22 = sig[0], sig[1], sig[2]
    vale = tab.vale
    eps1, eps2, eps12, delta = _strain_rates(uv, tab)
    pressure = pfac / (delta + tab.delta_min)
    s12 = torch.where(has_ice_e, tab.det1 * s12 + pressure * eps12 * vale, s12)
    s11 = torch.where(
        has_ice_e,
        tab.det1 * s11 + 0.5 * pressure * (eps1 - delta + eps2 * vale), s11)
    s22 = torch.where(
        has_ice_e,
        tab.det1 * s22 + 0.5 * pressure * (eps1 - delta - eps2 * vale), s22)
    return torch.stack([s11, s12, s22]), _divergence(s11, s12, s22, e,
                                                     ice_area)


def mevp_node_plain(uv: torch.Tensor, fuv: torch.Tensor, tab: MevpTables,
                    mesh) -> torch.Tensor:
    """The node half of a subcycle (``fesom2_tpu/ice/evp.py:106-126``): the
    stress divergence summed over each node's elements in slot order, then
    the point-implicit update with drag and Coriolis.  Returns uv [2, N]."""
    c = tab.node_c
    u, v = uv[0], uv[1]
    u0, v0, u_w, v_w, mass, rhs_a, rhs_m, inv_thickness, sx, sy, bc, rc = c[:12]
    has_ice_n = c[12] > 0
    rdt, beta = tab.rdt, tab.beta
    rhs2 = elem_contrib_to_nodes_plain(fuv, mesh, vertex_major=True)
    u_rhs = rhs2[0] * mass + rhs_a
    v_rhs = rhs2[1] * mass + rhs_m
    # point-implicit node update (ref :561-576)
    umod = torch.sqrt((u - u_w) ** 2 + (v - v_w) ** 2)
    drag = tab.rdt_cd * umod * density_0 * inv_thickness
    rhsu = u0 + drag * u_w + rdt * (inv_thickness * sx + u_rhs) + beta * u
    rhsv = v0 + drag * v_w + rdt * (inv_thickness * sy + v_rhs) + beta * v
    det = bc / ((1.0 + beta + drag) ** 2 + rc ** 2)
    u_new = det * ((1.0 + beta + drag) * rhsu + rc * rhsv)
    v_new = det * ((1.0 + beta + drag) * rhsv - rc * rhsu)
    u_new = torch.where(has_ice_n, u_new, u)
    v_new = torch.where(has_ice_n, v_new, v)
    # coastal Dirichlet BC is implicit in bc_index_node (det=0 there)
    return torch.stack([u_new * bc, v_new * bc])


def mevp_subcycle_plain(uv: torch.Tensor, sig: torch.Tensor,
                        tab: MevpTables, mesh):
    """One mEVP subcycle as torch ops: (uv [2, N], sig [3, E]) -> new
    (uv, sig); the inputs are left as they are."""
    sig, fuv = mevp_stress_plain(uv, sig, tab)
    return mevp_node_plain(uv, fuv, tab, mesh), sig


def mevp_subcycles_plain(uv: torch.Tensor, sig: torch.Tensor,
                         tab: MevpTables, mesh, n: int):
    """``n`` subcycles of ``mevp_subcycle_plain``: new (uv, sig)."""
    for _ in range(n):
        uv, sig = mevp_subcycle_plain(uv, sig, tab, mesh)
    return uv, sig


def mevp_subcycles_work(n_nodes: int, n_elems: int, k_max: int,
                        itemsize: int, n_sub: int) -> tuple:
    """(bytes, flops) of ``n_sub`` subcycles in one call.  Bytes: each
    input once (uv, sig, ``elem_c``, ``node_c``, the element nodes, the
    slot words ``elem_slot`` [K, N]) and each output once (uv, sig).
    Flops, each subcycle: about 70 an element (strain rates, delta, the
    stress update, the divergence of its three vertices) and 2 K adds and
    about 45 operations a node."""
    nbytes = ((2 + len(NODE_ROWS) + 2) * n_nodes
              + (3 + len(ELEM_ROWS) + 3) * n_elems) * itemsize \
        + (3 * n_elems + k_max * n_nodes) * 4
    return nbytes, n_sub * (70 * n_elems + (2 * k_max + 45) * n_nodes)


def mevp_subcycles_barriers(n_sub: int) -> int:
    """The grid barriers one launch of ``n_sub`` subcycles crosses: one
    after each element phase and one after each node phase but the last."""
    return max(2 * n_sub - 1, 0)


def mevp_subcycles(uv: torch.Tensor, sig: torch.Tensor, tab: MevpTables,
                   mesh, n: int):
    """``n`` mEVP subcycles: (uv [2, N], sig [3, E]) -> (uv, sig).  On CUDA
    tensors one launch of the cooperative kernel updates ``uv`` and ``sig``
    IN PLACE and returns them; a launch the card refuses raises.  On CPU
    tensors ``mevp_subcycles_plain`` returns new tensors."""
    return mevp_subcycles_plain(uv, sig, tab, mesh, n)


# the kernel's rheology codes (csrc/mevp_subcycle.cu: kEvp, kMevp, kAevp)
RHEOLOGY = {"evp": 0, "mevp": 1, "aevp": 2}


def run_subcycles(fn, uv: torch.Tensor, sig: torch.Tensor, tab, mesh,
                  n: int):
    """``n`` subcycles of ``fn`` (``mevp_subcycles``, ``evp_subcycles`` or
    ``aevp_subcycles``): one launch on one device; under a dist context
    (``parallel/dist.py``) one launch a subcycle with the velocities'
    halo exchanged after each, on the ice subdomain's schedule where
    ``mesh`` is the subdomain.  Each launch is the kernel as it is, so
    each subcycle stays bitwise with the plain version; exchanging the new
    velocities gives the halo the owners' values as the JAX package's
    exchange of the stress divergence does (its node update is pointwise
    on owner-consistent inputs)."""
    if not in_dist_context():
        return fn(uv, sig, tab, mesh, n)
    sub = on_subdomain(mesh)
    for _ in range(n):
        uv, sig = fn(uv, sig, tab, mesh, 1)
        uv = halo_fix_nodes(uv, sub=sub)
    return uv, sig


def mevp_dynamics(ice: IceState, mesh, forcing: IceForcing,
                  ocean: OceanSurface, cfg, strength_node=None) -> IceState:
    """``cfg.ice.evp_rheol_steps`` subcycles from the state's velocities
    and stresses; ``mesh`` is the mesh or the ice subdomain;
    ``strength_node``: Icepack's strength field (``mevp_setup``)."""
    tab = mevp_setup(ice, mesh, forcing, ocean, cfg,
                     strength_node=strength_node)
    uv = torch.stack([ice.u_ice, ice.v_ice])
    sig = torch.stack([ice.sigma11, ice.sigma12, ice.sigma22])
    uv, sig = run_subcycles(mevp_subcycles, uv, sig, tab, mesh,
                            cfg.ice.evp_rheol_steps)
    return replace(ice, u_ice=uv[0], v_ice=uv[1], sigma11=sig[0],
                   sigma12=sig[1], sigma22=sig[2])


# --------------------------------------------------------------------------
# standard EVP (whichEVP = 0)
# --------------------------------------------------------------------------
# rows of EvpTables.node_c and EvpTables.elem_c
EVP_NODE_ROWS = ("u_w", "v_w", "inv_areamass", "rhs_a", "rhs_m", "inv_mass",
                 "stress_x", "stress_y", "bc", "cor", "has_ice")
EVP_ELEM_ROWS = ("dx0", "dx1", "dx2", "dy0", "dy1", "dy2", "meancos",
                 "strength", "ice_area", "has_ice")


@dataclass
class EvpTables:
    """What one step's standard-EVP subcycles share (``evp_setup``)."""
    node_c: torch.Tensor     # [11, N], rows EVP_NODE_ROWS
    elem_c: torch.Tensor     # [10, E], rows EVP_ELEM_ROWS
    en: torch.Tensor         # [3, E] int32 element nodes, vertex-major
    fuv: Optional[torch.Tensor]  # [2, E, 3] the kernel's scratch, or None
    vale: float              # 1 / ellipse^2
    delta_min: float
    tevp_inv: float          # 1 / Tevp = 3 / ice_dt
    dte: float               # the pseudotime step ice_dt / subcycles
    det: float               # 1 / (1 + tevp_inv dte / 2)
    cd: float                # Cd_oce_ice
    ax: float                # cos(theta_io)
    ay: float                # sin(theta_io)
    checked: bool = False


def evp_setup(ice: IceState, mesh, forcing: IceForcing, ocean: OceanSurface,
              cfg) -> EvpTables:
    """The per-step precomputes of standard EVP
    (``fesom2_tpu/ice/evp.py:143-192``): the element strength, zero where
    any vertex has no ice (ref ice_EVP.F90:493-502), the elevation rhs
    gated on the same mask (:571-579), the node masses (:459-482);
    ``mesh`` is the mesh or the ice subdomain."""
    icfg = cfg.ice
    ice_dt = cfg.dt * icfg.ice_ave_steps
    dte = ice_dt / icfg.evp_rheol_steps
    tevp_inv = 3.0 / ice_dt
    en = mesh.elem_nodes.long()
    dx = mesh.gradient_sca[:, 0:3]
    dy = mesh.gradient_sca[:, 3:6]
    meancos = mesh.metric_factor / 3.0
    area1 = mesh.area[0]
    area1s = torch.where(area1 > 0, area1, 1.0)

    m_e = ice.m_ice[en]
    a_e = ice.a_ice[en]
    has_ice_e = (m_e > 0.0).all(-1) & (a_e > 0.0).all(-1)
    strength = torch.where(
        has_ice_e, 0.5 * icfg.Pstar * m_e.mean(-1)
        * torch.exp(-icfg.c_pressure * (1.0 - a_e.mean(-1))), 0.0)

    eta_e = ocean.elevation[en]
    aa = torch.where(has_ice_e, g * mesh.elem_area / 3.0, 0.0)
    aa_e = aa * (dx * eta_e).sum(-1)
    bb_e = aa * (dy * eta_e).sum(-1)
    rhs_a, rhs_m = elem_contrib_to_nodes(
        torch.stack([-aa_e, -bb_e])[..., None].expand(-1, -1, 3), mesh) \
        / area1s

    mass_n = rhoice * ice.m_ice + rhosno * ice.m_snow
    inv_areamass = torch.where(mass_n > 1e-3, 1.0 / (area1s * mass_n), 0.0)
    has_ice_n = ice.a_ice >= 0.01
    inv_mass = torch.where(
        has_ice_n, 1.0 / torch.clamp_min(
            mass_n / torch.clamp_min(ice.a_ice, 0.01), 9.0), 0.0)

    dt = ice.u_ice.dtype
    node_c = torch.stack([
        ocean.u_w, ocean.v_w, inv_areamass, rhs_a, rhs_m, inv_mass,
        forcing.stress_atmice_x, forcing.stress_atmice_y, mesh.bc_index_node,
        mesh.coriolis_node, has_ice_n.to(dt)])
    elem_c = torch.cat([dx.T, dy.T, torch.stack([
        meancos, strength, torch.where(has_ice_e, mesh.elem_area, 0.0),
        has_ice_e.to(dt)])])
    return EvpTables(
        node_c=node_c, elem_c=elem_c, en=mesh.elem_nodes.T.contiguous(),
        fuv=_scratch(dt, node_c.device, mesh.n_elems),
        vale=1.0 / icfg.ellipse ** 2, delta_min=icfg.delta_min,
        tevp_inv=tevp_inv, dte=dte, det=1.0 / (1.0 + 0.5 * tevp_inv * dte),
        cd=icfg.Cd_oce_ice, ax=math.cos(icfg.theta_io),
        ay=math.sin(icfg.theta_io))


def evp_stress_plain(uv: torch.Tensor, sig: torch.Tensor, tab: EvpTables):
    """The element half of a standard-EVP subcycle
    (``fesom2_tpu/ice/evp.py:196-216``): the elastic relaxation of the
    stresses towards the viscous-plastic ones, where the element has ice.
    Returns (sig [3, E] new, fuv [2, 3, E])."""
    e = tab.elem_c
    strength, ice_area = e[7], e[8]
    has_ice_e = e[9] > 0
    s11, s12, s22 = sig[0], sig[1], sig[2]
    vale, dte, det = tab.vale, tab.dte, tab.det
    eps1, eps2, eps12, delta = _strain_rates(uv, tab)
    zeta = strength / torch.clamp_min(delta, tab.delta_min) * tab.tevp_inv
    r1 = zeta * eps1 - strength * tab.tevp_inv
    r2 = zeta * eps2 * vale
    r3 = zeta * eps12 * vale
    si1 = det * (s11 + s22 + dte * r1)
    si2 = det * (s11 - s22 + dte * r2)
    s12 = torch.where(has_ice_e, det * (s12 + dte * r3), s12)
    s11 = torch.where(has_ice_e, 0.5 * (si1 + si2), s11)
    s22 = torch.where(has_ice_e, 0.5 * (si1 - si2), s22)
    return torch.stack([s11, s12, s22]), _divergence(s11, s12, s22, e,
                                                     ice_area)


def evp_node_plain(uv: torch.Tensor, fuv: torch.Tensor, tab: EvpTables,
                   mesh) -> torch.Tensor:
    """The node half of a standard-EVP subcycle
    (``fesom2_tpu/ice/evp.py:218-232``): explicit in the current velocity,
    drag and Coriolis implicit, 0 where the concentration is under 0.01.
    Returns uv [2, N]."""
    c = tab.node_c
    u, v = uv[0], uv[1]
    u_w, v_w, inv_areamass, rhs_a, rhs_m, inv_mass, sx, sy, bc, cor = c[:10]
    has_ice_n = c[10] > 0
    dte, ax, ay = tab.dte, tab.ax, tab.ay
    rhs2 = elem_contrib_to_nodes_plain(fuv, mesh, vertex_major=True)
    u_rhs = rhs2[0] * inv_areamass + rhs_a
    v_rhs = rhs2[1] * inv_areamass + rhs_m
    umod = torch.sqrt((u - u_w) ** 2 + (v - v_w) ** 2)
    drag = tab.cd * umod * density_0 * inv_mass
    rhsu = u + dte * (drag * (ax * u_w - ay * v_w) + inv_mass * sx + u_rhs)
    rhsv = v + dte * (drag * (ax * v_w + ay * u_w) + inv_mass * sy + v_rhs)
    r_a = 1.0 + ax * drag * dte
    r_b = dte * (cor + ay * drag)
    idet = bc / (r_a ** 2 + r_b ** 2)
    u_new = torch.where(has_ice_n, idet * (r_a * rhsu + r_b * rhsv), 0.0)
    v_new = torch.where(has_ice_n, idet * (r_a * rhsv - r_b * rhsu), 0.0)
    return torch.stack([u_new, v_new])


def evp_subcycle_plain(uv: torch.Tensor, sig: torch.Tensor, tab: EvpTables,
                       mesh):
    """One standard-EVP subcycle as torch ops: (uv, sig) -> new (uv, sig)."""
    sig, fuv = evp_stress_plain(uv, sig, tab)
    return evp_node_plain(uv, fuv, tab, mesh), sig


def evp_subcycles_plain(uv: torch.Tensor, sig: torch.Tensor, tab: EvpTables,
                        mesh, n: int):
    """``n`` subcycles of ``evp_subcycle_plain``: new (uv, sig)."""
    for _ in range(n):
        uv, sig = evp_subcycle_plain(uv, sig, tab, mesh)
    return uv, sig


# --------------------------------------------------------------------------
# adaptive EVP (whichEVP = 2)
# --------------------------------------------------------------------------
AEVP_NODE_ROWS = ("u0", "v0", "u_w", "v_w", "mass", "rhs_a", "rhs_m",
                  "inv_thickness", "stress_x", "stress_y", "bc", "rdt_cor",
                  "beta")
AEVP_ELEM_ROWS = ("dx0", "dx1", "dx2", "dy0", "dy1", "dy2", "meancos", "p0",
                  "det1", "det2", "ice_area", "has_ice")


@dataclass
class AevpTables:
    """What one step's adaptive-EVP subcycles share (``aevp_setup``), and
    what the refresh of alpha and beta after them reads."""
    node_c: torch.Tensor     # [13, N], rows AEVP_NODE_ROWS
    elem_c: torch.Tensor     # [12, E], rows AEVP_ELEM_ROWS
    en: torch.Tensor         # [3, E] int32 element nodes, vertex-major
    fuv: Optional[torch.Tensor]  # [2, E, 3] the kernel's scratch, or None
    vale: float
    delta_min: float
    rdt: float               # the ice time step
    rdt_cd: float            # rdt * Cd_oce_ice
    asum: torch.Tensor       # [E] the elements' mean concentration
    checked: bool = False


def aevp_setup(ice: IceState, mesh, forcing: IceForcing, ocean: OceanSurface,
               cfg) -> AevpTables:
    """The per-step precomputes of adaptive EVP
    (``fesom2_tpu/ice/evp.py:258-290``): mEVP's elevation rhs and node
    factors without the ice mask, the element pressure p0, and the
    relaxation factors of the state's alpha [E] and beta [N].  The node
    mass is ``mass / ((1 + mass^2) area)`` as in the JAX package."""
    icfg = cfg.ice
    ice_dt = cfg.dt * icfg.ice_ave_steps
    en = mesh.elem_nodes.long()
    dx = mesh.gradient_sca[:, 0:3]
    dy = mesh.gradient_sca[:, 3:6]
    meancos = mesh.metric_factor / 3.0
    area1 = mesh.area[0]
    area1s = torch.where(area1 > 0, area1, 1.0)

    eta_e = ocean.elevation[en]
    bb = g * mesh.elem_area / 3.0
    aa_e = bb * (dx * eta_e).sum(-1)
    bb_e = bb * (dy * eta_e).sum(-1)
    rhs_a, rhs_m = elem_contrib_to_nodes(
        torch.stack([-aa_e, -bb_e])[..., None].expand(-1, -1, 3), mesh) \
        / area1s

    has_ice_n = ice.a_ice >= 0.01
    thick = (rhoice * ice.m_ice + rhosno * ice.m_snow) \
        / torch.clamp_min(ice.a_ice, 0.01)
    inv_thickness = torch.where(has_ice_n,
                                1.0 / torch.clamp_min(thick, 9.0), 0.0)
    mass = rhoice * ice.m_ice + rhosno * ice.m_snow
    mass = mass / ((1.0 + mass * mass) * area1s)

    msum = ice.m_ice[en].mean(-1)
    asum = ice.a_ice[en].mean(-1)
    has_ice_e = msum > 0.01
    p0 = icfg.Pstar * msum * torch.exp(-icfg.c_pressure * (1.0 - asum))
    det2 = 1.0 / (1.0 + ice.alpha_aevp)
    det1 = ice.alpha_aevp * det2

    dt = ice.u_ice.dtype
    node_c = torch.stack([
        ice.u_ice, ice.v_ice, ocean.u_w, ocean.v_w, mass, rhs_a, rhs_m,
        inv_thickness, forcing.stress_atmice_x, forcing.stress_atmice_y,
        mesh.bc_index_node, ice_dt * mesh.coriolis_node, ice.beta_aevp])
    elem_c = torch.cat([dx.T, dy.T, torch.stack([
        meancos, p0, det1, det2,
        torch.where(has_ice_e, mesh.elem_area, 0.0), has_ice_e.to(dt)])])
    return AevpTables(
        node_c=node_c, elem_c=elem_c, en=mesh.elem_nodes.T.contiguous(),
        fuv=_scratch(dt, node_c.device, mesh.n_elems),
        vale=1.0 / icfg.ellipse ** 2, delta_min=icfg.delta_min, rdt=ice_dt,
        rdt_cd=ice_dt * icfg.Cd_oce_ice, asum=asum)


def aevp_stress_plain(uv: torch.Tensor, sig: torch.Tensor, tab: AevpTables):
    """The element half of an adaptive-EVP subcycle
    (``fesom2_tpu/ice/evp.py:310-324``): mEVP's stress update with the
    element's own relaxation factors.  Returns (sig [3, E], fuv [2, 3, E])."""
    e = tab.elem_c
    p0, det1, det2, ice_area = e[7], e[8], e[9], e[10]
    has_ice_e = e[11] > 0
    s11, s12, s22 = sig[0], sig[1], sig[2]
    vale = tab.vale
    eps1, eps2, eps12, delta = _strain_rates(uv, tab)
    pressure = p0 / (delta + tab.delta_min)
    r1 = pressure * (eps1 - delta)
    r2 = pressure * eps2 * vale
    r3 = pressure * eps12 * vale
    si1 = det1 * (s11 + s22) + det2 * r1
    si2 = det1 * (s11 - s22) + det2 * r2
    s12 = torch.where(has_ice_e, det1 * s12 + det2 * r3, s12)
    s11 = torch.where(has_ice_e, 0.5 * (si1 + si2), s11)
    s22 = torch.where(has_ice_e, 0.5 * (si1 - si2), s22)
    return torch.stack([s11, s12, s22]), _divergence(s11, s12, s22, e,
                                                     ice_area)


def aevp_node_plain(uv: torch.Tensor, fuv: torch.Tensor, tab: AevpTables,
                    mesh) -> torch.Tensor:
    """The node half of an adaptive-EVP subcycle
    (``fesom2_tpu/ice/evp.py:326-338``): mEVP's point-implicit update with
    the node's own beta and no ice mask.  Returns uv [2, N]."""
    c = tab.node_c
    u, v = uv[0], uv[1]
    u0, v0, u_w, v_w, mass, rhs_a, rhs_m, inv_thickness, sx, sy, bc, fc, \
        beta = c
    rdt = tab.rdt
    rhs2 = elem_contrib_to_nodes_plain(fuv, mesh, vertex_major=True)
    u_rhs = rhs2[0] * mass + rhs_a
    v_rhs = rhs2[1] * mass + rhs_m
    umod = torch.sqrt((u - u_w) ** 2 + (v - v_w) ** 2)
    drag = tab.rdt_cd * umod * density_0 * inv_thickness
    rhsu = u0 + drag * u_w + rdt * (inv_thickness * sx + u_rhs) + beta * u
    rhsv = v0 + drag * v_w + rdt * (inv_thickness * sy + v_rhs) + beta * v
    idet = bc / ((1.0 + beta + drag) ** 2 + fc ** 2)
    u_new = idet * ((1.0 + beta + drag) * rhsu + fc * rhsv)
    v_new = idet * ((1.0 + beta + drag) * rhsv - fc * rhsu)
    return torch.stack([u_new, v_new])


def aevp_subcycle_plain(uv: torch.Tensor, sig: torch.Tensor,
                        tab: AevpTables, mesh):
    """One adaptive-EVP subcycle as torch ops: (uv, sig) -> new (uv, sig)."""
    sig, fuv = aevp_stress_plain(uv, sig, tab)
    return aevp_node_plain(uv, fuv, tab, mesh), sig


def aevp_subcycles_plain(uv: torch.Tensor, sig: torch.Tensor,
                         tab: AevpTables, mesh, n: int):
    """``n`` subcycles of ``aevp_subcycle_plain``: new (uv, sig)."""
    for _ in range(n):
        uv, sig = aevp_subcycle_plain(uv, sig, tab, mesh)
    return uv, sig


def aevp_refresh(uv: torch.Tensor, alpha: torch.Tensor, tab: AevpTables,
                 mesh, cfg):
    """alpha [E] and beta [N] refreshed from the converged velocities
    (``fesom2_tpu/ice/evp.py:341-353``; ref find_alpha_field_a,
    find_beta_field_a): alpha where the element has ice, beta the largest
    alpha of the node's elements, a padded slot counting as 50.
    Returns (alpha, beta)."""
    icfg = cfg.ice
    ice_dt = cfg.dt * icfg.ice_ave_steps
    _, _, _, delta = _strain_rates(uv, tab)
    p_adapt = icfg.Pstar * torch.exp(-icfg.c_pressure * (1.0 - tab.asum)) \
        / (delta + icfg.delta_min)
    alpha_new = torch.clamp_min(torch.sqrt(
        ice_dt * icfg.c_aevp * p_adapt / rhoice / mesh.elem_area), 50.0)
    alpha = torch.where(tab.elem_c[11] > 0, alpha_new, alpha)
    nie = mesh.nod_in_elem.long().T              # [K, N]
    valid = nie >= 0
    av = torch.where(valid, alpha[torch.where(valid, nie, 0)], 50.0)
    return alpha, halo_fix_nodes(av.max(0).values, sub=on_subdomain(mesh))


# --------------------------------------------------------------------------
# the kernel's launches for the other two rheologies
# --------------------------------------------------------------------------
def evp_subcycles_work(n_nodes: int, n_elems: int, k_max: int,
                       itemsize: int, n_sub: int) -> tuple:
    """(bytes, flops) of ``n_sub`` standard-EVP subcycles in one call:
    each input once (uv, sig, ``elem_c`` [10, E], ``node_c`` [11, N], the
    element nodes, the slot words) and each output once (uv, sig); each
    subcycle about 75 operations an element and 2 K adds and about 45
    operations a node."""
    nbytes = ((2 + len(EVP_NODE_ROWS) + 2) * n_nodes
              + (3 + len(EVP_ELEM_ROWS) + 3) * n_elems) * itemsize \
        + (3 * n_elems + k_max * n_nodes) * 4
    return nbytes, n_sub * (75 * n_elems + (2 * k_max + 45) * n_nodes)


def aevp_subcycles_work(n_nodes: int, n_elems: int, k_max: int,
                        itemsize: int, n_sub: int) -> tuple:
    """(bytes, flops) of ``n_sub`` adaptive-EVP subcycles in one call:
    each input once (uv, sig, ``elem_c`` [12, E], ``node_c`` [13, N], the
    element nodes, the slot words) and each output once; each subcycle
    about 72 operations an element and 2 K adds and about 40 a node."""
    nbytes = ((2 + len(AEVP_NODE_ROWS) + 2) * n_nodes
              + (3 + len(AEVP_ELEM_ROWS) + 3) * n_elems) * itemsize \
        + (3 * n_elems + k_max * n_nodes) * 4
    return nbytes, n_sub * (72 * n_elems + (2 * k_max + 40) * n_nodes)


def evp_subcycles(uv: torch.Tensor, sig: torch.Tensor, tab: EvpTables, mesh,
                  n: int):
    """``n`` standard-EVP subcycles: (uv [2, N], sig [3, E]) -> (uv, sig).
    On CUDA tensors one launch of the cooperative kernel updates ``uv``
    and ``sig`` IN PLACE; on CPU tensors ``evp_subcycles_plain`` returns
    new tensors."""
    return evp_subcycles_plain(uv, sig, tab, mesh, n)


def aevp_subcycles(uv: torch.Tensor, sig: torch.Tensor, tab: AevpTables,
                   mesh, n: int):
    """``n`` adaptive-EVP subcycles: (uv [2, N], sig [3, E]) -> (uv, sig).
    On CUDA tensors one launch of the cooperative kernel updates ``uv``
    and ``sig`` IN PLACE; on CPU tensors ``aevp_subcycles_plain`` returns
    new tensors."""
    return aevp_subcycles_plain(uv, sig, tab, mesh, n)


def evp_dynamics(ice: IceState, mesh, forcing: IceForcing,
                 ocean: OceanSurface, cfg) -> IceState:
    """Standard EVP (whichEVP = 0; ref ice_EVP.F90 EVPdynamics :397-667):
    ``cfg.ice.evp_rheol_steps`` explicit pseudotime subcycles with the
    elastic relaxation time Tevp = ice_dt / 3."""
    tab = evp_setup(ice, mesh, forcing, ocean, cfg)
    uv = torch.stack([ice.u_ice, ice.v_ice])
    sig = torch.stack([ice.sigma11, ice.sigma12, ice.sigma22])
    uv, sig = run_subcycles(evp_subcycles, uv, sig, tab, mesh,
                            cfg.ice.evp_rheol_steps)
    return replace(ice, u_ice=uv[0], v_ice=uv[1], sigma11=sig[0],
                   sigma12=sig[1], sigma22=sig[2])


def aevp_dynamics(ice: IceState, mesh, forcing: IceForcing,
                  ocean: OceanSurface, cfg) -> IceState:
    """Adaptive EVP (whichEVP = 2, Kimmritz et al. 2016; ref ice_maEVP.F90
    EVPdynamics_a :785-888): mEVP with the per-element alpha and per-node
    beta of the state, refreshed after the subcycles."""
    tab = aevp_setup(ice, mesh, forcing, ocean, cfg)
    uv = torch.stack([ice.u_ice, ice.v_ice])
    sig = torch.stack([ice.sigma11, ice.sigma12, ice.sigma22])
    uv, sig = run_subcycles(aevp_subcycles, uv, sig, tab, mesh,
                            cfg.ice.evp_rheol_steps)
    alpha, beta = aevp_refresh(uv, ice.alpha_aevp, tab, mesh, cfg)
    return replace(ice, u_ice=uv[0], v_ice=uv[1], sigma11=sig[0],
                   sigma12=sig[1], sigma22=sig[2], alpha_aevp=alpha,
                   beta_aevp=beta)


# --------------------------------------------------------------------------
# the dispatch
# --------------------------------------------------------------------------
def dynamics_of(cfg):
    """The dynamics of ``cfg.ice.whichEVP``: 0 standard, 2 adaptive, any
    other value modified EVP (``fesom2_tpu/ice/evp.py:359-378``)."""
    return {0: evp_dynamics, 2: aevp_dynamics}.get(cfg.ice.whichEVP,
                                                    mevp_dynamics)


def ice_dynamics(ice: IceState, mesh, forcing: IceForcing,
                 ocean: OceanSurface, cfg, strength_node=None,
                 sub=None) -> IceState:
    """Dispatch on whichEVP (ref ice_setup_step.F90:195-208): 0 standard,
    2 adaptive, any other value modified EVP, as in the JAX package.
    ``strength_node`` (Icepack builds): the node strength mEVP takes in
    place of the P* closure; standard and adaptive EVP drop it, as the JAX
    package does.  ``sub`` (IceSubdomain) restricts the subcycle loop to
    the polar caps, exact while all ice stays inside (ice/subdomain.py)."""
    if sub is not None:
        return ice_dynamics_sub(ice, mesh, sub, forcing, ocean, cfg,
                                strength_node=strength_node)
    return _dynamics(cfg, ice, mesh, forcing, ocean, strength_node)


def _dynamics(cfg, ice, mesh, forcing, ocean, strength_node):
    """The rheology of ``cfg``, with the strength field under mEVP."""
    fn = dynamics_of(cfg)
    if fn is mevp_dynamics and strength_node is not None:
        return fn(ice, mesh, forcing, ocean, cfg, strength_node=strength_node)
    return fn(ice, mesh, forcing, ocean, cfg)


def subdomain_inputs(ice: IceState, sub, forcing: IceForcing,
                     ocean: OceanSurface, aevp: bool = False):
    """(ice, forcing, ocean) with the fields the dynamics read gathered into
    the subdomain's numbering (one packed gather of ten node fields, one
    of the three stresses; under adaptive EVP beta joins the first and
    alpha the second)."""
    gn = sub.sub_nodes.long()
    ge = sub.sub_elems.long()
    nodal = [ice.u_ice, ice.v_ice, ice.m_ice, ice.a_ice, ice.m_snow,
             forcing.stress_atmice_x, forcing.stress_atmice_y, ocean.u_w,
             ocean.v_w, ocean.elevation]
    elem = [ice.sigma11, ice.sigma12, ice.sigma22]
    if aevp:
        nodal.append(ice.beta_aevp)
        elem.append(ice.alpha_aevp)
    loc = torch.stack(nodal)[:, gn]
    se = torch.stack(elem)[:, ge]
    ice_l = replace(ice, u_ice=loc[0], v_ice=loc[1], m_ice=loc[2],
                    a_ice=loc[3], m_snow=loc[4],
                    sigma11=se[0], sigma12=se[1], sigma22=se[2])
    if aevp:
        ice_l = replace(ice_l, alpha_aevp=se[3], beta_aevp=loc[10])
    forcing_l = replace(forcing, stress_atmice_x=loc[5],
                        stress_atmice_y=loc[6])
    ocean_l = replace(ocean, u_w=loc[7], v_w=loc[8], elevation=loc[9])
    return ice_l, forcing_l, ocean_l


def ice_dynamics_sub(ice: IceState, mesh, sub, forcing: IceForcing,
                     ocean: OceanSurface, cfg, strength_node=None) -> IceState:
    """The dynamics on the ice subdomain: the packed gather in, the
    unchanged functions on the restricted tables (adaptive EVP's refresh
    on the subdomain's ``nod_in_elem``, so a cap-edge node's beta is the
    largest alpha of its subdomain elements), and an indexed copy of (u,
    v), the stresses (and alpha, beta) out (``sub_nodes`` and
    ``sub_elems`` hold no index twice)."""
    gn = sub.sub_nodes.long()
    ge = sub.sub_elems.long()
    aevp = cfg.ice.whichEVP == 2
    ice_l, forcing_l, ocean_l = subdomain_inputs(ice, sub, forcing, ocean,
                                                 aevp)
    sn_l = None if strength_node is None else strength_node[gn]
    out = _dynamics(cfg, ice_l, sub, forcing_l, ocean_l, sn_l)

    uv = torch.stack([ice.u_ice, ice.v_ice])
    uv[:, gn] = torch.stack([out.u_ice, out.v_ice])
    sig_old = [ice.sigma11, ice.sigma12, ice.sigma22]
    sig_new = [out.sigma11, out.sigma12, out.sigma22]
    if aevp:
        sig_old.append(ice.alpha_aevp)
        sig_new.append(out.alpha_aevp)
    sig = torch.stack(sig_old)
    sig[:, ge] = torch.stack(sig_new)
    res = replace(ice, u_ice=uv[0], v_ice=uv[1],
                  sigma11=sig[0], sigma12=sig[1], sigma22=sig[2])
    if aevp:
        beta = ice.beta_aevp.clone()
        beta[gn] = out.beta_aevp
        res = replace(res, alpha_aevp=sig[3], beta_aevp=beta)
    return res


def ridging_rates(ice: IceState, mesh, cfg):
    """Node convergence and shear closing rates for icepack's mechanical
    redistribution, from the velocities after the solve
    (``fesom2_tpu/ice/evp.py:437-469``; ref ice_maEVP.F90:115-127):
    rdg_conv = -min(div, 0), rdg_shear = (delta - |div|) / 2 per element,
    averaged to nodes by area.  Returns (conv [N], shear [N])."""
    vale = 1.0 / cfg.ice.ellipse ** 2
    en = mesh.elem_nodes.long()
    dx = mesh.gradient_sca[:, 0:3]
    dy = mesh.gradient_sca[:, 3:6]
    meancos = mesh.metric_factor / 3.0
    ue = ice.u_ice[en]
    ve = ice.v_ice[en]
    eps11 = (dx * ue).sum(-1) - ve.sum(-1) * meancos
    eps22 = (dy * ve).sum(-1)
    eps12 = 0.5 * ((dy * ue).sum(-1) + (dx * ve).sum(-1)
                   + ue.sum(-1) * meancos)
    div = eps11 + eps22
    eps2 = eps11 - eps22
    delta = torch.sqrt(div ** 2 + vale * (eps2 ** 2 + 4.0 * eps12 ** 2))
    conv_e = torch.clamp_min(-div, 0.0)
    shear_e = 0.5 * (delta - div.abs())
    w = mesh.elem_area / 3.0
    area1 = mesh.area[0]
    inv = torch.where(area1 > 0,
                      1.0 / torch.where(area1 > 0, area1, 1.0), 0.0)
    conv, shear = elem_contrib_to_nodes(
        torch.stack([conv_e * w, shear_e * w])[..., None].expand(-1, -1, 3),
        mesh) * inv
    return conv, shear
