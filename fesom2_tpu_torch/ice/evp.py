"""Sea-ice dynamics: mEVP solver (Bouillon et al. 2013 style).

The port of ``fesom2_tpu/ice/evp.py`` for ``whichEVP = 1``, the CI
default (``src/ice_maEVP.F90`` EVPdynamics_m :273-602).  Each pseudotime
iteration: element stress update -> stress divergence gathered to nodes ->
point-implicit node update with Coriolis and ocean drag -> Dirichlet
coastal BC.

``mevp_setup`` computes what is constant over the subcycles once per step
(plain torch ops) and packs it into two tables, ``node_c`` [13, N] and
``elem_c`` [10, E].  One subcycle is then ``mevp_subcycle``, that is
``mevp_stress`` and ``mevp_node``: on a CUDA tensor two hand-written
kernels (``csrc/mevp_subcycle.cu``: a thread per element, and a thread per
node, which also does the node assembly of the stress divergence in slot
order) that update the velocities and stresses in place; on a CPU tensor
``mevp_stress_plain`` and ``mevp_node_plain`` (together
``mevp_subcycle_plain``), the loop body as torch ops in the same order of
operations.  A CUDA tensor
goes through the kernels or the call raises.

Standard EVP (``whichEVP = 0``), adaptive EVP (2) and the icepack strength
field are not ported: ``ice_dynamics`` raises for them.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from .. import kernels
from ..constants import g, density_0
from ..core.ops import elem_contrib_to_nodes, elem_contrib_to_nodes_plain
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
    fuv: Optional[torch.Tensor]  # [2, 3, E] scratch of the kernels, or None
    det1: float              # alpha / (1 + alpha)
    vale: float              # 1 / ellipse^2
    delta_min: float
    rdt: float               # the ice time step
    rdt_cd: float            # rdt * Cd_oce_ice
    beta: float
    checked: bool = False    # the kernels' view of the tables was verified


def mevp_setup(ice: IceState, mesh, forcing: IceForcing,
               ocean: OceanSurface, cfg) -> MevpTables:
    """The per-step precomputes of mEVP (``fesom2_tpu/ice/evp.py:33-81``):
    the elevation rhs, the node masses and thickness factors, the element
    pressure factor; ``mesh`` is the mesh or the ice subdomain, and the
    fields of ``ice``, ``forcing`` and ``ocean`` are numbered as it is."""
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
    on_card = node_c.device.type == "cuda"
    return MevpTables(
        node_c=node_c, elem_c=elem_c, en=mesh.elem_nodes.T.contiguous(),
        fuv=torch.empty((2, 3, mesh.n_elems), dtype=dt, device=node_c.device)
        if on_card else None,
        det1=det1, vale=1.0 / icfg.ellipse ** 2, delta_min=icfg.delta_min,
        rdt=ice_dt, rdt_cd=ice_dt * icfg.Cd_oce_ice, beta=icfg.beta_evp)


def _sum3(a: torch.Tensor) -> torch.Tensor:
    """The sum over an element's three vertices, in vertex order."""
    return a[0] + a[1] + a[2]


def mevp_stress_plain(uv: torch.Tensor, sig: torch.Tensor, tab: MevpTables):
    """The element half of a subcycle (``fesom2_tpu/ice/evp.py:85-105``):
    strain rates from the velocities at the three vertices, the stress
    update where the element has ice, and the stress divergence each
    element adds to its vertices.  Returns (sig [3, E] new, fuv [2, 3, E])."""
    e = tab.elem_c
    en = tab.en.long()
    ue, ve = uv[0][en], uv[1][en]                   # [3, E]
    dx, dy, meancos, pfac, ice_area = e[0:3], e[3:6], e[6], e[7], e[8]
    has_ice_e = e[9] > 0
    s11, s12, s22 = sig[0], sig[1], sig[2]
    vale = tab.vale
    eps11 = _sum3(dx * ue) - _sum3(ve) * meancos
    eps22 = _sum3(dy * ve)
    eps12 = 0.5 * (_sum3(dy * ue) + _sum3(dx * ve) + _sum3(ue) * meancos)
    eps1 = eps11 + eps22
    eps2 = eps11 - eps22
    delta = torch.sqrt(eps1 ** 2 + vale * (eps2 ** 2 + 4.0 * eps12 ** 2))
    pressure = pfac / (delta + tab.delta_min)
    s12 = torch.where(has_ice_e, tab.det1 * s12 + pressure * eps12 * vale, s12)
    s11 = torch.where(
        has_ice_e,
        tab.det1 * s11 + 0.5 * pressure * (eps1 - delta + eps2 * vale), s11)
    s22 = torch.where(
        has_ice_e,
        tab.det1 * s22 + 0.5 * pressure * (eps1 - delta - eps2 * vale), s22)
    # stress divergence to nodes (ref :516-545), vertex-major [2, 3, E]
    fu = -ice_area * (s11 * dx + s12 * (dy + meancos))
    fv = -ice_area * (s12 * dx + s22 * dy - s11 * meancos)
    return torch.stack([s11, s12, s22]), torch.stack([fu, fv])


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


def mevp_subcycle_work(n_nodes: int, n_elems: int, k_max: int,
                       itemsize: int) -> dict:
    """(bytes, flops) of the two kernels of one subcycle.  ``mevp_stress``:
    uv, the element nodes, ``elem_c``, the stresses read and written, fuv
    written; about 70 operations an element.  ``mevp_node``: fuv, the two
    [N, K] tables, ``node_c``, uv read and written; 2 K adds and about 45
    operations a node."""
    stress = ((2 * n_nodes + (len(ELEM_ROWS) + 3 + 3 + 6) * n_elems)
              * itemsize + 3 * n_elems * 4, 70 * n_elems)
    node = ((6 * n_elems + (len(NODE_ROWS) + 2 + 2) * n_nodes) * itemsize
            + 2 * n_nodes * k_max * 4, (2 * k_max + 45) * n_nodes)
    return {"mevp_stress": stress, "mevp_node": node}


def _check_tables(tab: MevpTables, mesh, dev, dt) -> None:
    N, E = mesh.n_nodes, mesh.n_elems
    K = mesh.nod_in_elem.shape[1]
    kernels.require(tab.node_c, "node_c", (len(NODE_ROWS), N), dt, dev)
    kernels.require(tab.elem_c, "elem_c", (len(ELEM_ROWS), E), dt, dev)
    kernels.require(tab.en, "en", (3, E), torch.int32, dev)
    if tab.fuv is None:
        raise ValueError("fuv: the kernels' scratch was not allocated "
                         "(tables made for the CPU)")
    kernels.require(tab.fuv, "fuv", (2, 3, E), dt, dev)
    kernels.require(mesh.nod_in_elem, "nod_in_elem", (N, K), torch.int32, dev)
    kernels.require(mesh.nod_in_elem_slot, "nod_in_elem_slot", (N, K),
                    torch.int32, dev)
    tab.checked = True


def _check_call(uv, sig, tab: MevpTables, mesh) -> int:
    """Raise unless the kernels can read these tensors through raw
    pointers; returns the dtype's code.  The per-step tables are verified
    once (``tab.checked``), uv and sig at every call."""
    kernels.cuda_only(uv, "mevp_subcycle")
    dev, dt = uv.device, uv.dtype
    kernels.require(uv, "uv", (2, mesh.n_nodes), dt, dev)
    if sig is not None:
        kernels.require(sig, "sig", (3, mesh.n_elems), dt, dev)
    if not tab.checked:
        _check_tables(tab, mesh, dev, dt)
    return kernels.float_code(dt)


def mevp_stress(uv: torch.Tensor, sig: torch.Tensor, tab: MevpTables, mesh):
    """The element half of a subcycle: (sig, fuv).  On a CUDA tensor the
    kernel updates ``sig`` IN PLACE and writes ``tab.fuv``; on a CPU tensor
    ``mevp_stress_plain`` returns new tensors."""
    if uv.device.type == "cpu":
        return mevp_stress_plain(uv, sig, tab)
    code = _check_call(uv, sig, tab, mesh)
    kernels.launch("mevp_stress", uv.device, uv, mesh.n_nodes, tab.en,
                   mesh.n_elems, tab.elem_c, sig, tab.fuv, tab.det1, tab.vale,
                   tab.delta_min, code)
    return sig, tab.fuv


def mevp_node(uv: torch.Tensor, fuv: torch.Tensor, tab: MevpTables, mesh):
    """The node half of a subcycle: uv.  On a CUDA tensor the kernel
    updates ``uv`` IN PLACE (each thread its own node); on a CPU tensor
    ``mevp_node_plain`` returns a new tensor."""
    if uv.device.type == "cpu":
        return mevp_node_plain(uv, fuv, tab, mesh)
    code = _check_call(uv, None, tab, mesh)
    kernels.require(fuv, "fuv", (2, 3, mesh.n_elems), uv.dtype, uv.device)
    kernels.launch("mevp_node", uv.device, uv, mesh.n_nodes, fuv,
                   mesh.n_elems, mesh.nod_in_elem, mesh.nod_in_elem_slot,
                   mesh.nod_in_elem.shape[1], tab.node_c, tab.rdt, tab.rdt_cd,
                   density_0, tab.beta, code)
    return uv


def mevp_subcycle(uv: torch.Tensor, sig: torch.Tensor, tab: MevpTables,
                  mesh):
    """One mEVP subcycle: (uv [2, N], sig [3, E]) -> (uv, sig).  On CUDA
    tensors the two kernels update ``uv`` and ``sig`` IN PLACE and return
    them; on CPU tensors the plain versions return new tensors.  The
    element kernel reads the velocities of the previous subcycle only, and
    the node kernel writes its own node only, so one buffer of each does."""
    sig, fuv = mevp_stress(uv, sig, tab, mesh)
    return mevp_node(uv, fuv, tab, mesh), sig


def mevp_dynamics(ice: IceState, mesh, forcing: IceForcing,
                  ocean: OceanSurface, cfg) -> IceState:
    """``cfg.ice.evp_rheol_steps`` subcycles from the state's velocities
    and stresses; ``mesh`` is the mesh or the ice subdomain."""
    tab = mevp_setup(ice, mesh, forcing, ocean, cfg)
    uv = torch.stack([ice.u_ice, ice.v_ice])
    sig = torch.stack([ice.sigma11, ice.sigma12, ice.sigma22])
    for _ in range(cfg.ice.evp_rheol_steps):
        uv, sig = mevp_subcycle(uv, sig, tab, mesh)
    return replace(ice, u_ice=uv[0], v_ice=uv[1], sigma11=sig[0],
                   sigma12=sig[1], sigma22=sig[2])


def ice_dynamics(ice: IceState, mesh, forcing: IceForcing,
                 ocean: OceanSurface, cfg, strength_node=None,
                 sub=None) -> IceState:
    """Dispatch on whichEVP (ref ice_setup_step.F90:195-208); only mEVP is
    ported.  ``sub`` (IceSubdomain) restricts the subcycle loop to the
    polar caps, exact while all ice stays inside (ice/subdomain.py)."""
    if strength_node is not None:
        raise NotImplementedError("the icepack strength field is not ported "
                                  "yet (ROADMAP queue 1 item 18)")
    if cfg.ice.whichEVP != 1:
        raise NotImplementedError(
            f"whichEVP={cfg.ice.whichEVP} (standard or adaptive EVP) is not "
            "ported yet (ROADMAP queue 1 item 17)")
    if sub is not None:
        return ice_dynamics_sub(ice, mesh, sub, forcing, ocean, cfg)
    return mevp_dynamics(ice, mesh, forcing, ocean, cfg)


def subdomain_inputs(ice: IceState, sub, forcing: IceForcing,
                     ocean: OceanSurface):
    """(ice, forcing, ocean) with the fields mEVP reads gathered into the
    subdomain's numbering (one packed gather of ten node fields, one of
    the three stresses)."""
    gn = sub.sub_nodes.long()
    ge = sub.sub_elems.long()
    loc = torch.stack([ice.u_ice, ice.v_ice, ice.m_ice, ice.a_ice,
                       ice.m_snow, forcing.stress_atmice_x,
                       forcing.stress_atmice_y, ocean.u_w, ocean.v_w,
                       ocean.elevation])[:, gn]
    se = torch.stack([ice.sigma11, ice.sigma12, ice.sigma22])[:, ge]
    ice_l = replace(ice, u_ice=loc[0], v_ice=loc[1], m_ice=loc[2],
                    a_ice=loc[3], m_snow=loc[4],
                    sigma11=se[0], sigma12=se[1], sigma22=se[2])
    forcing_l = replace(forcing, stress_atmice_x=loc[5],
                        stress_atmice_y=loc[6])
    ocean_l = replace(ocean, u_w=loc[7], v_w=loc[8], elevation=loc[9])
    return ice_l, forcing_l, ocean_l


def ice_dynamics_sub(ice: IceState, mesh, sub, forcing: IceForcing,
                     ocean: OceanSurface, cfg) -> IceState:
    """mEVP on the ice subdomain: the packed gather in, the unchanged
    functions on the restricted tables, and an indexed copy of (u, v) and
    the stresses out (``sub_nodes`` and ``sub_elems`` hold no index
    twice)."""
    gn = sub.sub_nodes.long()
    ge = sub.sub_elems.long()
    ice_l, forcing_l, ocean_l = subdomain_inputs(ice, sub, forcing, ocean)
    out = mevp_dynamics(ice_l, sub, forcing_l, ocean_l, cfg)

    uv = torch.stack([ice.u_ice, ice.v_ice])
    uv[:, gn] = torch.stack([out.u_ice, out.v_ice])
    sig = torch.stack([ice.sigma11, ice.sigma12, ice.sigma22])
    sig[:, ge] = torch.stack([out.sigma11, out.sigma12, out.sigma22])
    return replace(ice, u_ice=uv[0], v_ice=uv[1],
                   sigma11=sig[0], sigma12=sig[1], sigma22=sig[2])
