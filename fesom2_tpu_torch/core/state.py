"""Model state dataclasses of tensors (the port of ``fesom2_tpu/core/state.py``).

All arrays are dense ``[levels, entities]`` with inactive (below-bottom)
entries zero.  The step is a transition ``state -> new state``; fields are
replaced, never written in place, so a caller may keep an earlier state.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace

import torch

from ..mesh import MeshTables


@dataclass
class OceanState:
    """Prognostic + persistent-diagnostic ocean state (field meanings as in
    ``fesom2_tpu/core/state.py:OceanState``)."""
    u: torch.Tensor            # [nl-1, E]
    v: torch.Tensor
    u_rhsAB: torch.Tensor      # [nl-1, E] Adams-Bashforth memory
    v_rhsAB: torch.Tensor
    eta: torch.Tensor          # [N]
    hbar: torch.Tensor
    hbar_old: torch.Tensor
    ssh_rhs_old: torch.Tensor
    d_eta: torch.Tensor
    d_eta_prev: torch.Tensor
    tr: torch.Tensor           # [ntr, nl-1, N]
    tr_old: torch.Tensor
    w: torch.Tensor            # [nl, N]
    w_e: torch.Tensor
    w_i: torch.Tensor
    cfl_z: torch.Tensor
    hnode: torch.Tensor        # [nl-1, N]
    hnode_new: torch.Tensor
    helem: torch.Tensor        # [nl-1, E]
    zbar_3d: torch.Tensor      # [nl, N]
    Z_3d: torch.Tensor         # [nl-1, N]
    Av: torch.Tensor           # [nl, E]
    Kv: torch.Tensor           # [nl, N]
    Kv_s: torch.Tensor
    mixlength: torch.Tensor    # [N]
    tke: torch.Tensor          # [nl, N]
    iwe: torch.Tensor
    iwe_diss: torch.Tensor
    iwe_alpha_c: torch.Tensor
    kpp_nonloc: torch.Tensor
    density_m_rho0: torch.Tensor   # [nl-1, N]
    hpressure: torch.Tensor
    bvfreq: torch.Tensor       # [nl, N]
    dbsfc: torch.Tensor
    mld1: torch.Tensor         # [N]
    mld2: torch.Tensor
    pgf_x: torch.Tensor        # [nl-1, E]
    pgf_y: torch.Tensor
    unode: torch.Tensor        # [nl-1, N]
    vnode: torch.Tensor
    uke: torch.Tensor          # [nl-1, E]
    uke_rhs: torch.Tensor
    fer_u: torch.Tensor        # [nl-1, 0] unless GM output is wanted
    fer_v: torch.Tensor
    fer_w: torch.Tensor
    fer_K3: torch.Tensor
    fer_c: torch.Tensor
    dvd_h: torch.Tensor        # [n_dvd, nl-1, N]: 2 under ldiag_DVD, else 0
    dvd_v: torch.Tensor
    step: torch.Tensor         # int32 scalar


@dataclass
class Forcing:
    """Surface forcing fields (as ``fesom2_tpu/core/state.py:Forcing``)."""
    stress_x: torch.Tensor     # [E]
    stress_y: torch.Tensor
    heat_flux: torch.Tensor    # [N]
    water_flux: torch.Tensor
    virtual_salt: torch.Tensor
    relax_salt: torch.Tensor
    real_salt_flux: torch.Tensor
    stress_atm_x: torch.Tensor
    stress_atm_y: torch.Tensor
    u_ice: torch.Tensor
    v_ice: torch.Tensor
    a_ice: torch.Tensor
    thdgr: torch.Tensor
    ssh_gp: torch.Tensor
    m_ice: torch.Tensor
    m_snow: torch.Tensor
    press_air: torch.Tensor
    prec_rain: torch.Tensor


def field_names(cls) -> list:
    return [f.name for f in fields(cls)]


def allocate_state(mesh: MeshTables, n_tracers: int = 2,
                   dtype=torch.float64, n_dvd: int = 0,
                   with_gm: bool = False) -> OceanState:
    nl, N, E = mesh.nl, mesh.n_nodes, mesh.n_elems
    Eg, Ng = (E, N) if with_gm else (0, 0)
    dev = mesh.zbar.device
    z = lambda *s: torch.zeros(s, dtype=dtype, device=dev)
    return OceanState(
        u=z(nl - 1, E), v=z(nl - 1, E),
        u_rhsAB=z(nl - 1, E), v_rhsAB=z(nl - 1, E),
        eta=z(N), hbar=z(N), hbar_old=z(N), ssh_rhs_old=z(N),
        d_eta=z(N), d_eta_prev=z(N),
        tr=z(n_tracers, nl - 1, N), tr_old=z(n_tracers, nl - 1, N),
        w=z(nl, N), w_e=z(nl, N), w_i=z(nl, N), cfl_z=z(nl, N),
        hnode=z(nl - 1, N), hnode_new=z(nl - 1, N), helem=z(nl - 1, E),
        zbar_3d=z(nl, N), Z_3d=z(nl - 1, N),
        Av=z(nl, E), Kv=z(nl, N), Kv_s=z(nl, N), mixlength=z(N),
        tke=z(nl, N), iwe=z(nl, N), iwe_diss=z(nl, N), iwe_alpha_c=z(nl, N),
        kpp_nonloc=z(nl, N),
        density_m_rho0=z(nl - 1, N), hpressure=z(nl - 1, N),
        bvfreq=z(nl, N), dbsfc=z(nl, N), mld1=z(N), mld2=z(N),
        pgf_x=z(nl - 1, E), pgf_y=z(nl - 1, E),
        unode=z(nl - 1, N), vnode=z(nl - 1, N),
        uke=z(nl - 1, E), uke_rhs=z(nl - 1, E),
        fer_u=z(nl - 1, Eg), fer_v=z(nl - 1, Eg), fer_w=z(nl, Ng),
        fer_K3=z(nl, Ng), fer_c=z(Ng),
        dvd_h=z(n_dvd, nl - 1, N), dvd_v=z(n_dvd, nl - 1, N),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def zero_forcing(mesh: MeshTables, dtype=torch.float64) -> Forcing:
    N, E = mesh.n_nodes, mesh.n_elems
    dev = mesh.zbar.device
    z = lambda n: torch.zeros(n, dtype=dtype, device=dev)
    return Forcing(stress_x=z(E), stress_y=z(E),
                   **{name: z(N) for name in field_names(Forcing)[2:]})


def initial_z3d(mesh: MeshTables, dtype):
    """Unperturbed interface/mid depths per node (zbar_3d, Z_3d) (ref
    init_ale, oce_ale.F90:160-194): standard levels above the bottom,
    ``zbar_n_bot`` at the bottom interface (partial cells), the bottom
    layer's mid depth halfway between its top and the partial bottom."""
    nl = mesh.nl
    dev = mesh.zbar.device
    zbar = mesh.zbar.to(dtype)
    Z = mesh.Z.to(dtype)
    nln = mesh.nlevels_node.long()
    znb = mesh.zbar_n_bot.to(dtype)
    lay = torch.arange(nl - 1, device=dev)
    lev = torch.arange(nl, device=dev)
    zbar_3d = torch.where(lev[:, None] < nln[None, :] - 1, zbar[:, None],
                          znb[None, :])
    zmid_bot = 0.5 * (zbar[torch.clamp_min(nln - 2, 0)] + znb)
    Z_3d = torch.where(lay[:, None] < nln[None, :] - 2, Z[:, None],
                       zmid_bot[None, :])
    return zbar_3d, Z_3d


def init_thickness_linfs(state: OceanState, mesh: MeshTables) -> OceanState:
    """hnode/helem/zbar_3d/Z_3d of the unperturbed column (eta = 0)
    (ref init_ale + init_thickness_ale, oce_ale.F90:82-194, :583-628); the
    bottom layer is ``bottom_{node,elem}_thickness``, which partial cells
    make thinner or thicker than the full cell."""
    nl = mesh.nl
    dtype = state.eta.dtype
    zbar = mesh.zbar.to(dtype)
    nln = mesh.nlevels_node.long()
    nle = mesh.nlevels_elem.long()
    lay = torch.arange(nl - 1, device=zbar.device)

    dz = (zbar[:-1] - zbar[1:])[:, None]
    is_bot_n = lay[:, None] == (nln - 2)[None, :]
    is_bot_e = lay[:, None] == (nle - 2)[None, :]
    hnode = torch.where(is_bot_n,
                        mesh.bottom_node_thickness.to(dtype)[None, :], dz)
    hnode = torch.where(mesh.node_layer_mask, hnode, 0.0)
    helem = torch.where(is_bot_e,
                        mesh.bottom_elem_thickness.to(dtype)[None, :], dz)
    helem = torch.where(mesh.elem_layer_mask, helem, 0.0)

    zbar_3d, Z_3d = initial_z3d(mesh, dtype)
    return replace(state, hnode=hnode, hnode_new=hnode, helem=helem,
                   zbar_3d=zbar_3d, Z_3d=Z_3d)
