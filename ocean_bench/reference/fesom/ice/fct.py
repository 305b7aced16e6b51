# Frozen copy of fesom2_tpu_torch/ice/fct.py, lines 1-200 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""Sea-ice FCT advection: Taylor-Galerkin RHS + consistent-mass iterations +
Loehner FEM-FCT limiting.

The port of ``fesom2_tpu/ice/fct.py``.  Reference: ``src/ice_fct.F90`` -
ice_TG_rhs_div :713-804, ice_update_for_div :806-893, ice_solve_high_order
:239-320, ice_solve_low_order :173-236, ice_fem_fct :321-632,
ice_mass_matrix_fill :634-709; call sequence of ice_timestep
(``ice_setup_step.F90:224-236``).

The consistent P1 mass-matrix product is evaluated matrix-free per element:
(M_c x)|_row = sum_{e containing row} area_e/12 * (x_1+x_2+x_3 + x_row),
which is exactly the assembled CSR matvec of the reference.  Plain torch
ops on top of ``core.ops.elem_contrib_to_nodes`` (a kernel on the card).

The assembly's rows are independent, so fields that need it at the same
point share one call: the two right-hand sides, and the high-order and
divergence iterations, which run side by side, with the low-order
solution's mass product in their first call.  An advection step makes
five calls (the JAX package's sequence makes nine, with the same values).
"""
from __future__ import annotations

from dataclasses import replace

import torch

from ..mesh import MeshTables
from ..core.ops import (elem_contrib_to_nodes, elem_contrib_to_nodes_3e,
                        halo_fix_node_pair)
from .state import IceState


def _inv_area(mesh: MeshTables) -> torch.Tensor:
    area1 = mesh.area[0]
    return torch.where(area1 > 0, 1.0 / torch.where(area1 > 0, area1, 1.0),
                       0.0)


def _mass_matvec(x, mesh: MeshTables):
    """Consistent mass matrix times node field(s) [..., N] (matrix-free,
    gather-based; batched over any leading axes)."""
    en = mesh.elem_nodes.long()
    xe = x[..., en]                     # [..., E, 3]
    s = xe.sum(-1)
    coef = mesh.elem_area / 12.0
    contrib = coef[:, None] * (s[..., None] + xe)         # [..., E, 3]
    return elem_contrib_to_nodes(contrib, mesh)


def ice_tg_rhs_div(u_ice, v_ice, fields, mesh: MeshTables, ice_dt):
    """Taylor-Galerkin rhs with divergence split (ref :713-804).

    fields: [F, N] stacked tracers (m_ice, a_ice, m_snow).
    Returns (rhs [F,N], rhs_div [F,N]).

    The element matrices ``entries(n, q)`` and ``entries2(n, q)`` (row node
    n, column node q; ref :771-781) are formed for all nine pairs at once,
    as [3, 3, E] with the vertices leading, where the JAX package unrolls
    two loops of three; each entry is the same expression, the sums over q
    are added in the order q = 0, 1, 2, and the contributions go to the
    nodes vertex-major (``elem_contrib_to_nodes_3e``), which adds the same
    values in the same slot order.
    """
    en = mesh.elem_nodes.T.long()        # [3, E]
    dx = mesh.gradient_sca[:, 0:3].T     # [3, E]
    dy = mesh.gradient_sca[:, 3:6].T
    vol = mesh.elem_area
    ue = u_ice[en]                       # [3, E]
    ve = v_ice[en]
    um = ue[0] + ue[1] + ue[2]
    vm = ve[0] + ve[1] + ve[2]
    sum3 = lambda a: a[0] + a[1] + a[2]
    c1 = (um * um + sum3(ue * ue)) / 12.0
    c2 = (vm * vm + sum3(ve * ve)) / 12.0
    c3 = (um * vm + sum3(ve * ue)) / 12.0
    c4 = sum3(dx * ue) + sum3(dy * ve)             # divergence

    fe = fields[:, en]                   # [F, 3, E]
    fsum = fe[:, 0] + fe[:, 1] + fe[:, 2]          # [F, E]

    dxn, dyn, uen, ven = dx[:, None], dy[:, None], ue[:, None], ve[:, None]
    dxq, dyq, ueq, veq = dx[None], dy[None], ue[None], ve[None]
    entries = vol * ice_dt * (
        (1.0 - 0.5 * ice_dt * c4)
        * (dxn * (um + ueq) + dyn * (vm + veq)) / 12.0
        - 0.5 * ice_dt * (c1 * dxn * dxq + c2 * dyn * dyq
                          + c3 * (dxn * dyq + dxq * dyn)))     # [3n, 3q, E]
    entries2 = 0.5 * ice_dt * (
        dxn * (um + ueq) + dyn * (vm + veq)
        - dxq * (um + uen) - dyq * (vm + ven))
    feq = fe[:, None]                                          # [F, 1, 3q, E]
    acc = sum3((entries * feq).unbind(2))                      # [F, 3n, E]
    acc2 = sum3((entries2 * feq).unbind(2))
    cx = vol * ice_dt * c4 * (fsum[:, None] + fe + acc2) / 12.0
    rhs_both = elem_contrib_to_nodes_3e(torch.cat([acc + cx, -cx]), mesh)
    return rhs_both[:fields.shape[0]], rhs_both[fields.shape[0]:]


def _lumped_iterate(rhs, mesh: MeshTables, n_iter=3, extra=None):
    """Solve M_c d = rhs by lumped-mass Jacobi iterations (ref :239-320);
    rhs [R, N], each row on its own.  ``extra`` [F, N], if given, rides
    along the first mass product (one assembly for both): returns (d,
    M_c extra); without, (d, None)."""
    inv_area = _inv_area(mesh)
    d = rhs * inv_area
    m_extra = None
    for i in range(n_iter - 1):
        if i == 0 and extra is not None:
            prod = _mass_matvec(torch.cat([d, extra]), mesh)
            prod, m_extra = prod[:rhs.shape[0]], prod[rhs.shape[0]:]
        else:
            prod = _mass_matvec(d, mesh)
        d = d + (rhs - prod) * inv_area
    return d, m_extra


def fct_advect_fields(u_ice, v_ice, fields, mesh: MeshTables, gamma, ice_dt):
    """Advect a stack of node scalars [F, N] with the TG/FEM-FCT scheme,
    vectorized over F.  Returns the new fields [F, N]."""
    F = fields.shape[0]
    rhs, rhs_div = ice_tg_rhs_div(u_ice, v_ice, fields, mesh, ice_dt)

    # high-order and divergence increments (consistent mass iterations, ref
    # :239-320 and ice_update_for_div :806-893), side by side; the
    # low-order solution's mass product rides along their first product
    d, m_fields = _lumped_iterate(torch.cat([rhs, rhs_div]), mesh, n_iter=3,
                                  extra=fields)
    d_high, d_div = d[:F], d[F:]

    # low-order solution (ref :173-236)
    area1 = mesh.area[0]
    low = (rhs + gamma * m_fields) * _inv_area(mesh) + (1.0 - gamma) * fields

    # FEM-FCT limiting (ref ice_fem_fct :321-632), batched over F
    en = mesh.elem_nodes.long()
    # antidiffusive element fluxes: -sum_q icoef(:,q)*(gamma*x+dh) with
    # icoef = 1 everywhere, -2 on the diagonal => sum_n icoef(n,q)*y_n
    # = s - 3*y_q where s = sum(y)
    y = gamma * fields + d_high
    ye = y[..., en]                                       # [F, E, 3]
    s = ye.sum(-1)
    flux_q = -(s[..., None] - 3.0 * ye) * mesh.elem_area[:, None] / 12.0
    # a node without a surface area (under an ice-shelf cavity) takes no
    # antidiffusive flux: fesom2_tpu divides by max(area, 1e-30) there, a
    # flux of elem_area / 12 / 1e-30 (about 1e38) times the field on the
    # level-7 globe, which overflows float32 to inf and then NaN; in
    # float64 that node's bound shrinks its elements' factor to about
    # 1e-38, and the flux they add elsewhere is lost to rounding.  Its
    # elements' factor is 0 here.
    wet1 = area1[en] > 0                                  # [E, 3]
    flux_q = flux_q / torch.where(wet1, area1[en], 1.0)

    # cluster min/max of the low-order solution over node neighbourhoods,
    # gathered over the 1-ring table; a padded slot never bounds
    nn = mesh.node_neighbors.long()                       # [N, KE]
    nvalid = nn >= 0
    nb = low[..., torch.where(nvalid, nn, 0)]             # [F, N, KE]
    big = torch.finfo(low.dtype).max
    nb_max, nb_min = halo_fix_node_pair(
        torch.where(nvalid, nb, -big).amax(-1),
        torch.where(nvalid, nb, big).amin(-1))
    tmax = torch.maximum(low, nb_max) - low
    tmin = torch.minimum(low, nb_min) - low

    # sums of +/- fluxes (one merged gather) -> nodal limiting factors
    ppair = elem_contrib_to_nodes(
        torch.stack([flux_q.clamp_min(0.0), flux_q.clamp_max(0.0)]), mesh)
    pplus, pminus = ppair[0], ppair[1]
    pplus = torch.where(
        pplus.abs() > 0,
        torch.clamp_max(tmax / torch.where(pplus != 0, pplus, 1.0), 1.0), 0.0)
    pminus = torch.where(
        pminus.abs() > 0,
        torch.clamp_max(tmin / torch.where(pminus != 0, pminus, 1.0), 1.0),
        0.0)

    # element limiting factor ae = min over its 3 nodes
    fac = torch.where(flux_q >= 0, pplus[..., en], pminus[..., en])  # [F,E,3]
    ae = torch.where(wet1.all(-1), fac.amin(-1), 0.0)
    out = low + elem_contrib_to_nodes(ae[..., None] * flux_q, mesh)
    return out + d_div


def ice_fct_advect(ice: IceState, mesh: MeshTables, cfg, ice_dt) -> IceState:
    """Full advection step for the FESIM 3-field state: TG rhs -> HO/LO
    solutions -> FEM-FCT -> update.

    Mirrors ice_timestep's sequence ice_TG_rhs_div -> ice_fct_solve ->
    ice_update_for_div (``ice_setup_step.F90:224-231``).
    """
    gamma = cfg.ice.ice_gamma_fct
    fields = torch.stack([ice.m_ice, ice.a_ice, ice.m_snow])   # [3, N]
    m_ice, a_ice, m_snow = fct_advect_fields(ice.u_ice, ice.v_ice, fields,
                                             mesh, gamma, ice_dt)

    # cut_off (ref ice_thermo_oce.F90:2-63)
    a_ice = torch.clamp_max(a_ice, 1.0)
    a_ice = torch.where(a_ice < 1e-9, 0.0, a_ice)
    m_ice = torch.where(m_ice < 1e-9, 0.0, m_ice)
    return replace(ice, m_ice=m_ice, a_ice=a_ice, m_snow=m_snow)
