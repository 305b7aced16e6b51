"""Per-step diagnostics: the global norms table and the blowup scan.

The port of ``fesom2_tpu/core/diag.py`` (ref ``src/write_step_info.F90``:
write_step_info :14-219, check_blowup :220-504).  ``check_blowup``
returns a flag on the device, so that the run loop can scan every step
without waiting for the card (``run.run_pi`` keeps the first bad step in
a sticky flag and reads it now and then); ``step_info`` reads its norms
back to the host in one transfer.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..mesh import MeshTables
from .state import OceanState


def step_info(state: OceanState, mesh: MeshTables,
              ice=None) -> Dict[str, float]:
    """Global min/max norms of the prognostic fields (the keys of
    ``fesom2_tpu/core/diag.py:step_info``); with ``ice`` also the largest
    concentration, thickness and drift speed and, beyond JAX's keys, the
    ice area [m^2] and the ice volume [m^3]."""
    nmask = mesh.node_layer_mask
    area = mesh.area[0]
    T = state.tr[0][nmask]
    S = state.tr[1][nmask]
    # a padded mesh's dummy entities (one level) hold scratch
    real_n, real_e = real_entities(mesh)
    eta = state.eta[real_n]
    vals = torch.stack([
        eta.min(), eta.max(),
        (state.eta[real_n] * area[real_n]).sum() / area.sum(),
        T.min(), T.max(), S.min(), S.max(), state.u[:, real_e].abs().max(),
        state.v[:, real_e].abs().max(), state.w[:, real_n].abs().max(),
        state.cfl_z[:, real_n].max()])
    names = ("eta_min", "eta_max", "eta_int", "T_min", "T_max", "S_min",
             "S_max", "u_max", "v_max", "w_max", "cfl_z_max")
    if ice is not None:
        vals = torch.cat([vals, torch.stack([
            ice.a_ice[real_n].max(), ice.m_ice[real_n].max(),
            ice.u_ice[real_n].abs().max(),
            (ice.a_ice * area)[real_n].sum(),
            (ice.m_ice * area)[real_n].sum()])])
        names += ("aice_max", "hice_max", "uice_max", "ice_area",
                  "ice_volume")
    return dict(zip(names, vals.tolist()))


def real_entities(mesh: MeshTables):
    """(nodes [N], elements [E]) bool: the mesh's own entities, not the
    dummies of a padded mesh or of a rank's local mesh (one level)."""
    return mesh.nlevels_node >= 2, mesh.nlevels_elem >= 2


def blowup_scope(mesh: MeshTables):
    """What ``check_blowup`` must read on ``mesh``: None (every entity)
    on a mesh without dummies, else ``real_entities``.  One host read; a
    run loop asks once."""
    node_ok, elem_ok = real_entities(mesh)
    if bool(node_ok.all()) and bool(elem_ok.all()):
        return None
    return node_ok, elem_ok


def ice_outside_mask(ice, ice_sub) -> torch.Tensor:
    """Nodes [N] with a_ice > 0.01 outside the EVP subdomain ``ice_sub``:
    the dynamics are frozen there, so any such node means the cap was
    chosen too tight (``fesom2_tpu/core/diag.py:72-78``)."""
    return (ice.a_ice > 0.01) & ~ice_sub.node_mask


def _blowup_ranges(state: OceanState, mesh: MeshTables, ice=None,
                   ice_sub=None, owned=None) -> list:
    """The checks of ``check_blowup`` as (condition, field, lo, hi): the
    field is sane where lo <= x <= hi at every point (a NaN nowhere);
    lo = hi = None asks only that it be finite.  T and S are read on the
    wet layers (dry ones as 0 and 35); with ``owned`` ((nodes [N],
    elements [E]) bool) only those entities are read, the others as 0 (35
    for S)."""
    wet = mesh.node_layer_mask
    nodes = elems = lambda x: x
    if owned is not None:
        node_ok, elem_ok = owned
        wet = wet & node_ok
        nodes = lambda x: torch.where(node_ok, x, 0.0)
        elems = lambda x: torch.where(elem_ok, x, 0.0)
    out = [("|eta| > 10 or not finite", nodes(state.eta), -10.0, 10.0),
           ("|u| > 5 or not finite", elems(state.u), -5.0, 5.0),
           ("|v| > 5 or not finite", elems(state.v), -5.0, 5.0),
           ("w not finite", nodes(state.w), None, None),
           ("T outside [-5, 60] or not finite",
            torch.where(wet, state.tr[0], 0.0), -5.0, 60.0),
           ("S outside [0, 60] or not finite",
            torch.where(wet, state.tr[1], 35.0), 0.0, 60.0)]
    if ice is not None:
        out += [("ice.m_ice not finite", nodes(ice.m_ice), None, None),
                ("ice.u_ice not finite", nodes(ice.u_ice), None, None)]
        if ice_sub is not None:
            outside = ice_outside_mask(ice, ice_sub)
            if owned is not None:
                outside = outside & owned[0]
            out.append(("ice outside the EVP subdomain (rebuild it with "
                        "more margin: cfg.ice.evp_subdomain_lat)", outside,
                        False, False))
    return out


def _finite_range(x: torch.Tensor, lo, hi) -> tuple:
    if lo is not None:
        return lo, hi
    big = torch.finfo(x.dtype).max
    return -big, big


def check_blowup(state: OceanState, mesh: MeshTables, ice=None,
                 ice_sub=None, owned=None) -> torch.Tensor:
    """A flag on the device, int32 0 (sane) or 1, following the
    reference's ranges (check_blowup :220-504): eta finite and |eta| < 10,
    u and v finite and below 5 m/s, w finite, T in [-5, 60] and S in
    [0, 60] on the wet layers; with ``ice``, m_ice and u_ice finite; with
    ``ice_sub`` (the EVP subdomain), no ice outside it
    (``ice_outside_mask``).  One min/max reduction a field: a NaN makes
    both NaN, which fails either bound.  ``owned`` ((nodes, elements)
    bool) limits the scan: to the real entities of a padded mesh
    (``blowup_scope``), to a rank's own ones under ``parallel/dist.py``."""
    ok = []
    for _, x, lo, hi in _blowup_ranges(state, mesh, ice, ice_sub, owned):
        lo, hi = _finite_range(x, lo, hi)
        mn, mx = torch.aminmax(x)
        ok.append((mn >= lo) & (mx <= hi))
    return (~torch.stack(ok).all()).to(torch.int32)


def blowup_reasons(state: OceanState, mesh: MeshTables, ice=None,
                   ice_sub=None, owned=None) -> str:
    """The conditions of ``check_blowup`` that hold, with the number of
    points where they do (read on the host, for the message of a run that
    blew up)."""
    out = []
    for what, x, lo, hi in _blowup_ranges(state, mesh, ice, ice_sub, owned):
        lo, hi = _finite_range(x, lo, hi)
        n = int((~((x >= lo) & (x <= hi))).sum())
        if n:
            out.append(f"{what} at {n} points")
    return "; ".join(out) or "no condition holds at the read"


def first_bad_step(flag: torch.Tensor, first: torch.Tensor,
                   step: int) -> torch.Tensor:
    """The sticky record of the first bad step: ``first`` (int32 on the
    device, -1 while every step was sane) takes ``step`` where ``flag`` is
    set and it is still -1.  No host wait."""
    return torch.where((flag != 0) & (first < 0), step, first)


def format_step_info(info: Dict, step: int) -> str:
    return " | ".join([f"step {step:7d}"]
                      + [f"{k}={float(v):+.6e}" for k, v in info.items()])

