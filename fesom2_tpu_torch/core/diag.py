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
    vals = torch.stack([
        state.eta.min(), state.eta.max(),
        (state.eta * area).sum() / area.sum(),
        T.min(), T.max(), S.min(), S.max(), state.u.abs().max(),
        state.v.abs().max(), state.w.abs().max(), state.cfl_z.max()])
    names = ("eta_min", "eta_max", "eta_int", "T_min", "T_max", "S_min",
             "S_max", "u_max", "v_max", "w_max", "cfl_z_max")
    if ice is not None:
        vals = torch.cat([vals, torch.stack([
            ice.a_ice.max(), ice.m_ice.max(), ice.u_ice.abs().max(),
            (ice.a_ice * area).sum(), (ice.m_ice * area).sum()])])
        names += ("aice_max", "hice_max", "uice_max", "ice_area",
                  "ice_volume")
    return dict(zip(names, vals.tolist()))


def ice_outside_mask(ice, ice_sub) -> torch.Tensor:
    """Nodes [N] with a_ice > 0.01 outside the EVP subdomain ``ice_sub``:
    the dynamics are frozen there, so any such node means the cap was
    chosen too tight (``fesom2_tpu/core/diag.py:72-78``)."""
    return (ice.a_ice > 0.01) & ~ice_sub.node_mask


def _blowup_ranges(state: OceanState, mesh: MeshTables, ice=None,
                   ice_sub=None) -> list:
    """The checks of ``check_blowup`` as (condition, field, lo, hi): the
    field is sane where lo <= x <= hi at every point (a NaN nowhere);
    lo = hi = None asks only that it be finite.  T and S are read on the
    wet layers (dry ones as 0 and 35)."""
    nmask = mesh.node_layer_mask
    out = [("|eta| > 10 or not finite", state.eta, -10.0, 10.0),
           ("|u| > 5 or not finite", state.u, -5.0, 5.0),
           ("|v| > 5 or not finite", state.v, -5.0, 5.0),
           ("w not finite", state.w, None, None),
           ("T outside [-5, 60] or not finite",
            torch.where(nmask, state.tr[0], 0.0), -5.0, 60.0),
           ("S outside [0, 60] or not finite",
            torch.where(nmask, state.tr[1], 35.0), 0.0, 60.0)]
    if ice is not None:
        out += [("ice.m_ice not finite", ice.m_ice, None, None),
                ("ice.u_ice not finite", ice.u_ice, None, None)]
        if ice_sub is not None:
            out.append(("ice outside the EVP subdomain (rebuild it with "
                        "more margin: cfg.ice.evp_subdomain_lat)",
                        ice_outside_mask(ice, ice_sub), False, False))
    return out


def _finite_range(x: torch.Tensor, lo, hi) -> tuple:
    if lo is not None:
        return lo, hi
    big = torch.finfo(x.dtype).max
    return -big, big


def check_blowup(state: OceanState, mesh: MeshTables, ice=None,
                 ice_sub=None) -> torch.Tensor:
    """A flag on the device, int32 0 (sane) or 1, following the
    reference's ranges (check_blowup :220-504): eta finite and |eta| < 10,
    u and v finite and below 5 m/s, w finite, T in [-5, 60] and S in
    [0, 60] on the wet layers; with ``ice``, m_ice and u_ice finite; with
    ``ice_sub`` (the EVP subdomain), no ice outside it
    (``ice_outside_mask``).  One min/max reduction a field: a NaN makes
    both NaN, which fails either bound."""
    ok = []
    for _, x, lo, hi in _blowup_ranges(state, mesh, ice, ice_sub):
        lo, hi = _finite_range(x, lo, hi)
        mn, mx = torch.aminmax(x)
        ok.append((mn >= lo) & (mx <= hi))
    return (~torch.stack(ok).all()).to(torch.int32)


def blowup_reasons(state: OceanState, mesh: MeshTables, ice=None,
                   ice_sub=None) -> str:
    """The conditions of ``check_blowup`` that hold, with the number of
    points where they do (read on the host, for the message of a run that
    blew up)."""
    out = []
    for what, x, lo, hi in _blowup_ranges(state, mesh, ice, ice_sub):
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

