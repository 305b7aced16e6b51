"""Checkpoint and restart: every prognostic field, raw, in one NetCDF3
file.

The port of ``fesom2_tpu/io/restart.py`` (ref ``src/io_restart.F90``:
the variable set :80-160, the write and read routines :200-772), on the
port's own ``io/netcdf.py``: the same variables under the same names and
dimensions, so that either package reads the other's file.  Restarts are
bit-continuable: raw fields at the state's own dtype, no averaging; the
ALE layer geometry is rebuilt on read (restart_thickness_ale,
``oce_ale.F90:998``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .netcdf import read_vars, write_dataset
from ..core.state import OceanState

OCE_FIELDS = ["eta", "hbar", "hbar_old", "ssh_rhs_old", "d_eta",
              "d_eta_prev", "u", "v",
              "u_rhsAB", "v_rhsAB", "w", "w_e", "w_i", "tr", "tr_old",
              "hnode", "hnode_new", "uke", "uke_rhs",
              # persistent mixing memory: the Monin-Obukhov length is
              # relaxed in time (oce_mo_conv.F90), TKE/IDEMIX energies are
              # prognostic interface fields (gen_modules_cvmix_{tke,idemix})
              "mixlength", "tke", "iwe"]
ICE_FIELDS = ["u_ice", "v_ice", "m_ice", "a_ice", "m_snow",
              "sigma11", "sigma12", "sigma22", "t_skin",
              # aEVP persistent stability arrays (ice_maEVP.F90:611-660)
              "alpha_aevp", "beta_aevp"]
IPK_FIELDS = ["aicen", "vicen", "vsnon", "Tsfcn", "qin", "qsn"]
# the optional aux-tracer stacks of Icepack, written where they hold a
# tracer
IPK_AUX = ("ta", "tv")


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _aux(ipk, name):
    v = getattr(ipk, name, None)
    return v if v is not None and v.shape[1] > 0 else None


def write_restart(path: str, state: OceanState, ice=None, step: int = 0,
                  ipk=None):
    """Write a raw full-precision restart file (NetCDF3).  Its ``step``
    variable is ``state.step``, as in the JAX package (``step`` is kept
    for its signature)."""
    variables, dims = {}, {}

    def add(name, arr):
        arr = _host(arr)
        dnames = []
        for k, s in enumerate(arr.shape):
            dn = f"{name}_d{k}"
            dims[dn] = s
            dnames.append(dn)
        variables[name] = (tuple(dnames), arr)

    for f in OCE_FIELDS:
        add(f, getattr(state, f))
    add("step", np.asarray([int(state.step)]))
    if ice is not None:
        for f in ICE_FIELDS:
            add("ice_" + f, getattr(ice, f))
    if ipk is not None:
        for f in IPK_FIELDS:
            add("ipk_" + f, getattr(ipk, f))
        for f in IPK_AUX:
            if _aux(ipk, f) is not None:
                add("ipk_" + f, getattr(ipk, f))
    write_dataset(path, dims, variables)


def read_restart(path: str, state: OceanState, ice=None, dtype=None,
                 ipk=None, mesh=None, cfg=None):
    """Read a restart file into (state, ice[, ipk]), the given ones
    supplying the fields the file does not hold, the device and (unless
    ``dtype`` is given) the dtype.

    With (mesh, cfg) given, the ALE layer geometry (helem, zbar_3d, Z_3d)
    is rebuilt from the restored hnode by ``ale.update_thickness`` (the
    restart_thickness_ale analog, ``oce_ale.F90:998``), which
    bit-continuation under zlevel and zstar needs."""
    dev = state.eta.device
    dtype = dtype or state.eta.dtype
    names = OCE_FIELDS + ["step"]
    if ice is not None:
        names += ["ice_" + f for f in ICE_FIELDS]
    if ipk is not None:
        names += ["ipk_" + f for f in IPK_FIELDS]
        names += ["ipk_" + f for f in IPK_AUX if _aux(ipk, f) is not None]
    data = read_vars(path, names, missing_ok=True)
    # NetCDF3 stores big-endian: to native byte order first
    put = lambda a: torch.as_tensor(
        np.asarray(a).astype(np.asarray(a).dtype.newbyteorder("=")),
        device=dev).to(dtype)
    # fields absent from older files (d_eta, added for the SSH warm
    # start) keep their allocated value: a cold start, still resumable
    up = {f: put(data[f]) for f in OCE_FIELDS if f in data}
    up["step"] = torch.tensor(int(data["step"][0]), dtype=torch.int32,
                              device=dev)
    state = dataclasses.replace(state, **up)
    if mesh is not None and cfg is not None \
            and cfg.ale.which_ALE != "linfs":
        from ..core.ale import update_thickness
        # update_thickness moves hnode_new to hnode and rebuilds helem,
        # zbar_3d and Z_3d: feed it the restored hnode, keep the file's
        # hnode_new (the two coincide at a step's end anyway)
        geo = update_thickness(
            dataclasses.replace(state, hnode_new=state.hnode), mesh, cfg)
        state = dataclasses.replace(
            state, helem=geo.helem, zbar_3d=geo.zbar_3d, Z_3d=geo.Z_3d)
    if ice is not None:
        ice = dataclasses.replace(
            ice, **{f: put(data["ice_" + f]) for f in ICE_FIELDS
                    if "ice_" + f in data})
    if ipk is not None:
        up = {f: put(data["ipk_" + f]) for f in IPK_FIELDS}
        for f in IPK_AUX:
            if "ipk_" + f in data:
                up[f] = put(data["ipk_" + f])
        return state, ice, dataclasses.replace(ipk, **up)
    return state, ice
