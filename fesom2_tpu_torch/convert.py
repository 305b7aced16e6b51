"""Carry arrays between numpy (or the JAX package, through numpy) and the
port's dataclasses of tensors.

    state = state_from_numpy({f.name: np.asarray(getattr(s, f.name))
                              for f in dataclasses.fields(s)}, device, dtype)
    ring = tables_from(ssh.RingALE, jax_ring, device, dtype)

The ice state, the ice forcing, an atmosphere and the ice subdomain cross
the same way (``ice_state_from_numpy``, ``ice_forcing_from_numpy``,
``atm_from_numpy``, ``ice_subdomain_from_numpy``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.state import OceanState, Forcing
from .forcing.atmos import AtmData
from .ice.state import IceForcing, IceState
from .ice.subdomain import IceSubdomain
from .mesh import MeshTables
from .mesh.cluster import build_cluster_tables, elem_slot_table


def _tensor(x, device, dtype) -> torch.Tensor:
    a = np.array(x)             # a writable copy (JAX arrays are read-only)
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int32), device=device)
    return torch.as_tensor(a.astype(np.float64), device=device).to(dtype)


def _from_numpy(cls, arrays: dict, device, dtype):
    kw = {}
    for f in dataclasses.fields(cls):
        v = arrays[f.name]
        kw[f.name] = _tensor(v, device, dtype) if isinstance(v, np.ndarray) \
            else v
    return cls(**kw)


def state_from_numpy(arrays: dict, device, dtype=torch.float64) -> OceanState:
    """OceanState from {field name: array}; integer arrays become int32.
    Every field is carried at its shape, the GM bolus fields (``fer_*``,
    [.., 0] unless the state was allocated with ``with_gm``) included."""
    return _from_numpy(OceanState, arrays, device, dtype)


def forcing_from_numpy(arrays: dict, device, dtype=torch.float64) -> Forcing:
    return _from_numpy(Forcing, arrays, device, dtype)


def ice_state_from_numpy(arrays: dict, device,
                         dtype=torch.float64) -> IceState:
    return _from_numpy(IceState, arrays, device, dtype)


def ice_forcing_from_numpy(arrays: dict, device,
                           dtype=torch.float64) -> IceForcing:
    return _from_numpy(IceForcing, arrays, device, dtype)


def atm_from_numpy(arrays: dict, device, dtype=torch.float64) -> AtmData:
    """AtmData from {field name: array}: the series [T, N], their time axes
    [T] in seconds and the runoff [N] (``mesh.globe.globe_atm_fixtures``
    gives such a dict)."""
    return _from_numpy(AtmData, arrays, device, dtype)


def ice_subdomain_from_numpy(arrays: dict, device,
                             dtype=torch.float64) -> IceSubdomain:
    """IceSubdomain from {field name: array or int}, the JAX package's
    ``ice.subdomain.IceSubdomain`` field for field; the node assembly's
    packed ``elem_slot`` is derived anew."""
    slot = elem_slot_table(arrays["nod_in_elem"], arrays["nod_in_elem_slot"],
                           int(arrays["n_elems"]))
    return _from_numpy(IceSubdomain, {**arrays, "elem_slot": slot}, device,
                       dtype)


def mesh_from_numpy(arrays: dict, device, dtype=torch.float64) -> MeshTables:
    """MeshTables from {field name: array or static value}; the cluster
    kernels' tables are derived anew."""
    mesh = _from_numpy(MeshTables, {**arrays, "cluster": None}, device, dtype)
    return dataclasses.replace(mesh, cluster=build_cluster_tables(mesh))


def tables_from(cls, obj, device, dtype=torch.float64):
    """An instance of the port's dataclass ``cls`` from any object with
    array attributes of the same names: the JAX package's
    ``ssh.RingOperator``, ``ssh.RingALE`` and ``ssh.BlockSchwarz`` map onto
    the port's classes of those names."""
    return _from_numpy(cls, {f.name: np.asarray(getattr(obj, f.name))
                             for f in dataclasses.fields(cls)}, device, dtype)


def to_numpy(x):
    """A tensor as a numpy array; a dataclass as {field name: array}."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if dataclasses.is_dataclass(x):
        return {f.name: to_numpy(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return x
