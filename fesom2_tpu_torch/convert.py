"""Carry arrays between numpy (or the JAX package, through numpy) and the
port's dataclasses of tensors.

    state = state_from_numpy({f.name: np.asarray(getattr(s, f.name))
                              for f in dataclasses.fields(s)}, device, dtype)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.state import OceanState, Forcing
from .mesh import MeshTables


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
    """OceanState from {field name: array}; integer arrays become int32."""
    return _from_numpy(OceanState, arrays, device, dtype)


def forcing_from_numpy(arrays: dict, device, dtype=torch.float64) -> Forcing:
    return _from_numpy(Forcing, arrays, device, dtype)


def mesh_from_numpy(arrays: dict, device, dtype=torch.float64) -> MeshTables:
    """MeshTables from {field name: array or static value}."""
    return _from_numpy(MeshTables, arrays, device, dtype)


def to_numpy(x):
    """A tensor as a numpy array; a dataclass as {field name: array}."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if dataclasses.is_dataclass(x):
        return {f.name: to_numpy(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return x
