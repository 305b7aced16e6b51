"""Extrapolation of a nodal field into the bathymetry, on the host.

The port of ``extrap_nod`` of ``fesom2_tpu/utils/support.py:73-110`` (ref
``src/gen_support.F90`` extrap_nod3D :315-418), in numpy as there, with the
same sums in the same order (so the same bits) but over the missing nodes
of a pass only: a pass over every node made the WOA climatology take
minutes on a 114,000-node mesh.  That module's other functions
(smoothing, integrals) import jax and are not on the port's path.
"""
from __future__ import annotations

import numpy as np
import torch


def host(x) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def extrap_nod(arr, mesh, dummy: float = 1e20) -> np.ndarray:
    """Fill missing values (>= 0.99*dummy) of a [nl-1, N] nodal field by
    iterative horizontal neighbor averaging within each layer, then by
    copying downward (ref extrap_nod3D :315-418).  Setup-time numpy."""
    arr = np.array(arr, dtype=np.float64, copy=True)
    thresh = 0.99 * dummy
    nln = host(mesh.nlevels_node)
    nle = host(mesh.nlevels_elem)
    nie = host(mesh.nod_in_elem)               # [N, K]
    en = host(mesh.elem_nodes)                 # [E, 3]
    nl1 = arr.shape[0]

    for nz in range(nl1):
        wet = nln - 1 > nz                      # node has layer nz
        el_ok = nle - 1 > nz
        while True:
            work = arr[nz]
            # only the missing nodes are visited: the same sums, in the
            # same order, as over every node (the JAX package's loop)
            idx = np.flatnonzero((work >= thresh) & wet)
            if idx.size == 0:
                break
            valid = (work < thresh) & wet
            # neighbor values via adjacent elements' vertices
            nie_m = nie[idx]
            val = np.zeros(idx.size)
            cnt = np.zeros(idx.size)
            for k in range(nie.shape[1]):
                el = nie_m[:, k]
                ok = (el >= 0) & el_ok[np.clip(el, 0, None)]
                for j in range(3):
                    nb = en[np.clip(el, 0, None), j]
                    use = ok & valid[nb]
                    val += np.where(use, work[nb], 0.0)
                    cnt += use
            upd = cnt > 0
            if not upd.any():
                break                           # isolated basin: leave it
            arr[nz, idx[upd]] = val[upd] / np.maximum(cnt[upd], 1)

    # vertical: copy from the layer above
    for nz in range(1, nl1):
        take = (arr[nz] >= thresh) & (nln - 1 > nz)
        arr[nz] = np.where(take, arr[nz - 1], arr[nz])
    return arr
