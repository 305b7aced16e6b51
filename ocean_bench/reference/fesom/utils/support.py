# Frozen copy of fesom2_tpu_torch/utils/support.py, lines 1-115 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""Support utilities: mass-matrix smoothing, global integrals,
extrapolation into the bathymetry.

The port of ``fesom2_tpu/utils/support.py`` (ref ``src/gen_support.F90``:
smooth_nod2D/3D :46-178, smooth_elem2D/3D :183-258, integrate_nod_2D/3D
:262-311, extrap_nod3D :315-418).

- ``smooth_nod`` and ``smooth_elem``: each pass is an element-to-node
  area-weighted mean over ``nod_in_elem`` with no level mask,
  ``sum_k area * x / sum_k area``: ``core/ops.elem_to_node_mean_flat``,
  which launches the ``elem_to_node_mean`` kernel's one-thread-per-output
  form on a CUDA tensor and runs its plain version on a CPU one.
- ``integrate_nod_2d`` and ``integrate_nod_3d``: one device reduction
  each.
- ``extrap_nod`` (setup time, host numpy): the same sums in the same order
  as the JAX package's loop (so the same bits), but over the missing nodes
  of a pass only: a pass over every node made the WOA climatology take
  minutes on a 114,000-node mesh.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import ops


def host(x) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def smooth_nod(arr: torch.Tensor, n_smooth: int, mesh) -> torch.Tensor:
    """Apply the lumped mass matrix ``n_smooth`` times to a node field
    [..., N] (ref smooth_nod2D :46-74 / smooth_nod3D :78-178): each pass
    replaces a node by the area-weighted mean of the three-node means of
    its elements."""
    for _ in range(n_smooth):
        arr = ops.elem_to_node_mean_flat(ops.elem_mean_node(arr, mesh),
                                         mesh)
    return arr


def smooth_elem(arr: torch.Tensor, n_smooth: int, mesh) -> torch.Tensor:
    """Mass-matrix smoothing of an element field [..., E] (ref
    smooth_elem2D :183-212 / smooth_elem3D :216-258): the element values
    area-averaged to the nodes, then each element the mean of its
    vertices."""
    for _ in range(n_smooth):
        arr = ops.elem_mean_node(ops.elem_to_node_mean_flat(arr, mesh), mesh)
    return arr


def integrate_nod_2d(data: torch.Tensor, mesh) -> torch.Tensor:
    """Global surface integral of a node field [N] (ref integrate_nod_2D
    :262-284): sum(data * the surface level's area)."""
    return (data * mesh.area[0]).sum()


def integrate_nod_3d(data: torch.Tensor, hnode: torch.Tensor,
                     mesh) -> torch.Tensor:
    """Global volume integral of a layered node field [nl-1, N] (ref
    integrate_nod_3D :288-311): the sum over wet cells of data * areasvol *
    hnode."""
    w = torch.where(mesh.node_layer_mask, hnode * mesh.areasvol[:-1], 0.0)
    return (data * w).sum()


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
