# Frozen copy of fesom2_tpu_torch/core/tracer_setup.py, lines 1-106 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""Static precomputes for the tracer transport schemes (host numpy).

The port of ``fesom2_tpu/core/tracer_setup.py`` (ref
``src/oce_muscl_adv.F90`` muscl_adv_init :27-127,
find_up_downwind_triangles :132-283; Ki ``src/oce_setup_step.F90:326-330``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..mesh import MeshTables


@dataclass(frozen=True)
class TracerStatics:
    edge_up_dn_tri: torch.Tensor   # [Ed, 2] int32, -1 when absent
    nboundary_lay: torch.Tensor    # [N] int32 layers before the node
                                   # becomes a lateral-boundary node
    Ki: torch.Tensor               # [N] horizontal diffusivity
    nln_min: torch.Tensor          # [N] int32 min nlevels of adjacent elems


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _find_up_downwind_triangles(mesh: MeshTables) -> np.ndarray:
    """Vectorised find_up_downwind_triangles (:132-283)."""
    coords = _np(mesh.coords)
    edges = _np(mesh.edges)
    en = _np(mesh.elem_nodes)
    nie = _np(mesh.nod_in_elem)
    cl = mesh.cyclic_length

    def trim(v):
        v = np.where(v > cl / 2, v - cl, v)
        return np.where(v < -cl / 2, v + cl, v)

    Ed = edges.shape[0]
    out = np.full((Ed, 2), -1, np.int64)
    x = np.stack([trim(coords[edges[:, 1], 0] - coords[edges[:, 0], 0]),
                  coords[edges[:, 1], 1] - coords[edges[:, 0], 1]], axis=1)
    # upwind: -x from node 0; downwind: +x from node 1
    for side, sign in ((0, -1.0), (1, 1.0)):
        anchor = edges[:, side]
        xv = sign * x
        cands = nie[anchor]
        found = np.full(Ed, -1, np.int64)
        for k in range(cands.shape[1]):
            elem = cands[:, k]
            ok = elem >= 0
            tri = en[np.where(ok, elem, 0)]
            # rotate so that vertex 0 is the anchor
            is0 = (tri[:, 0] == anchor)[:, None]
            is1 = (tri[:, 1] == anchor)[:, None]
            v0 = np.where(is0, tri[:, [0, 1, 2]],
                          np.where(is1, tri[:, [1, 0, 2]], tri[:, [2, 0, 1]]))
            b = np.stack([trim(coords[v0[:, 1], 0] - coords[v0[:, 0], 0]),
                          coords[v0[:, 1], 1] - coords[v0[:, 0], 1]], 1)
            c = np.stack([trim(coords[v0[:, 2], 0] - coords[v0[:, 0], 0]),
                          coords[v0[:, 2], 1] - coords[v0[:, 0], 1]], 1)
            cr = (c * c).sum(1)
            bx = (b * c).sum(1) / cr
            by = (-b[:, 0] * c[:, 1] + b[:, 1] * c[:, 0]) / cr
            xxp = (xv * c).sum(1) / cr
            xyp = (-xv[:, 0] * c[:, 1] + xv[:, 1] * c[:, 0]) / cr
            ab = np.arctan2(by, bx)
            ax = np.arctan2(xyp, xxp)
            hit = ((ab > 0) & (ax > 0) & (ax < ab)) | \
                  ((ab < 0) & (ax < 0) & (ax > ab)) | \
                  (ab == ax) | (ax == 0.0)
            hit = hit & ok & (found < 0)
            found = np.where(hit, elem, found)
        out[:, side] = found
    return out


def build_tracer_statics(mesh: MeshTables, K_hor: float = 10.0,
                         dtype=torch.float64) -> TracerStatics:
    edge_up_dn = _find_up_downwind_triangles(mesh)

    # nboundary_lay (ref muscl_adv_init :80-108)
    edges = _np(mesh.edges)
    etri = _np(mesh.edge_tri)
    nle = _np(mesh.nlevels_elem)
    nb = np.full(mesh.n_nodes, mesh.nl - 1, np.int64)
    bnd = (etri < 0).any(axis=1)
    et_min = np.where(bnd, 0,
                      np.minimum(nle[np.clip(etri[:, 0], 0, None)],
                                 nle[np.clip(etri[:, 1], 0, None)]) - 1)
    for j in range(2):
        np.minimum.at(nb, edges[:, j], et_min)

    Ki = K_hor * (_np(mesh.resolution) / 100000.0) ** 2
    nie = _np(mesh.nod_in_elem)
    nln_min = np.where(nie >= 0, nle[np.clip(nie, 0, None)], 10 ** 6).min(-1)

    dev = mesh.zbar.device
    i = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=dev)
    return TracerStatics(
        edge_up_dn_tri=i(edge_up_dn), nboundary_lay=i(nb),
        Ki=torch.as_tensor(np.asarray(Ki, np.float64), device=dev).to(dtype),
        nln_min=i(nln_min))
