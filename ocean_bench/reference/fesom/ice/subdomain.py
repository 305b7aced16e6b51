# Frozen copy of fesom2_tpu_torch/ice/subdomain.py, lines 1-122 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""Static ice subdomain: run the EVP subcycle loop only where ice can exist.

The port of ``fesom2_tpu/ice/subdomain.py``.  The EVP velocity update is
the identity at nodes with a_ice < 0.01 (ref ice_maEVP.F90:475-479, the
``has_ice_n`` gate of ``evp.py``), and stresses stay zero on elements
without ice.  Restricting the subcycle loop to a (dilated) polar cap is
therefore EXACT as long as all ice stays inside the cap.

The subdomain duck-types the MeshTables fields the EVP functions read, so
``mevp_dynamics`` runs unchanged on the restricted tables; entry gathers
the node and element state into subdomain order, exit copies the updated
velocities and stresses back (``sub_nodes`` and ``sub_elems`` hold no
index twice, which ``subdomain_arrays`` checks, so the copy out is an
indexed assignment without races).

The cap must be chosen with margin (default: equatorward to 40 deg); the
time loop (``run.run_pi``) flags ice outside the cap (a_ice > 0.01 where
``node_mask`` is False) as a configuration error.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import rad
from ..mesh import MeshTables
from ..mesh.cluster import elem_slot_table


@dataclass
class IceSubdomain:
    """Restricted mesh tables for the EVP loop (duck-types MeshTables)."""
    sub_nodes: torch.Tensor        # [Ns] i32 global node ids
    sub_elems: torch.Tensor        # [Es] i32 global element ids
    node_mask: torch.Tensor        # [N] bool (for safety diagnostics)
    # MeshTables-compatible fields (subdomain-local numbering)
    elem_nodes: torch.Tensor       # [Es,3] i32 local
    nod_in_elem: torch.Tensor      # [Ns,K] i32 local, -1 pad
    nod_in_elem_slot: torch.Tensor  # [Ns,K] i32
    elem_slot: torch.Tensor        # [K,Ns] i32 e*3 + slot, -1 pad (local)
    gradient_sca: torch.Tensor     # [Es,6]
    metric_factor: torch.Tensor    # [Es]
    elem_area: torch.Tensor        # [Es]
    area: torch.Tensor             # [1,Ns] (surface scalar areas)
    coriolis_node: torch.Tensor    # [Ns]
    bc_index_node: torch.Tensor    # [Ns]
    n_elems: int
    n_nodes: int


def subdomain_arrays(geo_lat, elem_nodes, lat_deg: float = 40.0) -> dict:
    """The index tables of the polar-cap subdomain |lat| > lat_deg as numpy
    arrays, from the geographic node latitudes [N] (radians) and the
    element nodes [E, 3]: ``sub_nodes``, ``sub_elems``, ``node_mask``,
    ``elem_nodes`` (local), ``nod_in_elem``, ``nod_in_elem_slot`` and,
    from the last two, the node assembly's packed ``elem_slot``
    (``mesh/cluster.py``)."""
    glat = np.abs(np.asarray(geo_lat)) / rad
    seed = glat > lat_deg
    en = np.asarray(elem_nodes)
    emask = seed[en].any(axis=1)
    sub_elems = np.nonzero(emask)[0]
    l2g = np.unique(en[emask])                  # closed node set
    N = glat.shape[0]
    g2l = np.full(N, -1, np.int64)
    g2l[l2g] = np.arange(l2g.size)
    node_mask = np.zeros(N, bool)
    node_mask[l2g] = True
    if np.unique(l2g).size != l2g.size \
            or np.unique(sub_elems).size != sub_elems.size:
        raise ValueError("subdomain ids must be unique: the copy out of the "
                         "subdomain is an indexed assignment")

    en_loc = g2l[en[sub_elems]]                 # [Es,3] local
    Ns, Es = l2g.size, sub_elems.size

    # local node->element incidence (same construction as mesh/tables.py)
    num = np.zeros(Ns, np.int64)
    for j in range(3):
        np.add.at(num, en_loc[:, j], 1)
    K = max(1, int(num.max())) if Ns else 1
    inodes = en_loc.T.ravel()
    ielems = np.tile(np.arange(Es), 3)
    order = np.argsort(inodes, kind="stable")
    inodes_s, ielems_s = inodes[order], ielems[order]
    offsets = np.zeros(Ns + 1, np.int64)
    np.cumsum(num, out=offsets[1:])
    slot_pos = np.arange(3 * Es) - offsets[inodes_s]
    nie = np.full((Ns, K), -1, np.int64)
    nie[inodes_s, slot_pos] = ielems_s
    safe = np.where(nie >= 0, nie, 0)
    slot = np.argmax(en_loc[safe] == np.arange(Ns)[:, None, None], axis=-1)
    return dict(sub_nodes=l2g, sub_elems=sub_elems, node_mask=node_mask,
                elem_nodes=en_loc, nod_in_elem=nie, nod_in_elem_slot=slot,
                elem_slot=elem_slot_table(nie, slot, Es))


def build_ice_subdomain(mesh: MeshTables, lat_deg: float = 40.0
                        ) -> IceSubdomain:
    """Build the polar-cap subdomain |lat| > lat_deg (host-side numpy), on
    the mesh's device and in its dtype."""
    dev = mesh.zbar.device
    t = subdomain_arrays(mesh.geo_coords[:, 1].cpu().numpy(),
                         mesh.elem_nodes.cpu().numpy(), lat_deg)
    i32 = lambda a: torch.as_tensor(a.astype(np.int32), device=dev)
    g = torch.as_tensor(t["sub_nodes"], device=dev)
    ge = torch.as_tensor(t["sub_elems"], device=dev)
    return IceSubdomain(
        sub_nodes=i32(t["sub_nodes"]), sub_elems=i32(t["sub_elems"]),
        node_mask=torch.as_tensor(t["node_mask"], device=dev),
        elem_nodes=i32(t["elem_nodes"]), nod_in_elem=i32(t["nod_in_elem"]),
        nod_in_elem_slot=i32(t["nod_in_elem_slot"]),
        elem_slot=i32(t["elem_slot"]),
        gradient_sca=mesh.gradient_sca[ge].contiguous(),
        metric_factor=mesh.metric_factor[ge].contiguous(),
        elem_area=mesh.elem_area[ge].contiguous(),
        area=mesh.area[0][g][None, :].contiguous(),
        coriolis_node=mesh.coriolis_node[g].contiguous(),
        bc_index_node=mesh.bc_index_node[g].contiguous(),
        n_elems=int(ge.shape[0]), n_nodes=int(g.shape[0]))
