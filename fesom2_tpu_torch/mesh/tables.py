"""MeshTables: static mesh geometry as torch tensors on one device.

The port of ``fesom2_tpu/mesh/tables.py``: the tables are derived on the
host in numpy by the same code, then placed on the requested device.
Layout conventions are unchanged: level axis first, entity axis last
(``[nl, N]``); adjacency tables are int32 padded with -1.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ..constants import rad, r_earth, omega, pi
from .cluster import ClusterTables, build_cluster_tables
from .io import RawMesh, read_raw_mesh
from .rotation import rotation_matrix, r2g


def _trim_cyclic(x: np.ndarray, cl: float) -> np.ndarray:
    """Wrap coordinate differences into (-cl/2, cl/2] (ref oce_mesh trim_cyclic)."""
    x = np.where(x > cl / 2.0, x - cl, x)
    x = np.where(x < -cl / 2.0, x + cl, x)
    return x


def build_edges(elem_nodes: np.ndarray, coords: np.ndarray, cyclic_len: float):
    """Edge list and edge->triangle adjacency from triangles.

    edge_tri[:,0] is the triangle LEFT of node0->node1; internal edges come
    first, boundary edges (one triangle) last.  Returns (edges[Ed,2],
    edge_tri[Ed,2] with -1 for missing, n_internal).
    """
    E = elem_nodes.shape[0]
    N = int(elem_nodes.max()) + 1
    n0, n1, n2 = elem_nodes[:, 0], elem_nodes[:, 1], elem_nodes[:, 2]
    ax = _trim_cyclic(coords[n1, 0] - coords[n0, 0], cyclic_len)
    bx = _trim_cyclic(coords[n2, 0] - coords[n0, 0], cyclic_len)
    ay = coords[n1, 1] - coords[n0, 1]
    by = coords[n2, 1] - coords[n0, 1]
    ccw = (ax * by - bx * ay) > 0

    a = np.concatenate([n0, n1, n2])
    b = np.concatenate([n1, n2, n0])
    tri = np.tile(np.arange(E), 3)
    ccw3 = np.tile(ccw, 3)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    key = lo.astype(np.int64) * N + hi
    # triangle is left of lo->hi iff (a<b) agrees with CCW orientation
    fwd = (a < b) == ccw3
    ukey, inv = np.unique(key, return_inverse=True)
    Ed = ukey.shape[0]
    etri = np.full((Ed, 2), -1, np.int64)
    etri[inv[fwd], 0] = tri[fwd]
    etri[inv[~fwd], 1] = tri[~fwd]
    edges = np.stack([ukey // N, ukey % N], axis=1)
    flip = etri[:, 0] == -1
    edges[flip] = edges[flip][:, ::-1]
    etri[flip] = etri[flip][:, ::-1]
    internal = etri[:, 1] >= 0
    order = np.concatenate([np.nonzero(internal)[0], np.nonzero(~internal)[0]])
    return edges[order], etri[order], int(internal.sum())


def derive_levels(raw: RawMesh, elem_neighbors: np.ndarray,
                  thers_lev: int = 5):
    """Per-element/per-node level counts from node depths (ref
    ``fvom_init.F90:657-871``): the element depth is the mean of its
    vertices', the first mid-depth Z below it gives the level count, at
    least ``thers_lev``, then the iterative elimination of isolated cells;
    node levels are the maximum over the node's elements.  Without depths
    (a flat-bottomed toy mesh) every column is full."""
    nl = raw.nl
    zbar = raw.zbar
    Z = 0.5 * (zbar[:-1] + zbar[1:])
    depth = raw.depth
    if depth is None:
        nle = np.full(raw.n_elems, nl, np.int64)
    else:
        depth = np.minimum(depth, zbar[thers_lev - 1])
        dmean = depth[raw.elem_nodes].mean(axis=1)
        # first nz (1-based) with Z[nz-1] < dmean
        below = Z[None, :] < dmean[:, None]
        has = below.any(axis=1)
        first = np.argmax(below, axis=1) + 1
        nle = np.where(has, first, np.where(dmean < 0, nl, thers_lev))
        nle = np.maximum(nle, thers_lev)
        # isolated-cell elimination: a cell open to fewer than two
        # neighbours at level nz closes there
        nb = elem_neighbors
        for nz in range(thers_lev + 1, nl + 1):
            for _ in range(1000):
                open_mask = nle >= nz
                nb_open = (nb >= 0) & open_mask[np.clip(nb, 0, None)]
                bad = open_mask & (nb_open.sum(axis=1) < 2)
                if not bad.any():
                    break
                nle[bad] = nz - 1
    nln = np.zeros(raw.n_nodes, np.int64)
    for j in range(3):
        np.maximum.at(nln, raw.elem_nodes[:, j], nle)
    return nle.astype(np.int64), nln


def derive_ulevels_cavity(cavity_depth: np.ndarray, elem_nodes: np.ndarray,
                          elem_neighbors: np.ndarray, nle: np.ndarray,
                          zbar: np.ndarray):
    """Per-element/per-node level of the ice-shelf (cavity) to ocean
    boundary, 1-based (1 = open ocean), as the partitioner's
    ``find_levels_cavity`` (ref ``fvom_init.F90:878-1075``) and
    ``fesom2_tpu/mesh/tables.py:140-230`` derive it: the element draft is
    the mean of its vertices', the first mid-depth Z below it (or the level
    that leaves 3 layers) gives the boundary, then cells isolated within a
    layer are removed (the boundary deepened where 3 bottom layers remain,
    else the closest neighbour's raised), repeated until none is left;
    node ulevels are the minimum over the node's elements."""
    nl = zbar.shape[0]
    Z = 0.5 * (zbar[:-1] + zbar[1:])
    E = elem_nodes.shape[0]
    dmean = cavity_depth[elem_nodes].mean(axis=1)
    # the first nz (1-based) with Z(nz) < dmean or at most 3 layers left
    # (ref :925-931); dmean >= 0 stops at nz = 1 (open ocean)
    k1 = np.arange(1, nl)
    cond = (Z[None, :] < dmean[:, None]) | ((nle[:, None] - k1[None, :]) <= 3)
    ule = np.argmax(cond, axis=1) + 1

    # a cell open on layer nz needs two open neighbours (ref :957-1040)
    elemreduce = np.zeros(E, bool)
    elemfix = np.zeros(E, bool)
    nb = elem_neighbors
    has2 = (nb >= 0).sum(axis=1) >= 2
    # the open neighbours of each element, counted column by column (a
    # bool sum along a row of three is the slow part of the sweep)
    nb_cols = [(nb[:, j] >= 0, np.clip(nb[:, j], 0, None)) for j in range(3)]

    def _open_neighbours(act):
        cnt = np.zeros(E, np.uint8)
        for valid, col in nb_cols:
            cnt += valid & act[col]
        return cnt

    def _n_isolated(u):
        # coastal corners (fewer than two neighbours) are exempt
        n_bad = 0
        for nz in range(1, int(u.max()) + 1):
            act = (u <= nz) & (nz < nle)
            n_bad += int((act & has2 & (_open_neighbours(act) < 2)).sum())
        return n_bad

    for _outer in range(12):
        elemreduce[:] = False
        for nz in range(1, int(ule.max()) + 1):
            for _ in range(1000):
                active = (ule <= nz) & (nz < nle)
                bad = active & (_open_neighbours(active) < 2)
                if not bad.any():
                    break
                deepen = bad & ((nle - (nz + 1)) >= 3) & ~elemreduce \
                    & ~elemfix
                ule = np.where(deepen, nz + 1, ule)
                changed = bool(deepen.any())
                for e in np.nonzero(bad & ~deepen)[0]:
                    cands = [(ule[j] - nz, j) for j in nb[e]
                             if j >= 0 and ule[j] - nz > 0]
                    if cands:
                        j = min(cands)[1]
                        ule[j] = max(nz - 1, 1)
                        elemreduce[j] = True
                        changed = True
                # a sweep that changed nothing would repeat itself to the
                # end of the 1,000: the cells left are beyond repair
                if not changed:
                    break
        viol = ule > nle - 1
        if viol.any():
            elemfix |= viol
            ule = np.minimum(ule, np.maximum(nle - 3, 1))
            continue
        # sweep again while a raised neighbour isolated a shallower cell
        if _n_isolated(ule) == 0:
            break

    uln = np.full(cavity_depth.shape[0], nl, np.int64)
    for j in range(3):
        np.minimum.at(uln, elem_nodes[:, j], ule)
    return ule.astype(np.int64), uln.astype(np.int64)


def close_column_gaps(ule: np.ndarray, nle: np.ndarray,
                      nod_in_elem: np.ndarray) -> np.ndarray:
    """Element cavity tops [E] (1-based) raised until no node's water
    column has a gap: the layers of a node's elements, [ule - 1, nle - 1)
    each, must make one run, or the node has dry layers inside its column
    (zero area, so its control volume divides by 0).  A gap comes where a
    cavity's top lies below the bottom of a shallow neighbour (a draft
    deeper than the sea beside it: the level-6 and level-7 globes under
    ``globe.shelf_draft``, not the level-3).  An element whose top lies
    below every layer the node's elements above it reach is raised to
    where they end; repeated to a fixed point (the tops only rise, and a
    raised element keeps its bottom and has more layers).  This is the
    port's repair: ``fesom2_tpu/mesh/tables.py:derive_ulevels_cavity``
    leaves such gaps; where it leaves none, the levels are its own.
    ``nod_in_elem`` [N, K] is padded with -1."""
    ule = ule.copy()
    valid = nod_in_elem >= 0
    safe = np.where(valid, nod_in_elem, 0)
    hi = np.where(valid, nle[safe] - 1, -1)
    K = nod_in_elem.shape[1]
    while True:
        lo = np.where(valid, ule[safe] - 1, -1)
        # per (node, element): the deepest layer reached by the node's
        # elements whose runs start above this element's
        reach = np.full(nod_in_elem.shape, -1, np.int64)
        for k in range(K):
            above = valid[:, k:k + 1] & (lo[:, k:k + 1] < lo)
            reach = np.maximum(reach, np.where(above, hi[:, k:k + 1], -1))
        gap = valid & (reach >= 0) & (reach < lo)
        if not gap.any():
            return ule
        new_lo = ule - 1
        np.minimum.at(new_lo, nod_in_elem[gap], reach[gap])
        ule = new_lo + 1


def partial_bottom_depths(depth: Optional[np.ndarray], elem_nodes: np.ndarray,
                          nod_in_elem: np.ndarray, nle: np.ndarray,
                          nln: np.ndarray, zbar: np.ndarray,
                          use_partial_cell: bool,
                          partial_cell_thresh: float = 0.0,
                          thers_lev: int = 5):
    """Per-element/per-node bottom depth + bottom-layer thickness
    (ref init_bottom_elem_thickness / init_bottom_node_thickness,
    ``oce_ale.F90:199-418``)."""
    nl = zbar.shape[0]
    Z = 0.5 * (zbar[:-1] + zbar[1:])
    zb_full_e = zbar[nle - 1]
    thick_full_e = zbar[nle - 2] - zbar[nle - 1]
    if use_partial_cell and depth is not None:
        dcl = np.minimum(depth, zbar[thers_lev - 1])
        dd = dcl[elem_nodes].mean(axis=1)
        at_max = nle == nl
        z_nle_m1 = Z[np.minimum(nle, nl - 1) - 1]
        deep = np.where(at_max,
                        np.maximum(dd, zbar[nle - 1]
                                   + (zbar[nle - 1] - Z[nle - 2])),
                        np.maximum(z_nle_m1, dd))
        shallow = np.minimum(Z[nle - 2], dd)
        zbar_e_bot = np.where(dd < zbar[nle - 1], deep, shallow)
        zbar_e_bot = np.where(thick_full_e <= partial_cell_thresh,
                              zb_full_e, zbar_e_bot)
    else:
        zbar_e_bot = zb_full_e
    bottom_elem_thickness = zbar[nle - 2] - zbar_e_bot
    valid = nod_in_elem >= 0
    zadj = np.where(valid, zbar_e_bot[np.clip(nod_in_elem, 0, None)], np.inf)
    zbar_n_bot = zadj.min(axis=1)
    zbar_n_bot = np.where(np.isfinite(zbar_n_bot), zbar_n_bot, zbar[nln - 1])
    bottom_node_thickness = zbar[nln - 2] - zbar_n_bot
    return zbar_e_bot, zbar_n_bot, bottom_elem_thickness, bottom_node_thickness


@dataclass(frozen=True)
class MeshTables:
    """Static mesh geometry as tensors on one device.

    Shapes: N nodes, E elements, Ed edges, nl levels (nl-1 layers), K = max
    elements per node, KE = max edges per node.  Index tables are int32,
    -1 = missing.  ``cluster`` holds the tables of the two cluster kernels
    (``mesh/cluster.py``), derived from the fields above it.
    """
    elem_nodes: torch.Tensor        # [E,3]
    edges: torch.Tensor             # [Ed,2]
    edge_tri: torch.Tensor          # [Ed,2], -1 on boundary
    elem_neighbors: torch.Tensor    # [E,3], -1 on boundary
    elem_edges: torch.Tensor        # [E,3]
    nod_in_elem: torch.Tensor       # [N,K], -1 padded
    nod_in_elem_num: torch.Tensor   # [N]
    nod_in_elem_slot: torch.Tensor  # [N,K]
    node_edges: torch.Tensor        # [N,KE], -1 padded
    node_edge_sign: torch.Tensor    # [N,KE] +1 tail, -1 head, 0 padding
    node_neighbors: torch.Tensor    # [N,KE], -1 padded
    coords: torch.Tensor            # [N,2] radians, mesh frame
    geo_coords: torch.Tensor        # [N,2] radians, geographic frame
    elem_area: torch.Tensor         # [E] m^2
    area: torch.Tensor              # [nl,N]
    areasvol: torch.Tensor          # [nl,N]
    area_inv: torch.Tensor          # [nl,N]
    areasvol_inv: torch.Tensor      # [nl,N]
    resolution: torch.Tensor        # [N] m
    edge_dxdy: torch.Tensor         # [Ed,2] radians
    edge_cross_dxdy: torch.Tensor   # [Ed,4] m
    gradient_sca: torch.Tensor      # [E,6] 1/m
    gradient_vec: torch.Tensor      # [E,6] 1/m
    elem_cos: torch.Tensor          # [E]
    metric_factor: torch.Tensor     # [E]
    coriolis: torch.Tensor          # [E]
    coriolis_node: torch.Tensor     # [N]
    zbar: torch.Tensor              # [nl]
    Z: torch.Tensor                 # [nl-1]
    zbar_e_bot: torch.Tensor        # [E]
    zbar_n_bot: torch.Tensor        # [N]
    bottom_elem_thickness: torch.Tensor  # [E]
    bottom_node_thickness: torch.Tensor  # [N]
    nlevels_elem: torch.Tensor      # [E] int32
    nlevels_node: torch.Tensor      # [N] int32
    ulevels_elem: torch.Tensor      # [E] int32, 1-based
    ulevels_node: torch.Tensor      # [N] int32
    elem_layer_mask: torch.Tensor   # [nl-1,E] bool
    node_layer_mask: torch.Tensor   # [nl-1,N] bool
    node_level_mask: torch.Tensor   # [nl,N] bool
    bc_index_node: torch.Tensor     # [N] 1 interior, 0 lateral boundary
    n_nodes: int
    n_elems: int
    n_edges: int
    n_edges_in: int
    nl: int
    cyclic_length: float
    cartesian: bool
    ocean_area: float
    cluster: Optional[ClusterTables] = None


def build_mesh(path: str, *, cyclic_length_deg: float = 360.0,
               force_rotation: bool = False, use_partial_cell: bool = False,
               partial_cell_thresh: float = 0.0, cavity_depth=None,
               dtype=torch.float64, device) -> MeshTables:
    """Read a FESOM-format mesh directory and derive all static geometry;
    with ``use_partial_cell`` the bottom cells follow the node depths.
    ``cavity_depth`` [N] (the ice-shelf draft, negative; 0 in open ocean)
    replaces the directory's ``cavity_depth.out``, if it has one."""
    raw = read_raw_mesh(path, force_rotation=force_rotation)
    if cavity_depth is not None:
        raw = replace(raw, cavity_depth=np.asarray(cavity_depth, np.float64))
    return build_mesh_from_raw(raw, cyclic_length_deg=cyclic_length_deg,
                               force_rotation=force_rotation,
                               use_partial_cell=use_partial_cell,
                               partial_cell_thresh=partial_cell_thresh,
                               dtype=dtype, device=device)


def build_mesh_from_raw(raw: RawMesh, *, cyclic_length_deg: float = 360.0,
                        force_rotation: bool = False, alpha: float = 50.0,
                        beta: float = 15.0, gamma: float = -90.0,
                        use_partial_cell: bool = False,
                        partial_cell_thresh: float = 0.0,
                        dtype=torch.float64, device) -> MeshTables:
    """The tables of a RawMesh; a draft in ``raw.cavity_depth`` puts
    ice-shelf cavities over the columns beneath it."""
    cl = cyclic_length_deg * rad
    coords = raw.coords
    N, E, nl = raw.n_nodes, raw.n_elems, raw.nl
    elem_nodes = raw.elem_nodes

    # ---- edges -----------------------------------------------------------
    if raw.edges is not None:
        edges, edge_tri, n_in = raw.edges, raw.edge_tri, raw.edge2D_in
    else:
        edges, edge_tri, n_in = build_edges(elem_nodes, coords, cl)
    Ed = edges.shape[0]

    # ---- elem_edges / elem_neighbors (ref load_edges :1606-1692) ---------
    # elem_edges[e, j] is the edge OPPOSITE node j
    edge_key = np.minimum(edges[:, 0], edges[:, 1]).astype(np.int64) * N \
        + np.maximum(edges[:, 0], edges[:, 1])
    key_order = np.argsort(edge_key)
    sorted_keys = edge_key[key_order]

    def _edge_lookup(na, nb):
        q = np.minimum(na, nb).astype(np.int64) * N + np.maximum(na, nb)
        return key_order[np.searchsorted(sorted_keys, q)]

    e0, e1, e2 = elem_nodes[:, 0], elem_nodes[:, 1], elem_nodes[:, 2]
    elem_edges = np.stack([_edge_lookup(e1, e2), _edge_lookup(e2, e0),
                           _edge_lookup(e0, e1)], axis=1)
    et0 = edge_tri[elem_edges, 0]
    et1 = edge_tri[elem_edges, 1]
    elem_neighbors = np.where(et0 == np.arange(E)[:, None], et1, et0)

    # ---- node->element adjacency (ref find_neighbors :1700-1753) ---------
    num = np.zeros(N, np.int64)
    for j in range(3):
        np.add.at(num, elem_nodes[:, j], 1)
    K = int(num.max())
    inodes = elem_nodes.T.ravel()
    ielems = np.tile(np.arange(E), 3)
    order = np.argsort(inodes, kind="stable")
    inodes_s, ielems_s = inodes[order], ielems[order]
    offsets = np.zeros(N + 1, np.int64)
    np.cumsum(num, out=offsets[1:])
    slot = np.arange(3 * E) - offsets[inodes_s]
    nod_in_elem = np.full((N, K), -1, np.int64)
    nod_in_elem[inodes_s, slot] = ielems_s
    safe_nie = np.where(nod_in_elem >= 0, nod_in_elem, 0)
    nod_in_elem_slot = np.argmax(
        elem_nodes[safe_nie] == np.arange(N)[:, None, None], axis=-1)

    # ---- node->edge incidence (gather-based divergence assembly) ---------
    e_nodes_flat = edges.T.ravel()
    e_ids = np.tile(np.arange(Ed), 2)
    e_sign = np.concatenate([np.ones(Ed, np.int64), -np.ones(Ed, np.int64)])
    eorder = np.argsort(e_nodes_flat, kind="stable")
    en_s, eid_s, esg_s = e_nodes_flat[eorder], e_ids[eorder], e_sign[eorder]
    ecount = np.bincount(e_nodes_flat, minlength=N)
    KE = int(ecount.max())
    eoff = np.zeros(N + 1, np.int64)
    np.cumsum(ecount, out=eoff[1:])
    eslot = np.arange(2 * Ed) - eoff[en_s]
    node_edges = np.full((N, KE), -1, np.int64)
    node_edge_sign = np.zeros((N, KE), np.int64)
    node_edges[en_s, eslot] = eid_s
    node_edge_sign[en_s, eslot] = esg_s
    ne_safe = np.clip(node_edges, 0, None)
    node_neighbors = np.where(
        node_edges >= 0,
        np.where(node_edge_sign > 0, edges[ne_safe, 1], edges[ne_safe, 0]),
        -1)

    # ---- levels ----------------------------------------------------------
    if raw.nlevels_elem is not None and raw.nlevels_node is not None:
        nle, nln = raw.nlevels_elem, raw.nlevels_node
    else:
        nle, nln = derive_levels(raw, elem_neighbors)
    if raw.cavity_depth is not None:
        ule, _ = derive_ulevels_cavity(raw.cavity_depth, elem_nodes,
                                       elem_neighbors, nle, raw.zbar)
        ule = close_column_gaps(ule, nle, nod_in_elem)
        # a node's top: the highest of its elements'
        uln = np.where(nod_in_elem >= 0, ule[safe_nie], nl).min(1)
    else:
        ule = np.ones(E, np.int64)
        uln = np.ones(N, np.int64)

    zbar = raw.zbar
    Z = 0.5 * (zbar[:-1] + zbar[1:])
    (zbar_e_bot, zbar_n_bot, bottom_elem_thickness,
     bottom_node_thickness) = partial_bottom_depths(
        raw.depth, elem_nodes, nod_in_elem, nle, nln, zbar,
        use_partial_cell, partial_cell_thresh)

    lay = np.arange(nl - 1)
    elem_layer_mask = (lay[:, None] < (nle[None, :] - 1)) \
        & (lay[:, None] >= (ule[None, :] - 1))
    node_layer_mask = (lay[:, None] < (nln[None, :] - 1)) \
        & (lay[:, None] >= (uln[None, :] - 1))
    lev = np.arange(nl)
    node_level_mask = (lev[:, None] < nln[None, :]) \
        & (lev[:, None] >= (uln[None, :] - 1))

    # ---- element centers, areas (ref mesh_areas :1882-1894) --------------
    exy = coords[elem_nodes]
    ex = exy[..., 0]
    amin = ex.min(axis=1, keepdims=True)
    ex = np.where(ex - amin >= cl / 2.0, ex - cl, ex)
    ex = np.where(ex - amin < -cl / 2.0, ex + cl, ex)
    center_x = ex.mean(axis=1)
    center_y = exy[..., 1].mean(axis=1)
    ay = np.cos(center_y)
    a1 = _trim_cyclic(coords[elem_nodes[:, 1], 0] - coords[elem_nodes[:, 0], 0], cl) * ay
    b1 = _trim_cyclic(coords[elem_nodes[:, 2], 0] - coords[elem_nodes[:, 0], 0], cl) * ay
    a2 = coords[elem_nodes[:, 1], 1] - coords[elem_nodes[:, 0], 1]
    b2 = coords[elem_nodes[:, 2], 1] - coords[elem_nodes[:, 0], 1]
    elem_area = 0.5 * np.abs(a1 * b2 - b1 * a2)

    # scalar (median-dual) areas per level (ref mesh_areas :1932-1958)
    area = np.zeros((nl, N))
    contrib_levels = np.where(elem_layer_mask, (elem_area / 3.0)[None, :], 0.0)
    for j in range(3):
        np.add.at(area[:nl - 1].T, elem_nodes[:, j], contrib_levels.T)
    if raw.cavity_depth is not None:
        # under a cavity the scalar cell's volume area is the lower prism
        # face where an adjacent element is still closed (ref :1952-1977)
        cav_contrib = np.zeros((nl - 1, N), np.int64)
        closed = lay[:, None] < (ule[None, :] - 1)
        for j in range(3):
            np.add.at(cav_contrib.T, elem_nodes[:, j],
                      closed.T.astype(np.int64))
        areasvol = area.copy()
        nz_dn = np.minimum(lay[:, None] + 1, np.maximum(nln[None, :] - 2, 0))
        area_dn = np.take_along_axis(area[:nl - 1], nz_dn, axis=0)
        areasvol[:nl - 1] = np.where((cav_contrib > 0) & node_layer_mask,
                                     area_dn, area[:nl - 1])
    else:
        areasvol = area.copy()

    elem_area = elem_area * r_earth * r_earth
    area = area * r_earth * r_earth
    areasvol = areasvol * r_earth * r_earth
    area_inv = np.where(area > 0, 1.0 / np.where(area > 0, area, 1.0), 0.0)
    areasvol_inv = np.where(areasvol > 0,
                            1.0 / np.where(areasvol > 0, areasvol, 1.0), 0.0)

    resolution = np.sqrt(areasvol[0] / pi) * 2.0
    for _ in range(3):
        rsum = resolution[elem_nodes].sum(axis=1) / 3.0 * elem_area
        acc = np.zeros(N)
        vol = np.zeros(N)
        for j in range(3):
            np.add.at(acc, elem_nodes[:, j], rsum)
            np.add.at(vol, elem_nodes[:, j], elem_area)
        resolution = acc / np.maximum(vol, 1e-30)

    # ---- geographic coords / coriolis (ref mesh_auxiliary :2147-2173) ----
    if force_rotation:
        m = rotation_matrix(alpha, beta, gamma)
        glon, glat = r2g(coords[:, 0], coords[:, 1], m)
        ge_lon, ge_lat = r2g(center_x, center_y, m)
    else:
        glon, glat = coords[:, 0].copy(), coords[:, 1].copy()
        ge_lon, ge_lat = center_x, center_y
    glon = np.where(glon > 2 * pi, glon - 2 * pi, glon)
    glon = np.where(glon < -2 * pi, glon + 2 * pi, glon)
    geo_coords = np.stack([glon, glat], axis=1)
    coriolis_node = 2.0 * omega * np.sin(glat)
    coriolis = 2.0 * omega * np.sin(ge_lat)

    elem_cos = np.cos(center_y)
    metric_factor = np.tan(center_y) / r_earth

    # ---- edge geometry (ref :2199-2238) ----------------------------------
    n1, n2 = edges[:, 0], edges[:, 1]
    edge_dxdy = np.stack([
        _trim_cyclic(coords[n2, 0] - coords[n1, 0], cl),
        coords[n2, 1] - coords[n1, 1]], axis=1)
    ax_ = coords[n1, 0].copy()
    bx_ = coords[n2, 0].copy()
    d = ax_ - bx_
    ax_ = np.where(d > cl / 2.0, ax_ - cl, ax_)
    bx_ = np.where(d < -cl / 2.0, bx_ - cl, bx_)
    ecx = 0.5 * (ax_ + bx_)
    ecy = 0.5 * (coords[n1, 1] + coords[n2, 1])
    edge_cross_dxdy = np.zeros((Ed, 4))
    for k in range(2):
        el = edge_tri[:, k]
        valid = el >= 0
        bx = np.where(valid, center_x[np.clip(el, 0, None)], 0.0) - ecx
        by = np.where(valid, center_y[np.clip(el, 0, None)], 0.0) - ecy
        bx = _trim_cyclic(bx, cl) * elem_cos[np.clip(el, 0, None)]
        edge_cross_dxdy[:, 2 * k] = np.where(valid, bx * r_earth, 0.0)
        edge_cross_dxdy[:, 2 * k + 1] = np.where(valid, by * r_earth, 0.0)

    # ---- scalar gradient coefficients (ref :2284-2306) -------------------
    dX31 = _trim_cyclic(coords[elem_nodes[:, 2], 0] - coords[elem_nodes[:, 0], 0], cl) * elem_cos
    dX21 = _trim_cyclic(coords[elem_nodes[:, 1], 0] - coords[elem_nodes[:, 0], 0], cl) * elem_cos
    dY31 = coords[elem_nodes[:, 2], 1] - coords[elem_nodes[:, 0], 1]
    dY21 = coords[elem_nodes[:, 1], 1] - coords[elem_nodes[:, 0], 1]
    dfac = -0.5 * r_earth / elem_area
    gradient_sca = np.stack([
        (-dY31 + dY21) * dfac, dY31 * dfac, -dY21 * dfac,
        (dX31 - dX21) * dfac, -dX31 * dfac, dX21 * dfac], axis=1)

    # ---- vector gradient coefficients, least squares (ref :2369-2401) ----
    xs = np.zeros((E, 3))
    ys = np.zeros((E, 3))
    for j in range(3):
        nb = elem_neighbors[:, j]
        has = nb >= 0
        bxn = np.where(has, center_x[np.clip(nb, 0, None)], 0.0)
        byn = np.where(has, center_y[np.clip(nb, 0, None)], 0.0)
        ed = elem_edges[:, j]
        ea, eb = edges[ed, 0], edges[ed, 1]
        a1_ = coords[ea, 0].copy()
        b1_ = coords[eb, 0].copy()
        dd = a1_ - b1_
        a1_ = np.where(dd > cl / 2.0, a1_ - cl, a1_)
        b1_ = np.where(dd < -cl / 2.0, b1_ - cl, b1_)
        becx = 0.5 * (a1_ + b1_)
        becy = 0.5 * (coords[ea, 1] + coords[eb, 1])
        xs[:, j] = np.where(has, _trim_cyclic(bxn - center_x, cl),
                            2.0 * _trim_cyclic(becx - center_x, cl))
        ys[:, j] = np.where(has, byn - center_y, 2.0 * (becy - center_y))
    xs = xs * elem_cos[:, None] * r_earth
    ys = ys * r_earth
    cxx = (xs ** 2).sum(axis=1)
    cxy = (xs * ys).sum(axis=1)
    cyy = (ys ** 2).sum(axis=1)
    det = cxy * cxy - cxx * cyy
    gradient_vec = np.concatenate([
        (cxy[:, None] * ys - cyy[:, None] * xs) / det[:, None],
        (cxy[:, None] * xs - cxx[:, None] * ys) / det[:, None]], axis=1)

    # ---- lateral boundary flag (ref :2404-2413) --------------------------
    bc_index_node = np.ones(N)
    bnd_edges = np.arange(Ed) >= n_in
    for k in range(2):
        bc_index_node[edges[bnd_edges, k]] = 0.0

    f = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=device).to(dtype)
    i = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=device)
    b = lambda x: torch.as_tensor(np.asarray(x, bool), device=device)
    mesh = MeshTables(
        elem_nodes=i(elem_nodes), edges=i(edges), edge_tri=i(edge_tri),
        elem_neighbors=i(elem_neighbors), elem_edges=i(elem_edges),
        nod_in_elem=i(nod_in_elem), nod_in_elem_num=i(num),
        nod_in_elem_slot=i(nod_in_elem_slot),
        node_edges=i(node_edges), node_edge_sign=f(node_edge_sign),
        node_neighbors=i(node_neighbors),
        coords=f(coords), geo_coords=f(geo_coords),
        elem_area=f(elem_area), area=f(area), areasvol=f(areasvol),
        area_inv=f(area_inv), areasvol_inv=f(areasvol_inv),
        resolution=f(resolution), edge_dxdy=f(edge_dxdy),
        edge_cross_dxdy=f(edge_cross_dxdy), gradient_sca=f(gradient_sca),
        gradient_vec=f(gradient_vec), elem_cos=f(elem_cos),
        metric_factor=f(metric_factor), coriolis=f(coriolis),
        coriolis_node=f(coriolis_node), zbar=f(zbar), Z=f(Z),
        zbar_e_bot=f(zbar_e_bot), zbar_n_bot=f(zbar_n_bot),
        bottom_elem_thickness=f(bottom_elem_thickness),
        bottom_node_thickness=f(bottom_node_thickness),
        nlevels_elem=i(nle), nlevels_node=i(nln),
        ulevels_elem=i(ule), ulevels_node=i(uln),
        elem_layer_mask=b(elem_layer_mask),
        node_layer_mask=b(node_layer_mask),
        node_level_mask=b(node_level_mask),
        bc_index_node=f(bc_index_node),
        n_nodes=N, n_elems=E, n_edges=Ed, n_edges_in=int(n_in), nl=nl,
        cyclic_length=float(cl), cartesian=False,
        ocean_area=float(area[0].sum()))
    return replace(mesh, cluster=build_cluster_tables(mesh))
