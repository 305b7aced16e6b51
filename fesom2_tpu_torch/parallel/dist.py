"""The coupled step across ranks: per-rank local meshes, halo exchanges in
the operators' hooks, owned-masked global sums.

The port of ``fesom2_tpu/parallel/dist.py``.  The JAX package runs one
program over a device mesh under ``shard_map`` with stacked ``[S, ...]``
arrays; here each shard is a process of a ``torch.distributed`` group:

- ``build_layout`` (host numpy, once): the node partition
  (``parallel/partition.py``), every shard's entity closure (owned nodes,
  the elements and edges around them, one more ring, the MUSCL up/downwind
  triangles), the renumbering into ``[owned | pad | halo | pad]`` blocks of
  one size on every shard, the local mesh tables, the exchange schedules
  and the local SSH preconditioners and ice subdomains.  The stacked
  tables stay numpy; rank ``r`` takes row ``r`` (``rank_bundle``) as
  tensors on its device (``rank_model``).
- ``DistContext`` (one rank's schedule as tensors, over the process
  group): ``exchange_nodes`` / ``exchange_elems`` run the neighbour rounds
  of the schedule, one ``batch_isend_irecv`` of per-pair buffers a round,
  then one gather into the halo block; ``accumulate_nodes`` adds halo-slot
  contributions into their owners by one ``all_to_all_single``;
  ``gsum_nodes`` is the owned-masked sum and one ``all_reduce``.
- the hooks of ``core/ops.py`` (``dist_context``, ``halo_fix_nodes``,
  ``halo_fix_elems``, ``halo_accumulate_nodes``, ``node_sum``) call them
  after every assembly, at the JAX package's call sites; outside a
  context every hook is the identity.
- ``run_ranks`` starts S processes (spawn, a FileStore in a temporary
  directory) and ``dryrun_multichip`` runs two coupled steps over them,
  held against the one-device step of ``prepare_dist_model``.

Why the physics runs unchanged on a rank: the local tables are complete
for owned entities (every element and edge around an owned node is
local), so assemblies are exact at owned slots; the hooks replace the halo
slots with the owners' values right after each assembly, so every node and
element field is owner-consistent at every local slot, and pure gathers
need no exchange.  Edges carry no state and are never exchanged.

Under gloo a CUDA tensor's packed buffer goes through pinned host memory
(gloo moves host memory only: its transport refuses a device pointer);
under nccl the buffers stay on the card.  ``DistContext.timers`` keeps the
exchanges' counts, bytes and host time.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist
from torch.profiler import record_function

from ..constants import rad
from ..mesh import MeshTables
from ..mesh.cluster import build_cluster_tables, elem_slot_table
from .partition import partition_nodes, partition_nodes_hierarchical


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# --------------------------------------------------------------------------
# the exchange schedule (host numpy, stacked on a leading shard axis)
# --------------------------------------------------------------------------
@dataclass
class HaloSchedule:
    """Per-shard exchange tables, stacked [S, ...] (numpy int64)."""
    node_send: np.ndarray     # [S, S, Mn]: local index of the owned node
    #                           that shard s sends to shard d at slot m; -1
    node_src: np.ndarray      # [S, Hn]: per halo slot, its index into the
    #                           flattened [S * Mn] receive; -1 pad
    elem_send: np.ndarray     # [S, S, Me]
    elem_src: np.ndarray      # [S, He]
    own_node_f: np.ndarray    # [S, n_loc] 1.0 at real owned node slots
    # the reverse (halo -> owner) direction, for the block-Schwarz combine
    node_rev_pack: np.ndarray    # [S, S * Mn] halo slot to pack at each
    #                              flat send position, or -1
    node_rev_gather: np.ndarray  # [S, n_own, R] flat receive positions
    #                              (d * Mn + m) adding into each owned slot
    # the same on the per-shard ice subdomain (EVP subcycles)
    sub_send: Optional[np.ndarray] = None
    sub_src: Optional[np.ndarray] = None
    # the neighbour rounds: round r sends [S, M_r] (-1 pad) along the
    # pairs ``*_perms[r]``; the received buffers, concatenated in round
    # order, are gathered into the halo block by ``*_halo_src`` [S, H]
    node_round_send: tuple = ()
    node_halo_src: Optional[np.ndarray] = None
    elem_round_send: tuple = ()
    elem_halo_src: Optional[np.ndarray] = None
    sub_round_send: tuple = ()
    sub_halo_src: Optional[np.ndarray] = None
    n_own_node: int = 0
    n_own_elem: int = 0
    n_own_sub: int = 0
    node_perms: tuple = ()
    elem_perms: tuple = ()
    sub_perms: tuple = ()


def _exchange_schedule(S, owner_of, l2g, g2l, n_own_blk, n_loc_blk):
    """(send [S, S, M], src [S, H], perms, round_send, halo_src) of one
    entity kind (``build_sched`` of ``fesom2_tpu/parallel/dist.py:535-604``):
    shard s sends to d, in ascending global id, the owned entities d holds
    as halo; the directed neighbour pairs are edge-coloured greedily,
    largest pair first, into rounds in which no shard sends or receives
    twice, each round's buffer sized to its largest pair."""
    send_lists = [[[] for _ in range(S)] for _ in range(S)]
    for d in range(S):
        halo_g = l2g[d, n_own_blk:]
        for g in halo_g[halo_g >= 0]:
            send_lists[owner_of[g]][d].append(g)
    M = max(1, max(len(send_lists[s][d]) for s in range(S) for d in range(S)))
    send = np.full((S, S, M), -1, np.int64)
    for s in range(S):
        for d in range(S):
            gl = send_lists[s][d]
            send[s, d, :len(gl)] = g2l[s, gl]
    H = n_loc_blk - n_own_blk
    src = np.full((S, H), -1, np.int64)
    for d in range(S):
        pos_of = {}
        for s in range(S):
            for m, g in enumerate(send_lists[s][d]):
                pos_of[g] = s * M + m
        for h, g in enumerate(l2g[d, n_own_blk:]):
            if g >= 0:
                src[d, h] = pos_of[g]

    pairs = [(s, d) for s in range(S) for d in range(S)
             if send_lists[s][d] and s != d]
    pairs.sort(key=lambda p: -len(send_lists[p[0]][p[1]]))
    rounds = []
    for s, d in pairs:
        for r in rounds:
            if s not in r["src"] and d not in r["dst"]:
                r["pairs"].append((s, d))
                r["src"].add(s)
                r["dst"].add(d)
                break
        else:
            rounds.append({"pairs": [(s, d)], "src": {s}, "dst": {d}})
    perms, round_send, pair_off, off = [], [], {}, 0
    for r in rounds:
        Mr = max(len(send_lists[s][d]) for s, d in r["pairs"])
        tbl = np.full((S, Mr), -1, np.int64)
        for s, d in r["pairs"]:
            gl = send_lists[s][d]
            tbl[s, :len(gl)] = g2l[s, gl]
            pair_off[(s, d)] = off
        perms.append(tuple(sorted(r["pairs"])))
        round_send.append(tbl)
        off += Mr
    halo_src = np.full((S, H), -1, np.int64)
    for d in range(S):
        posmap = {}
        for s in range(S):
            if (s, d) in pair_off:
                for m, g in enumerate(send_lists[s][d]):
                    posmap[g] = pair_off[(s, d)] + m
        for h, g in enumerate(l2g[d, n_own_blk:]):
            if g >= 0:
                halo_src[d, h] = posmap[g]
    return send, src, tuple(perms), tuple(round_send), halo_src


# --------------------------------------------------------------------------
# the layout (host numpy, once)
# --------------------------------------------------------------------------
# the local mesh's scalar fields and, per table, (fill, axis) of the rows
# sliced from the global mesh
_NODE_FIELDS = (("coords", 0.0, 0), ("geo_coords", 0.0, 0),
                ("area", 0.0, -1), ("areasvol", 0.0, -1),
                ("area_inv", 0.0, -1), ("areasvol_inv", 0.0, -1),
                ("resolution", 1.0, -1), ("coriolis_node", 0.0, -1),
                ("nlevels_node", 1, -1), ("ulevels_node", 1, -1),
                ("zbar_n_bot", 0.0, -1), ("bottom_node_thickness", 0.0, -1),
                ("node_layer_mask", False, -1), ("bc_index_node", 0.0, -1))
_ELEM_FIELDS = (("elem_area", 0.0, -1), ("gradient_sca", 0.0, 0),
                ("gradient_vec", 0.0, 0), ("elem_cos", 1.0, -1),
                ("metric_factor", 0.0, -1), ("coriolis", 0.0, -1),
                ("nlevels_elem", 1, -1), ("ulevels_elem", 1, -1),
                ("zbar_e_bot", 0.0, -1), ("bottom_elem_thickness", 0.0, -1),
                ("elem_layer_mask", False, -1))
_SUB_NODE_STATS = ("coriolis_node", "bc_index_node")


@dataclass
class DistLayout:
    """The partition, the local<->global maps and the stacked per-shard
    tables (numpy) of ``build_layout``."""
    S: int
    part: np.ndarray              # [N] node -> shard
    n_own: int                    # padded owned-node block size
    n_loc: int                    # owned + halo block
    e_own: int
    e_loc: int
    ed_loc: int
    sizes: tuple                  # (N, E, Ed) of the global mesh
    node_l2g: np.ndarray          # [S, n_loc] global id or -1
    elem_l2g: np.ndarray          # [S, e_loc]
    edge_l2g: np.ndarray          # [S, ed_loc]
    node_from: np.ndarray         # [N] gather index into flat [S * n_loc]
    elem_from: np.ndarray         # [E]
    sched: HaloSchedule
    mesh_local: dict              # field -> stacked [S, ...] local tables
    mesh_meta: dict               # the local MeshTables' scalars
    st_local: Optional[dict] = None      # TracerStatics fields, stacked
    diag_inv_local: Optional[np.ndarray] = None  # [S, n_loc] Jacobi
    block_pc_local: Optional[dict] = None  # local BlockSchwarz, stacked
    ice_sub_local: Optional[dict] = None   # local IceSubdomain, stacked

    @property
    def halo_slots(self) -> dict:
        """Slots of one forward exchange a shard sends, per kind: the sum
        of its rounds' buffer widths."""
        s = self.sched
        out = {}
        for kind, rounds in (("node", s.node_round_send),
                             ("elem", s.elem_round_send),
                             ("sub", s.sub_round_send)):
            out[kind] = int(sum(t.shape[1] for t in rounds))
        return out


def _build_ice_sub_local(mesh, lat_deg, S, part, node_l2g, elem_l2g, n_own,
                         n_loc, e_loc, ed_loc, locals_):
    """The per-shard EVP polar-cap subdomain and its exchange schedule
    (``fesom2_tpu/parallel/dist.py:265-394``).  Membership is decided on
    the global subdomain (|lat| > lat_deg cap elements and their node
    closure), so every shard agrees on it; each shard's tables are its
    local [owned | halo] slots of those entities, padded to one size.
    The sub sizes are kept apart from n_loc, e_loc and ed_loc, and the
    context names the sub schedule explicitly besides."""
    N = mesh.n_nodes
    glat = np.abs(_np(mesh.geo_coords)[:, 1]) / rad
    en_g = _np(mesh.elem_nodes).astype(np.int64)
    emask_g = (glat > lat_deg)[en_g].any(1)
    node_in_sub = np.zeros(N, bool)
    node_in_sub[np.unique(en_g[emask_g])] = True

    own_subs, halo_subs, esubs = [], [], []
    for s in range(S):
        nl2g = node_l2g[s]
        ins = (nl2g >= 0) & node_in_sub[np.clip(nl2g, 0, None)]
        own_subs.append(np.nonzero(ins[:n_own])[0])
        halo_subs.append(np.nonzero(ins[n_own:])[0] + n_own)
        el2g = elem_l2g[s]
        esubs.append(np.nonzero((el2g >= 0)
                                & emask_g[np.clip(el2g, 0, None)])[0])

    n_own_sub = max(len(x) for x in own_subs)
    n_halo_sub = max(len(x) for x in halo_subs) + 1   # >= 1 pad slot
    Ns = n_own_sub + n_halo_sub
    while Ns in (n_loc, e_loc, ed_loc):
        Ns += 1
        n_halo_sub += 1
    Es = max(len(x) for x in esubs) + 1
    while Es in (n_loc, e_loc, ed_loc, Ns):
        Es += 1

    dummy_node, dummy_elem = n_loc - 1, e_loc - 1
    sub_nodes = np.full((S, Ns), dummy_node, np.int64)   # local slot ids
    sub_l2g = np.full((S, Ns), -1, np.int64)             # global node ids
    sub_g2l = np.full((S, N), -1, np.int64)
    sub_elems = np.full((S, Es), dummy_elem, np.int64)
    node_mask = np.zeros((S, n_loc), bool)
    en_sub = np.full((S, Es, 3), Ns - 1, np.int64)       # pad -> pad slot
    nie_rows, slot_rows = [], []
    stat = {k: np.zeros((S, Es), locals_[0][k].dtype)
            for k in ("metric_factor", "elem_area")}
    stat["gradient_sca"] = np.zeros((S, Es, 6),
                                    locals_[0]["gradient_sca"].dtype)
    nstat = {k: np.zeros((S, Ns), locals_[0][k].dtype)
             for k in _SUB_NODE_STATS}
    area = np.zeros((S, 1, Ns), locals_[0]["area"].dtype)

    for s in range(S):
        o, h, e = own_subs[s], halo_subs[s], esubs[s]
        sub_nodes[s, :len(o)] = o
        sub_nodes[s, n_own_sub:n_own_sub + len(h)] = h
        sub_l2g[s, :len(o)] = node_l2g[s][o]
        sub_l2g[s, n_own_sub:n_own_sub + len(h)] = node_l2g[s][h]
        v = sub_l2g[s] >= 0
        sub_g2l[s, sub_l2g[s, v]] = np.nonzero(v)[0]
        sub_elems[s, :len(e)] = e
        node_mask[s, o] = True
        node_mask[s, h] = True
        m = np.full(n_loc, -1, np.int64)                 # local -> sub slot
        m[o] = np.arange(len(o))
        m[h] = n_own_sub + np.arange(len(h))
        ens = m[locals_[s]["elem_nodes"][e]]
        if (ens < 0).any():
            raise AssertionError("sub element vertex outside sub node set")
        en_sub[s, :len(e)] = ens
        for k in ("metric_factor", "elem_area"):
            stat[k][s, :len(e)] = locals_[s][k][e]
        stat["gradient_sca"][s, :len(e)] = locals_[s]["gradient_sca"][e]
        for k in _SUB_NODE_STATS:
            nstat[k][s] = np.where(sub_l2g[s] >= 0,
                                   locals_[s][k][sub_nodes[s]], 0.0)
        area[s, 0] = np.where(sub_l2g[s] >= 0,
                              locals_[s]["area"][0][sub_nodes[s]], 0.0)
        # node -> element incidence on the sub numbering (tables.py pattern)
        num = np.zeros(Ns, np.int64)
        for j in range(3):
            np.add.at(num, ens[:, j], 1)
        Ks = max(1, int(num.max()))
        nie = np.full((Ns, Ks), -1, np.int64)
        inodes = ens.T.ravel()
        ielems = np.tile(np.arange(len(e)), 3)
        order = np.argsort(inodes, kind="stable")
        offs = np.zeros(Ns + 1, np.int64)
        np.cumsum(num, out=offs[1:])
        pos = np.arange(3 * len(e)) - offs[inodes[order]]
        nie[inodes[order], pos] = ielems[order]
        safe = np.where(nie >= 0, nie, 0)
        slot = np.argmax(ens[safe] == np.arange(Ns)[:, None, None], axis=-1)
        nie_rows.append(nie)
        slot_rows.append(slot)

    K = max(r.shape[1] for r in nie_rows)
    nie_all = np.full((S, Ns, K), -1, np.int64)
    slot_all = np.zeros((S, Ns, K), np.int64)
    for s in range(S):
        nie_all[s, :, :nie_rows[s].shape[1]] = nie_rows[s]
        slot_all[s, :, :slot_rows[s].shape[1]] = slot_rows[s]

    sched = _exchange_schedule(S, part, sub_l2g, sub_g2l, n_own_sub, Ns)
    sub = dict(sub_nodes=sub_nodes, sub_elems=sub_elems, node_mask=node_mask,
               elem_nodes=en_sub, nod_in_elem=nie_all,
               nod_in_elem_slot=slot_all,
               gradient_sca=stat["gradient_sca"],
               metric_factor=stat["metric_factor"],
               elem_area=stat["elem_area"], area=area,
               coriolis_node=nstat["coriolis_node"],
               bc_index_node=nstat["bc_index_node"],
               n_elems=int(Es), n_nodes=int(Ns))
    return sub, sched, n_own_sub


def build_layout(mesh: MeshTables, S: int, st=None, part=None, cfg=None,
                 n_part=None) -> DistLayout:
    """Partition, renumber, and build the local meshes, the exchange
    schedules, the local tracer statics, SSH preconditioners (with
    ``cfg``) and ice subdomains (where ``cfg.ice.evp_subdomain_lat`` is
    set): ``fesom2_tpu/parallel/dist.py:397-795``, table for table.
    ``part`` [N] gives the partition (``parallel/sharding.py``'s
    ``block_partition`` is the contiguous-block placement), else
    ``partition_nodes`` (bisection with Kernighan-Lin sweeps, the JAX
    package's default); ``n_part=(hosts, cards)`` asks for the two-level
    partition (``partition_nodes_hierarchical``), hosts * cards == S."""
    en = _np(mesh.elem_nodes).astype(np.int64)
    edges = _np(mesh.edges).astype(np.int64)
    etri = _np(mesh.edge_tri).astype(np.int64)
    eedges = _np(mesh.elem_edges).astype(np.int64)
    enb = _np(mesh.elem_neighbors).astype(np.int64)
    nie_g = _np(mesh.nod_in_elem).astype(np.int64)
    nies_g = _np(mesh.nod_in_elem_slot).astype(np.int64)
    nedg_g = _np(mesh.node_edges).astype(np.int64)
    nsgn_g = _np(mesh.node_edge_sign)
    nnb_g = _np(mesh.node_neighbors).astype(np.int64)
    updn = _np(st.edge_up_dn_tri).astype(np.int64) if st is not None \
        else None
    N, E, Ed = mesh.n_nodes, mesh.n_elems, mesh.n_edges
    n_in = mesh.n_edges_in

    if part is None:
        if n_part is not None:
            hosts, chips = (1, n_part) if isinstance(n_part, int) \
                else (int(n_part[0]), int(n_part[1]))
            if hosts * chips != S:
                raise ValueError(f"n_part {n_part} != S={S}")
            part, _ = partition_nodes_hierarchical(mesh, n_part)
        else:
            part = partition_nodes(mesh, S)
    part = np.asarray(part, np.int64)
    elem_owner = part[en[:, 0]]

    # ---- per-shard entity closure ----------------------------------------
    own_nodes, halo_nodes, e_own_sets, loc_edges_in, loc_edges_bnd = \
        [], [], [], [], []
    for s in range(S):
        ownN = np.nonzero(part == s)[0]
        node_is = np.zeros(N, bool)
        node_is[ownN] = True
        # edges incident to owned nodes
        ed1 = node_is[edges[:, 0]] | node_is[edges[:, 1]]
        # elements around owned nodes, on those edges, and the MUSCL
        # up/downwind triangles of those edges (eDim + eXDim analog)
        el_is = node_is[en].any(1)
        adj = etri[ed1]
        el_is[adj[adj >= 0]] = True
        if updn is not None:
            ud = updn[ed1]
            el_is[ud[ud >= 0]] = True
        # one more ring: the elements across every edge of the element set
        # (the viscosity filter's du = u[et1] - u[et2] on their edges)
        ed2 = np.zeros(Ed, bool)
        ed2[eedges[el_is].ravel()] = True
        ed2 |= ed1
        adj2 = etri[ed2]
        el_is[adj2[adj2 >= 0]] = True
        ed_is = ed2.copy()
        ed_is[eedges[el_is].ravel()] = True
        node_all = node_is.copy()
        node_all[en[el_is].ravel()] = True
        node_all[edges[ed_is].ravel()] = True

        eids = np.nonzero(el_is)[0]
        edids = np.nonzero(ed_is)[0]
        own_nodes.append(ownN)
        halo_nodes.append(np.nonzero(node_all & ~node_is)[0])
        e_own_sets.append((eids[elem_owner[eids] == s],
                           eids[elem_owner[eids] != s]))
        loc_edges_in.append(edids[edids < n_in])
        loc_edges_bnd.append(edids[edids >= n_in])

    # ---- uniform padded block sizes ---------------------------------------
    n_own = max(len(x) for x in own_nodes)
    n_loc = n_own + max(len(x) for x in halo_nodes) + 1   # >= 1 dummy
    e_own = max(len(a) for a, _ in e_own_sets)
    e_loc = e_own + max(len(b) for _, b in e_own_sets) + 1
    ed_in = max(len(x) for x in loc_edges_in)
    ed_loc = ed_in + max(len(x) for x in loc_edges_bnd) + 1
    # the tree localizer dispatches on the last axis: keep the sizes apart
    while len({n_loc, e_loc, ed_loc}) < 3:
        ed_loc += 1

    # ---- local <-> global maps -------------------------------------------
    node_l2g = np.full((S, n_loc), -1, np.int64)
    elem_l2g = np.full((S, e_loc), -1, np.int64)
    edge_l2g = np.full((S, ed_loc), -1, np.int64)
    node_g2l = np.full((S, N), -1, np.int64)
    elem_g2l = np.full((S, E), -1, np.int64)
    edge_g2l = np.full((S, Ed), -1, np.int64)
    for s in range(S):
        o, h = own_nodes[s], halo_nodes[s]
        node_l2g[s, :len(o)] = o
        node_l2g[s, n_own:n_own + len(h)] = h
        eo, eh = e_own_sets[s]
        elem_l2g[s, :len(eo)] = eo
        elem_l2g[s, e_own:e_own + len(eh)] = eh
        ein, ebn = loc_edges_in[s], loc_edges_bnd[s]
        edge_l2g[s, :len(ein)] = ein
        edge_l2g[s, ed_in:ed_in + len(ebn)] = ebn
        for g2l, l2g in ((node_g2l, node_l2g), (elem_g2l, elem_l2g),
                         (edge_g2l, edge_l2g)):
            v = l2g[s] >= 0
            g2l[s, l2g[s, v]] = np.nonzero(v)[0]

    node_slot = np.zeros(N, np.int64)
    elem_slot = np.zeros(E, np.int64)
    for s in range(S):
        node_slot[own_nodes[s]] = np.arange(len(own_nodes[s]))
        eo = e_own_sets[s][0]
        elem_slot[eo] = np.arange(len(eo))
    node_from = part * n_loc + node_slot
    elem_from = elem_owner * e_loc + elem_slot

    # ---- exchange schedules ----------------------------------------------
    node_send, node_src, node_perms, node_round_send, node_halo_src = \
        _exchange_schedule(S, part, node_l2g, node_g2l, n_own, n_loc)
    elem_send, elem_src, elem_perms, elem_round_send, elem_halo_src = \
        _exchange_schedule(S, elem_owner, elem_l2g, elem_g2l, e_own, e_loc)
    own_node_f = np.zeros((S, n_loc))
    for s in range(S):
        own_node_f[s, :len(own_nodes[s])] = 1.0
    # the reverse direction: src inverted for packing, send transposed for
    # the per-owned-slot receive gather
    Mn = node_send.shape[2]
    rev_pack = np.full((S, S * Mn), -1, np.int64)
    for d in range(S):
        for h in range(node_src.shape[1]):
            if node_src[d, h] >= 0:
                rev_pack[d, node_src[d, h]] = h
    ref_lists = [[[] for _ in range(n_own)] for _ in range(S)]
    for s in range(S):
        for d in range(S):
            for m in range(Mn):
                i = node_send[s, d, m]
                if i >= 0:
                    ref_lists[s][i].append(d * Mn + m)
    R = max(1, max(len(r) for rl in ref_lists for r in rl))
    rev_gather = np.full((S, n_own, R), -1, np.int64)
    for s in range(S):
        for i, r in enumerate(ref_lists[s]):
            rev_gather[s, i, :len(r)] = r
    sched = HaloSchedule(
        node_send=node_send, node_src=node_src, elem_send=elem_send,
        elem_src=elem_src, own_node_f=own_node_f, node_rev_pack=rev_pack,
        node_rev_gather=rev_gather, node_round_send=node_round_send,
        node_halo_src=node_halo_src, elem_round_send=elem_round_send,
        elem_halo_src=elem_halo_src, n_own_node=n_own, n_own_elem=e_own,
        node_perms=node_perms, elem_perms=elem_perms)

    # ---- local meshes ------------------------------------------------------
    dummy_node, dummy_elem, dummy_edge = n_loc - 1, e_loc - 1, ed_loc - 1

    def remap(table_g, rows_l2g, g2l_s, missing):
        """Rows by rows_l2g (pad rows all ``missing``), entries through
        g2l_s (absent entries ``missing``)."""
        t = table_g[np.where(rows_l2g >= 0, rows_l2g, 0)]
        keep = t >= 0
        mapped = np.where(keep, g2l_s[np.where(keep, t, 0)], -1)
        mapped = np.where(mapped >= 0, mapped, missing)
        mapped[rows_l2g < 0] = missing
        return mapped

    def slice_rows(arr_g, rows_l2g, fill, axis=-1):
        a = _np(arr_g)
        out = np.take(a, np.where(rows_l2g >= 0, rows_l2g, 0), axis=axis)
        sl = [slice(None)] * a.ndim
        sl[axis] = rows_l2g < 0
        out[tuple(sl)] = fill
        return out

    locals_ = []
    for s in range(S):
        nl2g, el2g, dl2g = node_l2g[s], elem_l2g[s], edge_l2g[s]
        ng2l, eg2l, dg2l = node_g2l[s], elem_g2l[s], edge_g2l[s]
        r = {}
        r["elem_nodes"] = remap(en, el2g, ng2l, dummy_node)
        r["edges"] = remap(edges, dl2g, ng2l, dummy_node)
        # a missing left triangle -> the dummy (masked) element, a missing
        # right one -> -1 (the boundary convention), as parallel/padding.py
        et_l = remap(etri, dl2g, eg2l, -1)
        et_l[:, 0] = np.where(et_l[:, 0] >= 0, et_l[:, 0], dummy_elem)
        r["edge_tri"] = et_l
        r["elem_neighbors"] = remap(enb, el2g, eg2l, -1)
        r["elem_edges"] = remap(eedges, el2g, dg2l, dummy_edge)
        r["nod_in_elem"] = remap(nie_g, nl2g, eg2l, -1)
        r["nod_in_elem_slot"] = np.where(
            r["nod_in_elem"] >= 0, slice_rows(nies_g, nl2g, 0, axis=0), 0)
        r["nod_in_elem_num"] = (r["nod_in_elem"] >= 0).sum(-1)
        ne_l = remap(nedg_g, nl2g, dg2l, -1)
        r["node_edges"] = ne_l
        r["node_edge_sign"] = np.where(
            ne_l >= 0, slice_rows(nsgn_g, nl2g, 0.0, axis=0), 0.0)
        r["node_neighbors"] = remap(nnb_g, nl2g, ng2l, -1)
        for name, fill, axis in _NODE_FIELDS:
            r[name] = slice_rows(getattr(mesh, name), nl2g, fill, axis=axis)
        nlm = slice_rows(mesh.node_level_mask, nl2g, False, axis=-1)
        nlm[0, nl2g < 0] = True      # one surface level so a gather is legal
        r["node_level_mask"] = nlm
        for name, fill, axis in _ELEM_FIELDS:
            r[name] = slice_rows(getattr(mesh, name), el2g, fill, axis=axis)
        for name in ("edge_dxdy", "edge_cross_dxdy"):
            r[name] = slice_rows(getattr(mesh, name), dl2g, 0.0, axis=0)
        r["zbar"] = _np(mesh.zbar)
        r["Z"] = _np(mesh.Z)
        locals_.append(r)
    mesh_local = {}
    for k in locals_[0]:
        ref = getattr(mesh, k)
        dt = np.bool_ if ref.dtype == torch.bool else \
            np.dtype(str(ref.dtype).replace("torch.", ""))
        mesh_local[k] = np.stack([loc[k] for loc in locals_]).astype(dt)
    mesh_meta = dict(n_nodes=n_loc, n_elems=e_loc, n_edges=ed_loc,
                     n_edges_in=ed_in, nl=mesh.nl,
                     cyclic_length=mesh.cyclic_length,
                     cartesian=mesh.cartesian, ocean_area=mesh.ocean_area)

    # ---- tracer statics ----------------------------------------------------
    st_local = None
    if st is not None:
        st_local = dict(
            edge_up_dn_tri=np.stack([remap(updn, edge_l2g[s], elem_g2l[s], -1)
                                     for s in range(S)]).astype(np.int32),
            nboundary_lay=np.stack([slice_rows(st.nboundary_lay, node_l2g[s],
                                               0) for s in range(S)]
                                   ).astype(np.int32),
            Ki=np.stack([slice_rows(st.Ki, node_l2g[s], 0.0)
                         for s in range(S)]),
            nln_min=(np.stack([slice_rows(st.nln_min, node_l2g[s], 1)
                               for s in range(S)]).astype(np.int32)
                     if st.nln_min is not None else None))

    # ---- SSH preconditioners on the local numbering ------------------------
    diag_local = block_pc_local = None
    if cfg is not None:
        from ..core.ssh import build_block_schwarz_local, ssh_matrix_diagonal
        diag = _np(ssh_matrix_diagonal(mesh, cfg))
        dinv = np.where(diag > 0, 1.0 / np.where(diag > 0, diag, 1.0), 0.0)
        diag_local = np.stack([slice_rows(dinv, node_l2g[s], 0.0)
                               for s in range(S)])
        block_pc_local = build_block_schwarz_local(
            mesh, cfg, S, node_l2g, node_g2l, n_own, n_loc)

    # ---- per-shard ice subdomain (EVP polar-cap restriction) ---------------
    ice_sub_local = None
    sub_lat = getattr(cfg.ice, "evp_subdomain_lat", None) \
        if cfg is not None else None
    if sub_lat is not None:
        ice_sub_local, sub_sched, n_own_sub = _build_ice_sub_local(
            mesh, sub_lat, S, part, node_l2g, elem_l2g, n_own, n_loc, e_loc,
            ed_loc, locals_)
        sub_send, sub_src, sub_perms, sub_round_send, sub_halo_src = \
            sub_sched
        sched = dataclasses.replace(
            sched, sub_send=sub_send, sub_src=sub_src, n_own_sub=n_own_sub,
            sub_perms=sub_perms, sub_round_send=sub_round_send,
            sub_halo_src=sub_halo_src)

    return DistLayout(
        S=S, part=part, n_own=n_own, n_loc=n_loc, e_own=e_own, e_loc=e_loc,
        ed_loc=ed_loc, sizes=(N, E, Ed), node_l2g=node_l2g,
        elem_l2g=elem_l2g, edge_l2g=edge_l2g, node_from=node_from,
        elem_from=elem_from, sched=sched, mesh_local=mesh_local,
        mesh_meta=mesh_meta, st_local=st_local, diag_inv_local=diag_local,
        block_pc_local=block_pc_local, ice_sub_local=ice_sub_local)


def dist_layout_for_model(model, S: int, part=None, n_part=None
                          ) -> DistLayout:
    """The layout of ``model``'s mesh, tracer statics and configuration
    over S shards; ``n_part=(hosts, cards)``: the two-level partition."""
    return build_layout(model.mesh, S, st=model.tracer_statics, part=part,
                        cfg=model.cfg, n_part=n_part)


# --------------------------------------------------------------------------
# trees: global <-> stacked per shard
# --------------------------------------------------------------------------
def tree_map(fn, tree):
    """``fn`` on every tensor or array leaf of dataclasses, dicts, lists
    and tuples; other leaves as they are."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def tree_leaves(tree, prefix=""):
    """[(path, leaf)] of the tensor and array leaves of ``tree``."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [(prefix, tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in tree_leaves(getattr(tree, f.name),
                                     f"{prefix}.{f.name}")]
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in tree_leaves(v, f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_leaves(v, f"{prefix}[{i}]")]
    return []


def localize_tree(tree, layout: DistLayout):
    """Global tree -> stacked per-shard tree [S, ...] (CPU tensors): a leaf
    whose last axis has a global entity size is taken through the
    local->global map (halo slots get the owners' values, pad slots 0);
    any other leaf is repeated on every shard."""
    N, E, Ed = layout.sizes
    maps = {N: layout.node_l2g, E: layout.elem_l2g, Ed: layout.edge_l2g}
    S = layout.S

    def fix(x):
        x = torch.as_tensor(x).detach().cpu()
        if x.ndim >= 1 and x.shape[-1] in maps:
            m = torch.as_tensor(maps[x.shape[-1]])
            out = x[..., m.clamp_min(0)]                   # [..., S, L]
            out = torch.movedim(out, -2, 0)                # [S, ..., L]
            valid = (m >= 0).reshape((S,) + (1,) * (out.ndim - 2)
                                     + (m.shape[1],))
            return torch.where(valid, out, torch.zeros((), dtype=out.dtype))
        return x[None].expand((S,) + tuple(x.shape)).clone()

    return tree_map(fix, tree)


def shard_of(tree_d, r: int, device=None):
    """Row ``r`` of a stacked tree, on ``device``."""
    return tree_map(lambda x: torch.as_tensor(x)[r].to(device)
                    if device is not None else torch.as_tensor(x)[r],
                    tree_d)


def stack_shards(trees):
    """The per-shard trees (list over the shards) stacked [S, ...]."""
    leaves = [tree_leaves(t) for t in trees]
    it = iter(range(len(leaves[0])))

    def fix(_):
        i = next(it)
        return torch.stack([torch.as_tensor(lv[i][1]).cpu()
                            for lv in leaves])
    return tree_map(fix, trees[0])


def gather_tree(tree_d, layout: DistLayout):
    """Stacked per-shard tree [S, ...] -> global tree (the owners' values);
    a leaf without an entity axis takes shard 0's."""
    frm = {layout.n_loc: layout.node_from, layout.e_loc: layout.elem_from}

    def fix(x):
        x = torch.as_tensor(x)
        if x.ndim >= 2 and x.shape[-1] in frm and x.shape[0] == layout.S:
            g_idx = torch.as_tensor(frm[x.shape[-1]])
            if x.numel() == 0:
                return torch.zeros(tuple(x.shape[1:-1]) + (len(g_idx),),
                                   dtype=x.dtype)
            flat = torch.movedim(x, 0, -2)
            flat = flat.reshape(flat.shape[:-2] + (-1,))
            return flat[..., g_idx]
        if x.ndim >= 2 and x.shape[-1] == layout.ed_loc \
                and x.shape[0] == layout.S:
            raise ValueError("edge fields carry no ownership; cannot gather")
        return x[0]

    return tree_map(fix, tree_d)


def check_halo_consistency(tree_d, layout: DistLayout, atol: float = 0.0):
    """For every node- and element-shaped leaf of a stacked tree, the
    largest difference between a real halo slot and its owner's value
    (the reference's halo check, ``gen_halo_exchange.F90:146``): a list of
    (leaf path, kind, max |diff|) of the leaves beyond ``atol`` (empty:
    consistent).  Host numpy."""
    out = []
    specs = [("node", layout.node_l2g, layout.n_own, layout.n_loc,
              layout.node_from),
             ("elem", layout.elem_l2g, layout.e_own, layout.e_loc,
              layout.elem_from)]
    for path, leaf in tree_leaves(tree_d):
        size = leaf.size if isinstance(leaf, np.ndarray) else leaf.numel()
        if leaf.ndim < 2 or leaf.shape[0] != layout.S or size == 0:
            continue
        for kind, l2g, n_own_blk, n_loc_blk, frm in specs:
            if leaf.shape[-1] != n_loc_blk:
                continue
            a = _np(leaf)
            flat = np.moveaxis(a, 0, -2)
            flat = flat.reshape(flat.shape[:-2] + (-1,))
            worst = 0.0
            for s in range(layout.S):
                hg = l2g[s, n_own_blk:]
                ok = hg >= 0
                if not ok.any():
                    continue
                got = a[s][..., n_own_blk:][..., ok]
                want = flat[..., frm[hg[ok]]]
                d = np.abs(got.astype(np.float64) - want.astype(np.float64))
                worst = max(worst, float(np.nan_to_num(d, nan=np.inf).max()))
            if worst > atol:
                out.append((path, kind, worst))
    return out


# --------------------------------------------------------------------------
# one rank: its tables and model
# --------------------------------------------------------------------------
def rank_bundle(layout: DistLayout, r: int) -> dict:
    """Row ``r`` of the layout's stacked tables and schedule (numpy), all
    that rank ``r`` needs to build its context and model."""
    row = lambda d: None if d is None else {
        k: (v[r] if isinstance(v, np.ndarray) else v) for k, v in d.items()}
    s = layout.sched
    sched = dict(
        own_node_f=s.own_node_f[r], node_rev_pack=s.node_rev_pack[r],
        node_rev_gather=s.node_rev_gather[r], n_own_node=s.n_own_node,
        n_own_elem=s.n_own_elem, n_own_sub=s.n_own_sub, S=layout.S,
        n_loc=layout.n_loc, e_loc=layout.e_loc,
        n_sub=(layout.ice_sub_local["n_nodes"]
               if layout.ice_sub_local is not None else -1))
    for kind in ("node", "elem", "sub"):
        perms = getattr(s, f"{kind}_perms")
        sends = getattr(s, f"{kind}_round_send")
        halo_src = getattr(s, f"{kind}_halo_src")
        rounds = []
        for perm, tbl in zip(perms, sends):
            dst = [d for src, d in perm if src == r]
            src = [a for a, d in perm if d == r]
            rounds.append(dict(dst=dst[0] if dst else None,
                               src=src[0] if src else None,
                               send=tbl[r], width=int(tbl.shape[1])))
        sched[f"{kind}_rounds"] = rounds
        sched[f"{kind}_halo_src"] = None if halo_src is None \
            else halo_src[r]
    return dict(rank=r, sched=sched, mesh=row(layout.mesh_local),
                mesh_meta=dict(layout.mesh_meta), st=row(layout.st_local),
                diag_inv=(None if layout.diag_inv_local is None
                          else layout.diag_inv_local[r]),
                block_pc=row(layout.block_pc_local),
                ice_sub=row(layout.ice_sub_local))


def local_mesh(bundle: dict, device, dtype) -> MeshTables:
    """The rank's MeshTables on ``device`` in ``dtype``, with the kernels'
    tables built from the local mesh itself (``mesh/cluster.py``)."""
    kw = {}
    for k, v in bundle["mesh"].items():
        t = torch.as_tensor(v, device=device)
        kw[k] = t.to(dtype) if t.is_floating_point() else t
    mesh = MeshTables(**kw, **bundle["mesh_meta"])
    return dataclasses.replace(mesh, cluster=build_cluster_tables(mesh))


def rank_block_pc(pc: dict, device, dtype):
    """A rank's row of ``build_block_schwarz_local``'s tables as a
    BlockSchwarz whose coarse level adds nothing, with the kernel's packed
    layout of its inverses."""
    from ..core.ssh import BlockSchwarz, pack_block_schwarz
    t = lambda a: torch.as_tensor(a, device=device)
    nb = pc["block_ids"].shape[0]
    n_loc = pc["node_slots"].shape[0]
    out = BlockSchwarz(
        t(pc["block_ids"].astype(np.int32)), t(pc["inv_blocks"]).to(dtype),
        t(pc["node_slots"].astype(np.int32)), t(pc["node_slot_valid"]),
        coarse_ids=t(np.full((nb, 1), -1, np.int32)),
        coarse_inv=t(np.zeros((nb, nb))).to(dtype),
        coarse_part=t(np.full(n_loc, -1, np.int32)))
    out.packed = pack_block_schwarz(out)
    return out


def rank_model(bundle: dict, cfg, density_ref, device, dtype):
    """The rank's Model on its local tables: the local mesh, tracer
    statics, ice subdomain, and the SSH solve of the distributed
    formulation, matrix-free CG with the local block-Schwarz (its coarse
    level off) or, without one, the Jacobi diagonal."""
    from ..core.tracer_setup import TracerStatics
    from ..ice.subdomain import IceSubdomain
    from ..model import Model
    mesh = local_mesh(bundle, device, dtype)
    dev = mesh.zbar.device
    t = lambda a: torch.as_tensor(a, device=dev)
    f = lambda a: t(a).to(dtype)
    st = bundle["st"]
    tst = TracerStatics(
        edge_up_dn_tri=t(st["edge_up_dn_tri"]),
        nboundary_lay=t(st["nboundary_lay"]), Ki=f(st["Ki"]),
        nln_min=None if st["nln_min"] is None else t(st["nln_min"]))
    kw = {}
    if bundle["block_pc"] is not None:
        kw["ssh_block_pc"] = rank_block_pc(bundle["block_pc"], dev, dtype)
    else:
        kw["ssh_diag_inv"] = f(bundle["diag_inv"])
    sub = bundle["ice_sub"]
    if sub is not None and cfg.run.use_ice:
        i32 = lambda a: t(np.asarray(a).astype(np.int32))
        kw["ice_sub"] = IceSubdomain(
            sub_nodes=i32(sub["sub_nodes"]), sub_elems=i32(sub["sub_elems"]),
            node_mask=t(sub["node_mask"]), elem_nodes=i32(sub["elem_nodes"]),
            nod_in_elem=i32(sub["nod_in_elem"]),
            nod_in_elem_slot=i32(sub["nod_in_elem_slot"]),
            elem_slot=t(elem_slot_table(sub["nod_in_elem"],
                                        sub["nod_in_elem_slot"],
                                        sub["n_elems"])),
            gradient_sca=f(sub["gradient_sca"]),
            metric_factor=f(sub["metric_factor"]),
            elem_area=f(sub["elem_area"]), area=f(sub["area"]),
            coriolis_node=f(sub["coriolis_node"]),
            bc_index_node=f(sub["bc_index_node"]),
            n_elems=int(sub["n_elems"]), n_nodes=int(sub["n_nodes"]))
    return Model(mesh, cfg, tst, f(density_ref), **kw)


def prepare_dist_model(model):
    """Give a one-device Model the distributed formulation's equations, so
    that its steps can be held against a run over ranks
    (``fesom2_tpu/parallel/dist.py:962-971``): the SSH solve becomes
    matrix-free CG with the Jacobi diagonal (no dense inverse, no ring
    operator, no block preconditioner) and the EVP runs on the whole mesh.
    Build the step after this."""
    from ..core.ssh import ssh_matrix_diagonal
    diag = ssh_matrix_diagonal(model.mesh, model.cfg)
    dinv = torch.where(diag > 0, 1.0 / torch.where(diag > 0, diag, 1.0), 0.0)
    model.set_ssh_solver(diag_inv=dinv)
    model.set_ice_sub(None)
    return model


# --------------------------------------------------------------------------
# the runtime context of one rank
# --------------------------------------------------------------------------
@dataclass
class ExchangeTimers:
    """What one rank's exchanges cost: calls and bytes sent, by kind, and
    the host seconds spent in them (packing, transfer, waiting, the halo
    gather; under gloo on a card the staging copies too)."""
    calls: dict = field(default_factory=dict)
    bytes: dict = field(default_factory=dict)
    seconds: dict = field(default_factory=dict)

    def add(self, kind, nbytes, seconds):
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + nbytes
        self.seconds[kind] = self.seconds.get(kind, 0.0) + seconds

    def reset(self):
        self.calls.clear()
        self.bytes.clear()
        self.seconds.clear()


class DistContext:
    """One rank's halo exchanges and owned-masked sums over the default
    process group (``fesom2_tpu/parallel/dist.py:114-229``), from its
    ``rank_bundle``.  Under gloo with tensors on a card (``stage``) the
    packed buffers go through pinned host memory."""

    def __init__(self, bundle: dict, device):
        sc = bundle["sched"]
        self.rank = bundle["rank"]
        self.S = sc["S"]
        self.device = torch.device(device)
        self.stage = tdist.get_backend() == "gloo" \
            and self.device.type == "cuda"
        t = lambda a: torch.as_tensor(np.asarray(a), device=self.device)
        self.own_node = t(sc["own_node_f"]) > 0
        self.n_loc, self.e_loc, self.n_sub = sc["n_loc"], sc["e_loc"], \
            sc["n_sub"]
        self.n_own = {"node": sc["n_own_node"], "elem": sc["n_own_elem"],
                      "sub": sc["n_own_sub"]}
        self.size = {"node": self.n_loc, "elem": self.e_loc,
                     "sub": self.n_sub}
        self.rounds, self.halo_src = {}, {}
        for kind in ("node", "elem", "sub"):
            rs = []
            for rd in sc[f"{kind}_rounds"]:
                send = t(rd["send"])
                rs.append((rd["dst"], send.clamp_min(0), send >= 0,
                           rd["src"], rd["width"]))
            self.rounds[kind] = rs
            hs = sc[f"{kind}_halo_src"]
            self.halo_src[kind] = None if hs is None else \
                (t(hs).clamp_min(0), t(hs) >= 0)
        rp = t(sc["node_rev_pack"])
        self.rev_pack = (rp.clamp_min(0), rp >= 0)
        rg = t(sc["node_rev_gather"])
        self.rev_gather = (rg.clamp_min(0), rg >= 0)
        self.timers = ExchangeTimers()

    # -- transport ----------------------------------------------------------
    def _host(self, x: torch.Tensor) -> torch.Tensor:
        if not self.stage:
            return x
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x)
        return h

    def _device(self, h: torch.Tensor) -> torch.Tensor:
        return h.to(self.device, non_blocking=False) if self.stage else h

    def _recv_buffer(self, shape, dtype):
        if self.stage:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    # -- forward exchange ---------------------------------------------------
    def _exchange(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        with record_function(f"dist.exchange.{kind}"):
            return self._exchange_body(x, kind)

    def _exchange_body(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        t0 = time.perf_counter()
        if x.shape[-1] != self.size[kind]:
            raise ValueError(f"exchange of {kind} fields: last axis "
                             f"{x.shape[-1]}, the layout's is "
                             f"{self.size[kind]}")
        n_own = self.n_own[kind]
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        lead = tuple(x.shape[:-1])
        recvs, nbytes = [], 0
        for dst, sidx, svalid, src, width in self.rounds[kind]:
            ops, rbuf = [], None
            if dst is not None:
                buf = self._host(torch.where(svalid, x[..., sidx], zero)
                                 .contiguous())
                nbytes += buf.numel() * buf.element_size()
                ops.append(tdist.P2POp(tdist.isend, buf, dst))
            if src is not None:
                rbuf = self._recv_buffer(lead + (width,), x.dtype)
                ops.append(tdist.P2POp(tdist.irecv, rbuf, src))
            if ops:
                for req in tdist.batch_isend_irecv(ops):
                    req.wait()
            recvs.append(torch.zeros(lead + (width,), dtype=x.dtype,
                                     device=x.device)
                         if rbuf is None else self._device(rbuf))
        H = self.size[kind] - n_own
        if recvs:
            cat = torch.cat(recvs, -1)
            hsrc, hvalid = self.halo_src[kind]
            halo = torch.where(hvalid, cat[..., hsrc], zero)
        else:
            halo = torch.zeros(lead + (H,), dtype=x.dtype, device=x.device)
        out = torch.cat([x[..., :n_own], halo], -1)
        self.timers.add(kind, nbytes, time.perf_counter() - t0)
        return out

    def exchange_nodes(self, x: torch.Tensor, sub: bool = False):
        """x [..., n_loc] with its halo slots replaced by the owners'
        values (pad slots 0); ``sub``: x is numbered on the ice subdomain
        [..., Ns] and takes its schedule."""
        return self._exchange(x, "sub" if sub else "node")

    def exchange_elems(self, x: torch.Tensor):
        return self._exchange(x, "elem")

    # -- reverse exchange and sums ------------------------------------------
    def accumulate_nodes(self, x: torch.Tensor) -> torch.Tensor:
        """Add the halo-slot contributions of x [..., n_loc] into their
        owners' slots (one ``all_to_all_single`` of the packed reverse
        buffer), then refresh the halos."""
        with record_function("dist.accumulate"):
            return self._accumulate(x)

    def _accumulate(self, x: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        n_own = self.n_own["node"]
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        halo = x[..., n_own:]
        pidx, pvalid = self.rev_pack
        buf = torch.where(pvalid, halo[..., pidx], zero)       # [..., S*M]
        buf = buf.reshape(buf.shape[:-1] + (self.S, -1))
        buf = torch.movedim(buf, -2, 0).contiguous()           # [S, ..., M]
        send = self._host(buf)
        recv = self._recv_buffer(tuple(buf.shape), x.dtype)
        tdist.all_to_all_single(recv, send)
        rf = torch.movedim(self._device(recv), 0, -2)
        rf = rf.reshape(rf.shape[:-2] + (-1,))                 # [..., S*M]
        gidx, gvalid = self.rev_gather
        add = torch.where(gvalid, rf[..., gidx], zero).sum(-1)
        full = torch.cat([x[..., :n_own] + add, halo], -1)
        self.timers.add("accumulate", send.numel() * send.element_size(),
                        time.perf_counter() - t0)
        return self.exchange_nodes(full)

    def gsum_nodes(self, v: torch.Tensor) -> torch.Tensor:
        """The owned-masked global sum of a [..., n_loc] node field:
        ``torch.where``, not a product, since pad and halo slots may hold
        NaN scratch."""
        with record_function("dist.gsum"):
            t0 = time.perf_counter()
            zero = torch.zeros((), dtype=v.dtype, device=v.device)
            s = torch.where(self.own_node, v, zero).sum()
            h = self._host(s)
            tdist.all_reduce(h)
            self.timers.add("gsum", h.element_size(),
                            time.perf_counter() - t0)
            return self._device(h)

    def owned(self):
        """(nodes [n_loc], elements [e_loc]) bool: this rank's own real
        entities, the slots its blowup scan reads."""
        elem = torch.zeros(self.e_loc, dtype=torch.bool, device=self.device)
        elem[:self.n_own["elem"]] = True
        return self.own_node, elem

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        """The largest value of a 0-d tensor over the ranks."""
        h = self._host(x.clone())
        tdist.all_reduce(h, op=tdist.ReduceOp.MAX)
        return self._device(h)


# --------------------------------------------------------------------------
# the distributed step of one rank
# --------------------------------------------------------------------------
def dist_pi_coupled_step_fn(model, atm, ctx: DistContext):
    """The coupled ocean + ice step of a rank's Model (``rank_model``) on
    its local atmosphere, under ``ctx``: step(state, ice, step_idx) ->
    (state, ice, ocean_forcing), every hook of ``core/ops.py`` exchanging
    over the group (``fesom2_tpu/parallel/dist.py:1005-1048``)."""
    from ..core import ops
    from ..model import pi_coupled_step_fn
    step = pi_coupled_step_fn(model, atm)

    def dstep(state, ice, step_idx):
        with ops.dist_context(ctx):
            return step(state, ice, step_idx)

    return dstep


def dist_step_fn(model, ctx: DistContext):
    """The ocean step alone of a rank's Model under ``ctx``:
    step(state, forcing, sw_3d=None) -> state."""
    from ..core import ops

    @torch.no_grad()
    def dstep(state, forcing, sw_3d=None):
        with ops.dist_context(ctx):
            return model(state, forcing, sw_3d)

    return dstep


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
# the longest a run of ranks may take, their start and results included
RANKS_TIMEOUT_S = 1800.0


def _rank_device(backend: str, device: str, rank: int) -> torch.device:
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    # nccl: a card a rank; gloo: the ranks share card 0
    return torch.device("cuda", rank if backend == "nccl" else 0)


def _rank_entry(rank, S, store, backend, device, target, files, queue):
    """The body of a rank process: read its payload from ``files[0]``,
    join the group, run ``target(rank, payload, device)``, write the
    result to ``files[1]`` and hand its path (or the error) to the parent.
    A dict result gets the wall-clock times (``time.time()``) at which
    the rank entered, joined the group and finished its target."""
    try:
        t_entry = time.time()
        payload = torch.load(files[0], weights_only=False, mmap=True)
        torch.set_num_threads(1)        # S ranks share the host's cores
        # every rank is on this host: gloo binds the loopback device and
        # resolves no host name
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        bad = [m for m in ("jax", "fesom2_tpu") if m in sys.modules]
        if bad:
            raise RuntimeError(f"a rank imported {bad}")
        dev = _rank_device(backend, device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        kw = dict(device_id=dev) if backend == "nccl" else {}
        tdist.init_process_group(backend, init_method=f"file://{store}",
                                 rank=rank, world_size=S, **kw)
        try:
            t_joined = time.time()
            out = target(rank, payload, dev)
            if isinstance(out, dict):
                out["clock"] = dict(entry=t_entry, joined=t_joined,
                                    done=time.time())
            torch.save(out, files[1])
            queue.put((rank, "ok", files[1]))
        finally:
            tdist.destroy_process_group()
    except BaseException:
        queue.put((rank, "error", traceback.format_exc()))


def run_ranks(S: int, target, payloads, *, backend: str, device: str):
    """Run ``target(rank, payloads[rank], device) -> result`` in S
    processes (started with spawn, so that a rank imports neither a test
    module nor jax; the group meets in a FileStore in a temporary
    directory, where each rank's payload and result are passed as files)
    and return the results in rank order.  ``backend`` is the
    caller's choice: "gloo" (CPU tensors, or all ranks on card 0 through
    host memory) or "nccl" (a card a rank).  A rank's error stops every
    rank and raises here."""
    import multiprocessing as mp
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: gloo or nccl")
    if backend == "nccl" and (device != "cuda"
                              or torch.cuda.device_count() < S):
        raise ValueError("nccl needs a card a rank")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    t_start = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        files = [(os.path.join(tmp, f"payload{r}.pt"),
                  os.path.join(tmp, f"result{r}.pt")) for r in range(S)]
        for r in range(S):
            torch.save(payloads[r], files[r][0])
        procs = [ctx.Process(target=_rank_entry,
                             args=(r, S, store, backend, device, target,
                                   files[r], queue))
                 for r in range(S)]
        for p in procs:
            p.start()
        results, errors = {}, []
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        try:
            while len(results) + len(errors) < S:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"ranks did not finish in "
                                       f"{RANKS_TIMEOUT_S} s")
                try:
                    rank, status, body = queue.get(timeout=min(left, 5.0))
                except Exception:
                    if any(p.exitcode not in (None, 0) for p in procs):
                        dead = [r for r, p in enumerate(procs)
                                if p.exitcode not in (None, 0)]
                        raise RuntimeError(f"rank(s) {dead} died")
                    continue
                if status == "ok":
                    results[rank] = torch.load(body, weights_only=False)
                    if isinstance(results[rank], dict) \
                            and "clock" in results[rank]:
                        results[rank]["clock"].update(start=t_start,
                                                      received=time.time())
                else:
                    errors.append((rank, body))
                    # the other ranks' errors, which often name the cause
                    # of a broken connection, a few seconds more
                    t_err = time.monotonic() + 10.0
                    while len(results) + len(errors) < S \
                            and time.monotonic() < t_err:
                        try:
                            rank, status, body = queue.get(timeout=1.0)
                        except Exception:
                            continue
                        if status != "ok":
                            errors.append((rank, body))
                    break
        finally:
            if errors or len(results) < S:
                for p in procs:
                    if p.is_alive():
                        p.terminate()
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
        if errors:
            raise RuntimeError("\n".join(f"rank {rank} failed:\n{tb}"
                                         for rank, tb in sorted(errors)))
    return [results[r] for r in range(S)]


# --------------------------------------------------------------------------
# the coupled steps over ranks, held against one device
# --------------------------------------------------------------------------
def _case_payloads(case: dict, layout: DistLayout) -> list:
    """Per rank, its share of one case of ``run_coupled_steps``: the
    configuration, dtype and step count, and its rows of the model's
    fields, the atmosphere, the initial state and the checks' inputs."""
    model = case["model"]
    extra = dict(density_ref=model.density_ref, Ssurf=model.Ssurf,
                 Tclim=model.Tclim, Sclim=model.Sclim,
                 relax2clim=model.relax2clim)
    extra = {k: v for k, v in extra.items() if v is not None}
    loc = localize_tree(dict(extra=extra, atm=case["atm"],
                             state=case["state"], ice=case["ice"]), layout)
    checks = case.get("checks")
    return [dict(cfg=model.cfg, dtype=model.dtype, data=shard_of(loc, r),
                 n_steps=case["n_steps"],
                 checks=None if checks is None else shard_of(checks, r),
                 profile=case.get("profile", False))
            for r in range(layout.S)]


def _halo_checks(ctx: DistContext, model, c: dict, state) -> dict:
    """The runtime's pieces on a rank's shares of global fields: the
    exchange of a node field ``xn`` (its halo holds the owners' values
    already, so the exchange is the identity), the reverse accumulation
    of a local field ``x_loc``, two assemblies (``edge_divergence`` of an
    edge field ``flux``, ``elem_contrib_to_nodes`` of ``contrib`` [3, E])
    and one ocean step from ``state`` without forcing
    (``dist_step_fn``)."""
    from ..core import ops
    from ..core.state import zero_forcing
    ocean = dist_step_fn(model, ctx)(state,
                                     zero_forcing(model.mesh, model.dtype))
    with ops.dist_context(ctx):
        return dict(exchanged=ops.halo_fix_nodes(c["xn"]),
                    accumulated=ops.halo_accumulate_nodes(c["x_loc"]),
                    div=ops.edge_divergence(c["flux"], model.mesh),
                    ctn=ops.elem_contrib_to_nodes(c["contrib"].T.contiguous(),
                                                  model.mesh),
                    ocean=ocean)


def _profile_step(step, state, ice, k, device) -> dict:
    """One more step (index ``k``) under the profiler: its wall ms, the
    device ms of its kernels and copies, and of those under the
    ``dist.*`` spans (a kernel or copy belongs to the span whose range on
    the card's timeline holds its start)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    tdist.barrier()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, ice, k)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    spans, work = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA \
                or e.name.startswith(("step.", "ProfilerStep")):
            continue           # the step's own spans' copies on the card
        (spans if e.name.startswith("dist.") else work).append(
            (e.time_range.start, e.time_range.end))
    spans.sort()
    total = inside = 0.0
    for start, end in work:
        total += end - start
        if any(s <= start < e for s, e in spans):
            inside += end - start
    return dict(wall_ms=wall * 1e3, device_ms=total / 1e3,
                exchange_device_ms=inside / 1e3)


def coupled_steps_target(rank, payload, device):
    """A rank's part of ``run_coupled_steps``: its context from the
    bundle, then each case in turn (``_run_case``); returns
    dict(cases=[record of each case])."""
    ctx = DistContext(payload["bundle"], device)
    out = []
    for case in payload["cases"]:
        out.append(_run_case(ctx, payload["bundle"], case, device))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return dict(cases=out)


def _run_case(ctx: DistContext, bundle: dict, case: dict, device) -> dict:
    """Build the rank's Model for the case, take ``case["n_steps"]``
    coupled steps from step index 0 and return its local state and ice
    (CPU tensors) with a record: the results of ``_halo_checks`` (where the
    case has ``checks``), the CG iterations, kernel launches, blowup flag
    (read on the owned slots, the max over the ranks), exchange counts,
    bytes and host seconds and wall seconds of each step, the seconds the
    Model's setup took, the peak memory on a card and, with ``profile``
    on a card, one more step profiled (``_profile_step``)."""
    from .. import kernels
    from ..core.diag import check_blowup
    t_begin = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    data = tree_map(lambda x: x.to(device), case["data"])
    model = rank_model(bundle, case["cfg"], data["extra"]["density_ref"],
                       device, case["dtype"])
    for k in ("Ssurf", "Tclim", "Sclim", "relax2clim"):
        if k in data["extra"]:
            setattr(model, k, data["extra"][k])
    t_setup = time.perf_counter() - t_begin
    checks = None
    if case["checks"] is not None:
        checks = _halo_checks(ctx, model,
                              tree_map(lambda x: x.to(device),
                                       case["checks"]), data["state"])
    step = dist_pi_coupled_step_fn(model, data["atm"], ctx)
    state, ice = data["state"], data["ice"]
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    iters, launches, flags, step_s, exch = [], [], [], [], []
    for k in range(case["n_steps"]):
        kernels.reset_launches()
        ctx.timers.reset()
        sync()
        tdist.barrier()
        t0 = time.perf_counter()
        state, ice, _ = step(state, ice, k)
        sync()
        step_s.append(time.perf_counter() - t0)
        launches.append(dict(kernels.LAUNCHES))
        exch.append(dict(calls=dict(ctx.timers.calls),
                         bytes=dict(ctx.timers.bytes),
                         seconds=dict(ctx.timers.seconds)))
        iters.append(int(model.ssh_iters))
        flag = check_blowup(state, model.mesh, ice, model.ice_sub,
                            owned=ctx.owned())
        flags.append(int(ctx.all_max(flag.to(torch.float64))))
    prof = None
    if case["profile"] and device.type == "cuda":
        prof = _profile_step(step, state, ice, case["n_steps"], device)
    peak = torch.cuda.max_memory_allocated(device) / 2**30 \
        if device.type == "cuda" else None
    cpu = lambda x: x.detach().cpu()
    return dict(state=tree_map(cpu, state), ice=tree_map(cpu, ice),
                profile=prof, setup_seconds=t_setup, peak_gib=peak,
                checks=None if checks is None else tree_map(cpu, checks),
                iters=iters, launches=launches, flags=flags,
                step_seconds=step_s, exchanges=exch, stage=ctx.stage,
                backend=tdist.get_backend())


def run_coupled_steps(cases, layout: DistLayout, *, backend: str,
                      device: str) -> list:
    """Each case over ``layout.S`` ranks, in turn, in one start of the
    ranks (``run_ranks``).  A case is a dict: ``model``, ``atm``,
    ``state``, ``ice``, ``n_steps``; optionally ``checks`` (a stacked tree
    of ``_halo_checks``' inputs) and ``profile``.  Returns a dict a case:
    the gathered global state and ice, the stacked local ones
    (``state_d``, ``ice_d``, for ``check_halo_consistency``), the stacked
    outputs of the checks, each rank's record (``_run_case``) with the
    wall-clock times of its start (``clock``), and the seconds spent
    making the payloads and running the ranks (their start included)."""
    t0 = time.perf_counter()
    shares = [_case_payloads(case, layout) for case in cases]
    payloads = [dict(bundle=rank_bundle(layout, r),
                     cases=[sh[r] for sh in shares])
                for r in range(layout.S)]
    t_payload = time.perf_counter() - t0
    out = run_ranks(layout.S, coupled_steps_target, payloads,
                    backend=backend, device=device)
    t_ranks = time.perf_counter() - t0 - t_payload
    results = []
    for i, case in enumerate(cases):
        ranks = [dict(o["cases"][i], clock=o["clock"]) for o in out]
        state_d = stack_shards([o["state"] for o in ranks])
        ice_d = stack_shards([o["ice"] for o in ranks])
        results.append(dict(
            payload_seconds=t_payload, ranks_seconds=t_ranks,
            state=gather_tree(state_d, layout),
            ice=gather_tree(ice_d, layout), state_d=state_d, ice_d=ice_d,
            ranks=ranks,
            checks=None if case.get("checks") is None
            else stack_shards([o["checks"] for o in ranks])))
    return results


# the tolerances of ``tests/test_dist.py:152-186``, relative to the
# largest reference magnitude
OCEAN_TOL = (("eta", 1e-7), ("tr", 1e-7), ("u", 1e-6), ("w", 1e-7),
             ("hnode", 1e-9))
ICE_TOL = (("a_ice", 1e-7), ("m_ice", 1e-7), ("u_ice", 1e-7),
           ("v_ice", 1e-7))


def relative_errors(ref_state, ref_ice, state, ice) -> dict:
    """max |a - b| / max |a| per field of OCEAN_TOL and ICE_TOL."""
    out = {}
    for obj_r, obj, names in ((ref_state, state, OCEAN_TOL),
                              (ref_ice, ice, ICE_TOL)):
        for name, _ in names:
            a = _np(getattr(obj_r, name)).astype(np.float64)
            b = _np(getattr(obj, name)).astype(np.float64)
            out[name] = float(np.abs(a - b).max()
                              / max(np.abs(a).max(), 1e-12))
    return out


def dryrun_multichip(S: int, *, device: str, backend: str) -> dict:
    """The counterpart of ``__graft_entry__.dryrun_multichip``: two float64
    coupled CI steps on the code-built level-3 globe over S ranks,
    gathered and held against the same steps of the one-device Model
    under ``prepare_dist_model``, within the tolerances of
    ``tests/test_dist.py``.  Prints and returns the errors, the CG
    iterations and the halo's size; raises on a disagreement or an
    inconsistent halo."""
    from ..mesh.globe import write_globe
    from ..model import (pi_coupled_step_fn, pi_initial_state,
                         setup_pi_model)
    n_steps = 2
    with tempfile.TemporaryDirectory() as tmp:
        model, atm = setup_pi_model(write_globe(tmp, level=3), device=device)
    prepare_dist_model(model)
    state, ice = pi_initial_state(model)
    layout = dist_layout_for_model(model, S)
    step = pi_coupled_step_fn(model, atm)
    s_ref, i_ref = state, ice
    for k in range(n_steps):
        s_ref, i_ref, _ = step(s_ref, i_ref, k)
    res = run_coupled_steps([dict(model=model, atm=atm, state=state,
                                  ice=ice, n_steps=n_steps)], layout,
                            backend=backend, device=device)[0]
    errs = relative_errors(s_ref, i_ref, res["state"], res["ice"])
    for name, tol in OCEAN_TOL + ICE_TOL:
        if not errs[name] <= tol:
            raise AssertionError(f"{name}: ranks != one device "
                                 f"({errs[name]:.2e} > {tol:.0e})")
    bad = check_halo_consistency(
        dict(state=res["state_d"], ice=res["ice_d"]), layout)
    if bad:
        raise AssertionError(f"halo inconsistent: {bad[:4]}")
    iters = [o["iters"] for o in res["ranks"]]
    print(f"dryrun_multichip: {n_steps} coupled steps over {S} ranks "
          f"({backend}; buffers through host memory: "
          f"{res['ranks'][0]['stage']}) match one device: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"; CG iterations {iters[0]}; halo slots a node exchange "
          f"{layout.halo_slots['node']}, owned {layout.n_own} of "
          f"{layout.n_loc}", flush=True)
    return dict(errors=errs, iters=iters, layout=layout, result=res)
