"""Static tables of the tiled gather kernels.

``elem_to_node_mean`` and ``fct_bounds`` reduce, per level, over the
elements around each node.  Their CUDA kernels (``csrc/``) give a block a
tile of ``TILE_NODES`` consecutive nodes; the block stages the values of
everything the tile touches on one level into shared memory and its
threads gather from there.  What a tile touches and where each node finds
it is constant, so it is derived here once per mesh, on the host in numpy
(``build_mesh_from_raw`` does, and the mesh carries the result as its
``cluster`` field):

* the layer masks as level ranges: a cell is wet for ``lo <= l < hi``
  (``level_ranges`` checks that each mask column is such a range);
* for the mean, per tile the sorted list of the elements around its nodes,
  and per (slot, node) one 32-bit word ``local index | lo << 16 |
  hi << 24`` with the element's wet range, beside the slot's weight (the
  element's area, 0 in a padded slot);
* for the FCT bounds, per node its neighbour nodes (itself first, then
  the other vertices of its elements) with the range of levels over which
  the neighbour is wet and shares a wet element with the node (one entry
  per range where, beside an ice-shelf cavity, these levels are not one
  range), packed the same way over the tile's list of neighbour nodes;
  and per node one word
  ``full_lo | full_hi << 8 | wet_lo << 16 | wet_hi << 24``: the levels on
  which no slot is padded, no element dry and no vertex dry (there the
  cluster bound holds no -1e3 / +1e3 filler), and the node's own wet
  range.

``node_edge_reduce`` sums signed edge fluxes over each node's edges.  Its
kernel gives a thread one node and a run of rows; the thread reads, once,
per slot one word ``edge << 1 | (sign < 0)`` (-1 in a padded slot) from
``edge_slot`` [KE, N], the transpose of ``node_edges`` with the sign
folded in, so that a warp's reads of one slot are contiguous.

``elem_contrib_to_nodes`` (the FEM node assembly) gives a thread one node
and a run of rows the same way.  Per slot it reads one word ``e * 3 + s``
(-1 in a padded slot) from ``elem_slot`` [K, N]: the element and the
node's vertex number in it, folded from ``nod_in_elem`` and
``nod_in_elem_slot`` (``elem_slot_table``; the ice subdomain builds its
own from its local tables).

``mean_emulation``, ``fct_emulation``, ``edge_reduce_emulation`` and
``assembly_emulation`` walk these tables in torch the way the kernels do;
the CPU tests hold them against the plain versions.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

TILE_NODES = 256        # nodes per block; a power of two up to 1024
MAX_LOCAL = 1 << 16     # a local index takes 16 bits of a packed word
MAX_LEVELS = 255        # a level bound takes 8 bits
TARGET_BLOCKS = 2048    # blocks a launch aims at (132 SMs, a few waves)
MIN_PLANES = 4          # fewest staged planes worth a block's set-up
ROW_TARGET_BLOCKS = 8192    # blocks a node_edge_reduce launch aims at
ASSEMBLY_TARGET_BLOCKS = 256    # blocks an elem_contrib_to_nodes launch aims at


@dataclass(frozen=True, eq=False)
class ClusterTables:
    """Tables on the mesh's device; K slots, M neighbour entries, T tiles.
    Packed words are stored as int32 and read as unsigned.  They follow
    from ``nod_in_elem``, ``elem_nodes``, ``elem_area`` and the two layer
    masks: a mesh on which one of these is replaced needs them rebuilt."""
    tile_nodes: int
    mean_slot: torch.Tensor       # [K, N] int32: local elem | lo<<16 | hi<<24
    mean_weight: torch.Tensor     # [K, N] float: elem_area, 0 when padded
    mean_tile_ptr: torch.Tensor   # [T+1] int32 into mean_tile_elems
    mean_tile_elems: torch.Tensor  # [sum U] int32 element ids, sorted per tile
    mean_u_max: int               # longest element list of a tile
    fct_slot: torch.Tensor        # [M, N] int32: local node | lo<<16 | hi<<24
    fct_node: torch.Tensor        # [N] int32: full lo|hi<<8, wet lo<<16|hi<<24
    fct_tile_ptr: torch.Tensor    # [T+1] int32 into fct_tile_nodes
    fct_tile_nodes: torch.Tensor  # [sum U] int32 node ids, sorted per tile
    fct_u_max: int                # longest neighbour list of a tile
    edge_slot: torch.Tensor       # [KE, N] int32: edge<<1 | sign<0, -1 padded
    elem_slot: torch.Tensor       # [K, N] int32: elem*3 + vertex, -1 padded


def level_ranges(mask: np.ndarray):
    """(lo, hi) int64 [X] with ``mask[l, x] == (lo[x] <= l < hi[x])``;
    raises where a column of the bool mask [L, X] is not one run."""
    L = mask.shape[0]
    if L > MAX_LEVELS:
        raise ValueError(f"{L} layers: the packed tables hold {MAX_LEVELS}")
    count = mask.sum(0)
    lo = np.where(count > 0, mask.argmax(0), 0)
    hi = lo + count
    lay = np.arange(L)[:, None]
    if not np.array_equal(mask, (lay >= lo[None]) & (lay < hi[None])):
        raise ValueError("a layer mask column is not one run of levels")
    return lo.astype(np.int64), hi.astype(np.int64)


def _pack(index, lo, hi) -> np.ndarray:
    """index | lo << 16 | hi << 24 as the int32 of the same bits."""
    word = (index.astype(np.uint32) | (lo.astype(np.uint32) << 16)
            | (hi.astype(np.uint32) << 24))
    return word.view(np.int32)


def _tile_lists(tile_of: np.ndarray, ids: np.ndarray, n_tiles: int,
                n_ids: int):
    """Per tile the sorted unique ``ids`` of its members: (ptr [T+1], list,
    local index of each member in its tile's list)."""
    key = tile_of.astype(np.int64) * n_ids + ids
    ukey, inv = np.unique(key, return_inverse=True)
    counts = np.bincount(ukey // n_ids, minlength=n_tiles)
    ptr = np.zeros(n_tiles + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    local = inv.ravel() - ptr[tile_of]
    if counts.max(initial=0) > MAX_LOCAL:
        raise ValueError("a tile's list outgrows a 16-bit local index")
    return ptr, ukey % n_ids, local


def _neighbour_ranges(nie, elem_nodes, e_lo, e_hi, n_lo, n_hi):
    """The (node, neighbour) pairs with the union of the level runs on which
    a shared element and the neighbour are both wet: (node, neighbour, lo,
    hi), sorted by node with the node itself first.  Every node has its self
    entry, with an empty run if nothing around it is wet.  Where the union
    is not one run (beside an ice shelf one element can be wet on [9, 12)
    and another on [0, 3)), the pair has one entry per run, in level
    order."""
    N, K = nie.shape
    valid = nie >= 0
    n_of = np.broadcast_to(np.arange(N)[:, None, None], (N, K, 3))[valid]
    e_of = nie[valid]                                       # [S]
    m_of = elem_nodes[e_of]                                 # [S, 3]
    lo = np.maximum(e_lo[e_of][:, None], n_lo[m_of]).ravel()
    hi = np.minimum(e_hi[e_of][:, None], n_hi[m_of]).ravel()
    n_of, m_of = n_of.ravel(), m_of.ravel()
    keep = lo < hi
    n_of, m_of, lo, hi = n_of[keep], m_of[keep], lo[keep], hi[keep]
    # a node with nothing wet around it still lists itself, with no levels
    lone = np.setdiff1d(np.arange(N), n_of[m_of == n_of])
    none = np.zeros(lone.shape[0], np.int64)
    n_of, m_of = np.concatenate([n_of, lone]), np.concatenate([m_of, lone])
    lo, hi = np.concatenate([lo, none]), np.concatenate([hi, none])
    # group by (node, self first, neighbour), a group's runs by their start
    order = np.lexsort((lo, m_of, m_of != n_of, n_of))
    n_of, m_of, lo, hi = n_of[order], m_of[order], lo[order], hi[order]
    first = np.ones(n_of.shape[0], bool)
    first[1:] = (n_of[1:] != n_of[:-1]) | (m_of[1:] != m_of[:-1])
    group = np.cumsum(first) - 1
    start = np.nonzero(first)[0]
    rank = np.arange(n_of.shape[0]) - start[group]
    # the union of a group's runs, as disjoint runs: a run that starts
    # beyond the end of what the group's earlier runs cover starts a new one
    new_run = first.copy()
    reach = hi.copy()               # the end of the union so far
    for r in range(1, int(rank.max(initial=0)) + 1):
        i = np.nonzero(rank == r)[0]
        new_run[i] = lo[i] > reach[i - 1]
        reach[i] = np.where(new_run[i], hi[i], np.maximum(reach[i - 1], hi[i]))
    run_start = np.nonzero(new_run)[0]
    run_end = np.append(run_start[1:], n_of.shape[0]) - 1
    return (n_of[run_start], m_of[run_start], lo[run_start],
            reach[run_end])


def elem_slot_table(nod_in_elem, nod_in_elem_slot, n_elems: int
                    ) -> np.ndarray:
    """The node assembly's slot words [K, N] int32 from the incidence
    tables [N, K] (numpy): ``e * 3 + s`` where node n's k-th element is e
    and n is its vertex s, -1 in a padded slot (``nod_in_elem`` < 0).  The
    transpose, so that a warp's reads of one slot are contiguous.  Raises
    where a used slot names no element below ``n_elems`` or no vertex 0..2,
    or 3 E outgrows an int32."""
    nie = np.asarray(nod_in_elem).astype(np.int64)
    vert = np.asarray(nod_in_elem_slot).astype(np.int64)
    used = nie >= 0
    if 3 * n_elems >= 1 << 31:
        raise ValueError(f"{n_elems} elements: e * 3 + s outgrows int32")
    if (nie[used] >= n_elems).any() or (vert[used] < 0).any() \
            or (vert[used] > 2).any():
        raise ValueError("nod_in_elem names an element or vertex outside "
                         "the mesh")
    return np.ascontiguousarray(np.where(used, nie * 3 + vert, -1).T,
                                np.int32)


def build_cluster_tables(mesh, tile_nodes: int = 0) -> ClusterTables:
    """Derive the tables from a ``MeshTables`` (any device; the work is
    numpy on the host, the result lies on the mesh's device) for tiles of
    ``tile_nodes`` nodes (0: ``TILE_NODES``).  For another tile size than
    the mesh was built with:
    ``replace(mesh, cluster=build_cluster_tables(mesh, 128))``."""
    tile_nodes = tile_nodes or TILE_NODES
    dev = mesh.nod_in_elem.device
    nie = mesh.nod_in_elem.cpu().numpy().astype(np.int64)
    elem_nodes = mesh.elem_nodes.cpu().numpy().astype(np.int64)
    N, K = nie.shape
    E = elem_nodes.shape[0]
    L = mesh.elem_layer_mask.shape[0]
    e_lo, e_hi = level_ranges(mesh.elem_layer_mask.cpu().numpy())
    n_lo, n_hi = level_ranges(mesh.node_layer_mask.cpu().numpy())
    n_tiles = -(-N // tile_nodes)
    tile_of_node = np.arange(N) // tile_nodes
    valid = nie >= 0
    safe = np.where(valid, nie, 0)

    # ---- elem_to_node_mean ------------------------------------------------
    nn, kk = np.nonzero(valid)
    ptr, elems, local = _tile_lists(tile_of_node[nn], nie[nn, kk], n_tiles, E)
    slot_local = np.zeros((N, K), np.int64)
    slot_local[nn, kk] = local
    # a padded slot: any index, every level, weight 0
    mean_slot = _pack(slot_local, np.where(valid, e_lo[safe], 0),
                      np.where(valid, e_hi[safe], L))
    area = mesh.elem_area.cpu().numpy()
    mean_weight = np.where(valid, area[safe], 0.0).astype(area.dtype)
    mean_u_max = int(np.diff(ptr).max(initial=0))

    # ---- fct_bounds -------------------------------------------------------
    node, nb, r_lo, r_hi = _neighbour_ranges(nie, elem_nodes, e_lo, e_hi,
                                             n_lo, n_hi)
    fptr, fnodes, flocal = _tile_lists(tile_of_node[node], nb, n_tiles, N)
    count = np.bincount(node, minlength=N)
    M = int(count.max())
    offs = np.zeros(N + 1, np.int64)
    np.cumsum(count, out=offs[1:])
    entry = np.arange(node.shape[0]) - offs[node]
    fct_slot = np.zeros((N, M), np.int32)           # padding: an empty run
    fct_slot[node, entry] = _pack(flocal, r_lo, r_hi)
    # the levels where the plain cluster bound sees no filler value
    full = valid.all(1)
    v_lo = np.maximum(e_lo[safe][:, :, None], n_lo[elem_nodes[safe]])
    v_hi = np.minimum(e_hi[safe][:, :, None], n_hi[elem_nodes[safe]])
    f_lo = v_lo.reshape(N, -1).max(1)
    f_hi = v_hi.reshape(N, -1).min(1)
    full &= f_lo < f_hi
    f_lo, f_hi = np.where(full, f_lo, 0), np.where(full, f_hi, 0)
    fct_node = (f_lo.astype(np.uint32) | (f_hi.astype(np.uint32) << 8)
                | (n_lo.astype(np.uint32) << 16)
                | (n_hi.astype(np.uint32) << 24)).view(np.int32)

    # ---- node_edge_reduce -------------------------------------------------
    ne = mesh.node_edges.cpu().numpy().astype(np.int64)
    sign = mesh.node_edge_sign.cpu().numpy()
    if int(ne.max(initial=0)) >= 1 << 30:
        raise ValueError("an edge index outgrows 30 bits of a slot word")
    if not np.array_equal(np.abs(sign), (ne >= 0).astype(sign.dtype)):
        raise ValueError("node_edge_sign is not +-1 on edges, 0 on padding")
    edge_slot = np.where(ne >= 0, ne << 1 | (sign < 0), -1)

    i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                    device=dev)
    return ClusterTables(
        tile_nodes=tile_nodes,
        mean_slot=i32(mean_slot.T),
        mean_weight=torch.as_tensor(np.ascontiguousarray(mean_weight.T),
                                    device=dev),
        mean_tile_ptr=i32(ptr), mean_tile_elems=i32(elems),
        mean_u_max=mean_u_max,
        fct_slot=i32(fct_slot.T), fct_node=i32(fct_node),
        fct_tile_ptr=i32(fptr), fct_tile_nodes=i32(fnodes),
        fct_u_max=int(np.diff(fptr).max(initial=0)),
        edge_slot=i32(edge_slot.T),
        elem_slot=i32(elem_slot_table(
            nie, mesh.nod_in_elem_slot.cpu().numpy(), E)))


def tile_stats(ptr: torch.Tensor, ids: torch.Tensor, itemsize: int) -> dict:
    """How local a mesh's numbering is to the tiles: per tile, on average,
    the entries of its list (``ptr``, ``ids`` as in ``ClusterTables``) and
    the 32-byte sectors of one field row that staging them touches."""
    ptr, ids = ptr.cpu().numpy().astype(np.int64), ids.cpu().numpy()
    tiles = ptr.shape[0] - 1
    tile_of = np.repeat(np.arange(tiles), np.diff(ptr))
    per_sector = 32 // itemsize
    span = int(ids.max(initial=0)) // per_sector + 1
    sectors = np.unique(tile_of * span + ids // per_sector).shape[0]
    return {"tiles": tiles, "entries_per_tile": ids.shape[0] / tiles,
            "sectors_per_tile": sectors / tiles}


def table_tile_stats(table: torch.Tensor, tile_nodes: int, itemsize: int,
                     warp: int = 32) -> dict:
    """How local the gathers through an incidence table [N, K] (-1 padded)
    are, per tile of ``tile_nodes`` consecutive nodes on average: the
    distinct entries the tile names, the 32-byte sectors of one field row
    that hold them (what staging the tile once would move), and the
    sectors summed over the gather instructions of its warps (``warp``
    consecutive nodes reading one slot: what direct gathers move when no
    cache merges them across instructions)."""
    ids = table.cpu().numpy().astype(np.int64)
    N, K = ids.shape
    per_sector = 32 // itemsize
    tiles = -(-N // tile_nodes)
    span = int(ids.max(initial=0)) + 1
    valid = ids >= 0

    def distinct(group, what):
        key = (np.broadcast_to(group[:, None], ids.shape)[valid] * span
               + what[valid])
        return np.unique(key).shape[0]

    node = np.arange(N)
    slot_of = np.broadcast_to(np.arange(K)[None, :], ids.shape)
    return {"tiles": tiles,
            "entries_per_tile": distinct(node // tile_nodes, ids) / tiles,
            "sectors_per_tile": distinct(node // tile_nodes,
                                         ids // per_sector) / tiles,
            "warp_sectors_per_tile": distinct(
                node // warp, slot_of * span + ids // per_sector) / tiles}


def level_chunk(levels: int, planes_per_level: int,
                blocks_per_chunk: int) -> int:
    """Levels per block: as few chunks of the column as give
    ``TARGET_BLOCKS`` blocks, but no chunk under ``MIN_PLANES`` staged
    planes (what a block sets up once is spread over them)."""
    chunks = -(-TARGET_BLOCKS // max(blocks_per_chunk, 1))
    most = max(1, levels * planes_per_level // MIN_PLANES)
    chunks = max(1, min(chunks, most, levels))
    return -(-levels // chunks)


def row_chunk(rows: int, blocks_per_chunk: int, target: int = 0) -> int:
    """Rows per thread of a kernel that gives a thread one node and a run
    of rows: as few runs of the rows as give ``target`` blocks (0:
    ``ROW_TARGET_BLOCKS``, ``node_edge_reduce``'s; a small mesh: one row a
    thread).  That kernel stages nothing, so its blocks are cheap and many
    short runs hide the gathers' latency best (swept on the level-7 globe
    with ``scripts/gather_kernel_times.py --row-target-blocks``)."""
    chunks = -(-(target or ROW_TARGET_BLOCKS) // max(blocks_per_chunk, 1))
    return -(-rows // max(1, min(chunks, rows)))


def assembly_row_chunk(rows: int, blocks_per_chunk: int) -> int:
    """Rows per thread of ``elem_contrib_to_nodes``: ``row_chunk`` aimed
    at ``ASSEMBLY_TARGET_BLOCKS`` blocks.  On the level-7 globe (446
    blocks a run) a thread then walks all rows of a call, and the ice
    subdomain (142) one row: swept there from 256 to 8,192 with
    ``scripts/assembly_kernel_times.py --target-blocks``, this was the
    fastest over the coupled step's six calls in both dtypes."""
    return row_chunk(rows, blocks_per_chunk, ASSEMBLY_TARGET_BLOCKS)


def _unpack(word: torch.Tensor):
    w = word.long() & 0xFFFFFFFF
    return w & 0xFFFF, (w >> 16) & 0xFF, w >> 24


def _tile_base(ct: ClusterTables, ptr: torch.Tensor, n_nodes: int):
    """Start of each node's tile list in the concatenated lists: [N]."""
    tile = torch.arange(n_nodes, device=ptr.device) // ct.tile_nodes
    return ptr.long()[tile]


def mean_emulation(x: torch.Tensor, ct: ClusterTables,
                   respect_levels: bool = True) -> torch.Tensor:
    """``elem_to_node_mean`` as its tiled kernel computes it: [.., L, E] ->
    [.., L, N], each node reading its tile's staged element values."""
    L = x.shape[-2]
    K, N = ct.mean_slot.shape
    local, lo, hi = _unpack(ct.mean_slot)                   # [K, N]
    elem = ct.mean_tile_elems.long()[
        _tile_base(ct, ct.mean_tile_ptr, N)[None] + local]  # [K, N]
    lay = torch.arange(L, device=x.device)[:, None, None]
    w = ct.mean_weight.to(x.dtype)[None].expand(L, K, N)
    if respect_levels:
        w = torch.where((lay >= lo[None]) & (lay < hi[None]), w, 0.0)
    num = torch.zeros(x.shape[:-1] + (N,), dtype=x.dtype, device=x.device)
    den = torch.zeros((L, N), dtype=x.dtype, device=x.device)
    for k in range(K):
        used = w[:, k] != 0
        num = num + torch.where(used, x[..., elem[k]] * w[:, k], 0.0)
        den = den + w[:, k]
    return num / den.clamp_min(1e-30)


def edge_reduce_emulation(flux: torch.Tensor, ct: ClusterTables,
                          pair: bool = False):
    """``node_edge_reduce`` as its kernel computes it: [.., Ed] -> [.., N]
    (``pair``: the sums of the positive and of the negative terms).  Each
    node walks its slot words in the order k = 0..KE-1, takes the flux or
    its negation by the word's low bit, and skips a padded slot."""
    KE, N = ct.edge_slot.shape
    shape = flux.shape[:-1] + (N,)
    acc = torch.zeros(shape, dtype=flux.dtype, device=flux.device)
    acc_minus = torch.zeros_like(acc)
    for k in range(KE):
        word = ct.edge_slot[k].long()
        used = word >= 0
        v = flux[..., (word >> 1).clamp_min(0)]
        v = torch.where((word & 1) == 1, -v, v)
        if pair:
            acc = torch.where(used, acc + torch.where(v > 0, v, 0.0), acc)
            acc_minus = torch.where(
                used, acc_minus + torch.where(v < 0, v, 0.0), acc_minus)
        else:
            acc = torch.where(used, acc + v, acc)
    return (acc, acc_minus) if pair else acc


def assembly_emulation(flat: torch.Tensor, elem_slot: torch.Tensor,
                       n_elems: int, vertex_major: bool, row_chunk: int,
                       unroll: int = 2) -> torch.Tensor:
    """``elem_contrib_to_nodes`` as its kernel computes it: contrib
    [R, 3 E] -> [R, N].  Each node decodes its slot words once (``e = w //
    3``, ``s = w - 3 e``; the offset ``w`` element-major, ``s * E + e``
    vertex-major), then walks its rows in runs of ``row_chunk``, ``unroll``
    rows at a time, every gather of those rows taken before the first sum,
    each sum from 0 in the order k = 0..K-1 over the used slots."""
    K, N = elem_slot.shape
    R = flat.shape[0]
    word = elem_slot.long()
    e = torch.div(word, 3, rounding_mode="floor")
    off = (word - 3 * e) * n_elems + e if vertex_major else word
    used = word >= 0
    off = torch.where(used, off, 0)
    out = torch.empty((R, N), dtype=flat.dtype, device=flat.device)
    for r0 in range(0, R, row_chunk):
        r1 = min(R, r0 + row_chunk)
        for a in range(r0, r1, unroll):
            rows = range(a, min(r1, a + unroll))
            v = {(r, k): flat[r, off[k]] for r in rows for k in range(K)}
            for r in rows:
                acc = torch.zeros(N, dtype=flat.dtype, device=flat.device)
                for k in range(K):
                    acc = torch.where(used[k], acc + v[r, k], acc)
                out[r] = acc
    return out


def fct_emulation(ttf: torch.Tensor, lo: torch.Tensor, ct: ClusterTables,
                  nlevels_node: torch.Tensor, big: float = 1e3):
    """``fct_bounds`` as its tiled kernel computes it: the cluster bound
    from the neighbour table, then the +-1 layer widening."""
    L, N = lo.shape[-2:]
    M = ct.fct_slot.shape[0]
    local, s_lo, s_hi = _unpack(ct.fct_slot)                # [M, N]
    nb = ct.fct_tile_nodes.long()[
        _tile_base(ct, ct.fct_tile_ptr, N)[None] + local]
    info = ct.fct_node.long() & 0xFFFFFFFF
    f_lo, f_hi = info & 0xFF, (info >> 8) & 0xFF
    w_lo, w_hi = (info >> 16) & 0xFF, info >> 24
    lay = torch.arange(L, device=lo.device)[:, None]
    full = (lay >= f_lo) & (lay < f_hi)
    hi_v, lo_v = torch.maximum(lo, ttf), torch.minimum(lo, ttf)
    cmax = torch.full_like(lo, -big)
    cmin = torch.full_like(lo, big)
    for j in range(M):
        act = (lay >= s_lo[j]) & (lay < s_hi[j])
        vx, vn = hi_v[..., nb[j]], lo_v[..., nb[j]]
        first = full if j == 0 else torch.zeros_like(full)
        cmax = torch.where(act, torch.where(first, vx,
                                            torch.maximum(cmax, vx)), cmax)
        cmin = torch.where(act, torch.where(first, vn,
                                            torch.minimum(cmin, vn)), cmin)
    up = lambda c: torch.cat([c[..., :1, :], c[..., :-1, :]], -2)
    dn = lambda c: torch.cat([c[..., 1:, :], c[..., -1:, :]], -2)
    interior = (lay >= 1) & (lay <= (nlevels_node.long() - 3)[None])
    vmax = torch.where(interior, torch.maximum(
        cmax, torch.maximum(up(cmax), dn(cmax))), cmax)
    vmin = torch.where(interior, torch.minimum(
        cmin, torch.minimum(up(cmin), dn(cmin))), cmin)
    wet = (lay >= w_lo) & (lay < w_hi)
    return (torch.where(wet, vmax - lo, 0.0), torch.where(wet, vmin - lo, 0.0))
