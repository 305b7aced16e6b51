"""Core mesh operators: gathers, edge/node assembly, gradients, column
solves, and the preconditioned CG of the SSH solve.

The port of ``fesom2_tpu/core/ops.py``.  Layout is levels-major
``[nl(-1), X]`` with X the nodes, elements or edges; index tables are the
mesh's int32 tables padded with -1, and every padded index is clamped or
skipped before it is read.

Four operators run a hand-written CUDA kernel on a CUDA tensor
(``csrc/``): ``edge_divergence`` and ``edge_signed_reduce2``
(node_edge_reduce), ``elem_to_node_mean`` and ``elem_to_node_mean_flat``
(elem_to_node_mean), ``elem_contrib_to_nodes`` and its ``_3e`` form,
``tridiag_solve``.  Beside each is its plain torch
version (``*_plain``), which the wrapper uses for a CPU tensor and nowhere
else: a CUDA tensor goes through the kernel or the call raises.

On a rank of a distributed run (``parallel/dist.py``) every node or
element assembly hands its output to the active context's halo exchange
(``halo_fix_nodes``, ``halo_fix_elems``) and ``node_sum`` sums over the
ranks; outside a context the hooks are the identity.
"""
from __future__ import annotations

import contextlib

import torch

from .. import kernels
from ..mesh import MeshTables
from ..mesh.cluster import assembly_row_chunk, level_chunk, row_chunk


# --------------------------------------------------------------------------
# the distributed context (parallel/dist.py)
# --------------------------------------------------------------------------
# On a rank of a distributed run every node or element ASSEMBLY below is
# exact only at owned entities (a halo slot's incidence rows are
# incomplete on purpose).  The active DistContext replaces the halo slots
# with their owners' values right after each assembly, where the
# reference calls exchange_nod / exchange_elem (gen_halo_exchange.F90:
# 129-164).  Outside a context every hook is the identity: one test, no
# launch.
_DIST_CTX = None


@contextlib.contextmanager
def dist_context(ctx):
    """Make ``ctx`` (a ``parallel.dist.DistContext``) the active one."""
    global _DIST_CTX
    prev = _DIST_CTX
    _DIST_CTX = ctx
    try:
        yield ctx
    finally:
        _DIST_CTX = prev


def in_dist_context() -> bool:
    return _DIST_CTX is not None


def halo_fix_nodes(x: torch.Tensor, sub: bool = False) -> torch.Tensor:
    """x [..., n_loc] with its halo entries replaced by the owners' values
    (identity outside a context); ``sub``: x is numbered on the ice
    subdomain and takes its schedule (the context checks the size)."""
    if _DIST_CTX is None:
        return x
    return _DIST_CTX.exchange_nodes(x, sub=sub)


def halo_fix_elems(x: torch.Tensor) -> torch.Tensor:
    """x [..., e_loc] with its halo entries replaced by the owners'."""
    if _DIST_CTX is None:
        return x
    return _DIST_CTX.exchange_elems(x)


def halo_accumulate_nodes(x: torch.Tensor) -> torch.Tensor:
    """ADD the halo entries of x [..., n_loc] into their owners and refresh
    the halos (identity outside a context): the reverse direction, for an
    operator that writes partial sums at halo slots (the block-Schwarz
    combine)."""
    if _DIST_CTX is None:
        return x
    return _DIST_CTX.accumulate_nodes(x)


def halo_fix_node_pair(a: torch.Tensor, b: torch.Tensor):
    """``halo_fix_nodes`` of two node fields of one shape, in one
    exchange."""
    if _DIST_CTX is None:
        return a, b
    both = _DIST_CTX.exchange_nodes(torch.stack([a, b]))
    return both[0], both[1]


def on_subdomain(mesh) -> bool:
    """Whether ``mesh`` is the ice subdomain (duck-typed MeshTables)."""
    return not isinstance(mesh, MeshTables)


def _flat_rows(x: torch.Tensor) -> torch.Tensor:
    """[..., X] -> contiguous [R, X]."""
    return x.reshape(-1, x.shape[-1]).contiguous()


# --------------------------------------------------------------------------
# gathers
# --------------------------------------------------------------------------
def take_row(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-column row gather: a[..., L, N] at row idx[N] -> [..., N].  A
    row outside 0..L-1 reads the nearest one, as a JAX gather does: the
    dummy nodes of a padded mesh have one level and no element, so their
    ``nlevels - 2`` is -1 and their min over the elements' levels 10**6."""
    ib = idx.long().clamp(0, a.shape[-2] - 1).expand(
        a.shape[:-2] + (1, idx.shape[-1]))
    return torch.gather(a, -2, ib)[..., 0, :]


def column_sum(x: torch.Tensor) -> torch.Tensor:
    """x [L, N] summed over the levels, top down, each column in the same
    order wherever it lies in the tensor (``x.sum(0)`` on the CPU may add
    columns of the vectorised body and of the tail in other orders): a
    rank's halo copy of a column then sums as its owner does, bit for
    bit."""
    return torch.cumsum(x, 0)[-1]


def column_levels(mesh: MeshTables) -> torch.Tensor:
    """``nlevels_node`` as the column kernels take it: at least 2.  The
    dummy nodes of a padded mesh (``parallel/padding.py``) or of a rank's
    local mesh (``parallel/dist.py``) have one level; the kernels, which
    assume a wet layer, run them as one-layer columns whose results
    nothing reads.  Every real column has two levels or more."""
    return mesh.nlevels_node.clamp_min(2)


def elem_mean_node(x: torch.Tensor, mesh: MeshTables) -> torch.Tensor:
    """Average a node field to elements: [.., N] -> [.., E]."""
    return x[..., mesh.elem_nodes].mean(-1)


def edge_transport(uh: torch.Tensor, vh: torch.Tensor,
                   mesh: MeshTables) -> torch.Tensor:
    """Per-edge transport through the two centroid-to-midpoint segments:
    ``c = (vh|et1*dX1 - uh|et1*dY1) - (vh|et2*dX2 - uh|et2*dY2)``
    (ref oce_ale.F90:1724-1780).  Callers pass level-masked uh, vh."""
    et1, et2 = mesh.edge_tri[:, 0], mesh.edge_tri[:, 1]
    has2 = et2 >= 0
    et2s = torch.where(has2, et2, 0)
    dX1, dY1 = mesh.edge_cross_dxdy[:, 0], mesh.edge_cross_dxdy[:, 1]
    dX2, dY2 = mesh.edge_cross_dxdy[:, 2], mesh.edge_cross_dxdy[:, 3]
    c1 = vh[..., et1] * dX1 - uh[..., et1] * dY1
    c2 = torch.where(has2, -(vh[..., et2s] * dX2 - uh[..., et2s] * dY2), 0.0)
    return c1 + c2


def scalar_gradient(f_nodes: torch.Tensor, mesh: MeshTables):
    """Gradient of a node scalar on elements: [.., N] -> (gx, gy) [.., E]
    (ref tracer_gradient_elements, oce_tracer_mod.F90:19-45)."""
    fe = f_nodes[..., mesh.elem_nodes]                      # [.., E, 3]
    gx = (fe * mesh.gradient_sca[:, 0:3]).sum(-1)
    gy = (fe * mesh.gradient_sca[:, 3:6]).sum(-1)
    return gx, gy


# --------------------------------------------------------------------------
# edge -> node assembly (kernel node_edge_reduce)
# --------------------------------------------------------------------------
def _signed_slot_sum(flux: torch.Tensor, mesh: MeshTables, fn=None):
    """sum_k fn(sign[n, k] * flux[.., node_edges[n, k]]) over the valid
    slots, in the order k = 0..KE-1 (``slot_order_sum``): sign is +1 or -1,
    so each term is flux or -flux to the bit, as the kernel reads it."""
    ne = mesh.node_edges.long()
    valid = ne >= 0
    Ed = flux.shape[-1]
    idx = torch.where(mesh.node_edge_sign < 0, ne + Ed, ne)
    both = torch.cat([flux, -flux], -1)
    if fn is not None:
        both = fn(both)
    return slot_order_sum(both, torch.where(valid, idx, 0), valid)


def edge_divergence_plain(flux: torch.Tensor, mesh: MeshTables):
    return _signed_slot_sum(flux, mesh)


def edge_signed_reduce2_plain(flux: torch.Tensor, mesh: MeshTables):
    return (_signed_slot_sum(flux, mesh, lambda v: v.clamp_min(0.0)),
            _signed_slot_sum(flux, mesh, lambda v: v.clamp_max(0.0)))


def edge_signed_reduce(flux: torch.Tensor, mesh: MeshTables, fn):
    """fn(sign * flux) summed over each node's incident edges, in slot
    order (JAX ``ops.edge_signed_reduce``; plain torch only: no model path
    calls it, ``edge_signed_reduce2`` is the limiter's pair)."""
    return halo_fix_nodes(_signed_slot_sum(flux, mesh, fn))


def _node_edge_reduce(flux: torch.Tensor, mesh: MeshTables, pair: bool):
    """The kernel on the mesh's ``edge_slot`` table: a thread per node
    walks ``row_chunk`` rows of flux [.., Ed] flattened to [R, Ed]."""
    kernels.cuda_only(flux, "node_edge_reduce")
    f = _flat_rows(flux)
    R, Ed = f.shape
    slot = mesh.cluster.edge_slot
    KE, N = slot.shape
    dev, dt = flux.device, flux.dtype
    kernels.require(f, "flux", (R, mesh.n_edges), dt, dev)
    kernels.require(slot, "edge_slot", (KE, mesh.n_nodes), torch.int32, dev)
    out0 = torch.empty((R, N), dtype=dt, device=dev)
    out1 = torch.empty((R, N), dtype=dt, device=dev) if pair else None
    blocks = -(-N // kernels.BLOCK_THREADS)
    kernels.launch("node_edge_reduce", dev, f, R, Ed, slot, N, KE,
                   row_chunk(R, blocks), out0, out1, int(pair),
                   kernels.float_code(dt))
    shape = flux.shape[:-1] + (N,)
    if pair:
        return out0.reshape(shape), out1.reshape(shape)
    return out0.reshape(shape)


def node_edge_reduce_work(rows: int, n_edges: int, n_nodes: int, ke: int,
                          pair: bool, itemsize: int) -> tuple:
    """(bytes, flops) of one call on flux [rows, Ed]: the flux, the
    [N, KE] edge and sign tables, one or two outputs [rows, N]; a product
    and an add per slot, the pair form clamps and adds twice."""
    outs = 2 if pair else 1
    nbytes = (rows * n_edges * itemsize + n_nodes * ke * (4 + itemsize)
              + outs * rows * n_nodes * itemsize)
    return nbytes, (2 + 2 * outs) * ke * rows * n_nodes


def edge_divergence(flux: torch.Tensor, mesh: MeshTables) -> torch.Tensor:
    """Per-node divergence of signed edge fluxes: flux[.., Ed] counted
    positive INTO edges[:,0]; returns [.., N] (+flux at node0, -flux at
    node1; ref ssh_rhs(enodes(1))+=c, oce_ale.F90:1542).  Gathered over
    the node->edge incidence table, no scatter."""
    if flux.device.type == "cpu":
        return halo_fix_nodes(edge_divergence_plain(flux, mesh))
    return halo_fix_nodes(_node_edge_reduce(flux, mesh, pair=False))


def edge_signed_reduce2(flux: torch.Tensor, mesh: MeshTables):
    """(plus, minus) sums of max(0, sign*flux) and min(0, sign*flux) over
    each node's incident edges, from one pass (the FCT b1 pair, ref
    oce_adv_tra_fct.F90:215-263)."""
    if flux.device.type == "cpu":
        plus, minus = edge_signed_reduce2_plain(flux, mesh)
    else:
        plus, minus = _node_edge_reduce(flux, mesh, pair=True)
    return halo_fix_node_pair(plus, minus)


# --------------------------------------------------------------------------
# element -> node averaging (kernel elem_to_node_mean)
# --------------------------------------------------------------------------
def _nie_weights(mesh: MeshTables):
    nie = mesh.nod_in_elem                                  # [N, K]
    valid = nie >= 0
    safe = torch.where(valid, nie, 0)
    w = torch.where(valid, mesh.elem_area[safe], 0.0)       # [N, K]
    return safe, w


def elem_to_node_mean_plain(x_elem: torch.Tensor, mesh: MeshTables,
                            respect_levels: bool = True) -> torch.Tensor:
    """The weighted sums taken over the slots in the order k = 0..K-1, a
    slot of weight 0 adding nothing, as the kernel takes them (``torch.sum``
    over the slots may add in another order): kernel and plain agree bit
    for bit."""
    safe, w = _nie_weights(mesh)
    num = den = None
    for k in range(safe.shape[1]):
        wk = w[:, k]
        if respect_levels:
            wk = torch.where(mesh.elem_layer_mask[..., safe[:, k]], wk, 0.0)
        term = torch.where(wk != 0, x_elem[..., safe[:, k]] * wk, 0.0)
        num = term if num is None else num + term
        den = wk if den is None else den + wk
    return num / den.clamp_min(1e-30)


def elem_to_node_mean_flat_plain(xs: torch.Tensor,
                                 mesh: MeshTables) -> torch.Tensor:
    safe, w = _nie_weights(mesh)
    # a dummy node (padded mesh) has no element: 0, as in the kernel
    return (xs[..., safe] * w).sum(-1) / w.sum(-1).clamp_min(1e-30)


def _elem_to_node_mean_tiled(x: torch.Tensor, mesh: MeshTables,
                             respect_levels: bool) -> torch.Tensor:
    """The tiled kernel on the mesh's cluster tables: [.., L, E]."""
    kernels.cuda_only(x, "elem_to_node_mean")
    dev, dt = x.device, x.dtype
    E = mesh.n_elems
    N, K = mesh.nod_in_elem.shape
    levels = x.shape[-2]
    if levels != mesh.nl - 1:
        raise ValueError(f"x_elem: {levels} layers, the mesh has "
                         f"{mesh.nl - 1}")
    xf = x.reshape(-1, levels, E).contiguous()
    R = xf.shape[0]
    ct = mesh.cluster
    tiles = ct.mean_tile_ptr.shape[0] - 1
    kernels.require(xf, "x_elem", (R, levels, E), dt, dev)
    kernels.require(ct.mean_slot, "mean_slot", (K, N), torch.int32, dev)
    kernels.require(ct.mean_weight, "mean_weight", (K, N), dt, dev)
    kernels.require(ct.mean_tile_ptr, "mean_tile_ptr", (tiles + 1,),
                    torch.int32, dev)
    kernels.require(ct.mean_tile_elems, "mean_tile_elems",
                    ct.mean_tile_elems.shape, torch.int32, dev)
    out = torch.empty((R, levels, N), dtype=dt, device=dev)
    kernels.launch("elem_to_node_mean", dev, xf, R, levels, E, N, K,
                   ct.mean_slot, ct.mean_weight, ct.mean_tile_ptr,
                   ct.mean_tile_elems, ct.tile_nodes, ct.mean_u_max,
                   level_chunk(levels, R, tiles), int(respect_levels), out,
                   kernels.float_code(dt))
    return out.reshape(x.shape[:-1] + (N,))


def _elem_to_node_mean_flat(xs: torch.Tensor,
                            mesh: MeshTables) -> torch.Tensor:
    """The one-thread-per-output kernel on ``nod_in_elem``: [.., E]."""
    kernels.cuda_only(xs, "elem_to_node_mean")
    dev, dt = xs.device, xs.dtype
    E = mesh.n_elems
    N, K = mesh.nod_in_elem.shape
    xf = _flat_rows(xs)
    R = xf.shape[0]
    kernels.require(xf, "x_elem", (R, E), dt, dev)
    kernels.require(mesh.nod_in_elem, "nod_in_elem", (N, K), torch.int32, dev)
    kernels.require(mesh.elem_area, "elem_area", (E,), dt, dev)
    out = torch.empty((R, N), dtype=dt, device=dev)
    kernels.launch("elem_to_node_mean", dev, xf, R, E, mesh.nod_in_elem, N, K,
                   mesh.elem_area, out, kernels.float_code(dt), entry="_flat")
    return out.reshape(xs.shape[:-1] + (N,))


def elem_to_node_mean_work(rows: int, levels: int, n_elems: int, n_nodes: int,
                           k_max: int, itemsize: int, list_len: int = 0,
                           tile_nodes: int = 0) -> tuple:
    """(bytes, flops) of one call on x [rows, levels, E].  Layered
    (``list_len`` = length of the tiles' element lists): x, the [K, N]
    slot words and weights, the tile lists and pointers, the output.
    Flat (``list_len`` 0): x, ``nod_in_elem`` [N, K], ``elem_area`` [E],
    the output.  Per output K products, 2 K adds and a division."""
    field = rows * levels * (n_elems + n_nodes) * itemsize
    if list_len:
        tiles = -(-n_nodes // tile_nodes)
        tables = k_max * n_nodes * (4 + itemsize) + 4 * (list_len + tiles + 1)
    else:
        tables = n_nodes * k_max * 4 + n_elems * itemsize
    return field + tables, (3 * k_max + 1) * rows * levels * n_nodes


def elem_to_node_mean(x_elem: torch.Tensor, mesh: MeshTables,
                      respect_levels: bool = True) -> torch.Tensor:
    """Area-weighted average of a layered element field to nodes:
    [.., nl-1, E] -> [.., nl-1, N].  With ``respect_levels`` only elements
    active on the layer contribute (compute_vel_nodes, oce_dyn.F90:133-169);
    without, all adjacent elements do (visc_filt_bcksct, :619-635)."""
    if x_elem.device.type == "cpu":
        return halo_fix_nodes(elem_to_node_mean_plain(x_elem, mesh,
                                                      respect_levels))
    return halo_fix_nodes(_elem_to_node_mean_tiled(x_elem, mesh,
                                                   respect_levels))


def elem_to_node_mean_flat(xs: torch.Tensor, mesh: MeshTables) -> torch.Tensor:
    """Stacked surface element fields [F, E] -> [F, N], area-weighted over
    all adjacent elements (no level masks)."""
    if xs.device.type == "cpu":
        return halo_fix_nodes(elem_to_node_mean_flat_plain(xs, mesh))
    return halo_fix_nodes(_elem_to_node_mean_flat(xs, mesh))


# --------------------------------------------------------------------------
# FEM node assembly (kernel elem_contrib_to_nodes)
# --------------------------------------------------------------------------
def _contrib_index(mesh, vertex_major: bool):
    """Where node n finds, in a row of contrib flattened, the value its
    k-th adjacent element adds to it: (index [N, K] long, 0 at padded
    slots; valid [N, K]).  ``mesh`` is the mesh or the ice subdomain."""
    nie = mesh.nod_in_elem.long()
    valid = nie >= 0
    safe = torch.where(valid, nie, 0)
    slot = mesh.nod_in_elem_slot.long()
    idx = slot * mesh.n_elems + safe if vertex_major else safe * 3 + slot
    return torch.where(valid, idx, 0), valid


def slot_order_sum(flat: torch.Tensor, idx: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """sum_k valid[n, k] ? flat[..., idx[n, k]] : 0, added in the order
    k = 0..K-1 (the order of the kernels and of the JAX package's reduce
    over its slot axis; ``torch.sum`` over the slots may add otherwise)."""
    out = None
    for k in range(idx.shape[1]):
        v = torch.where(valid[:, k], flat[..., idx[:, k]], 0.0)
        out = v if out is None else out + v
    return out


def elem_contrib_to_nodes_plain(contrib: torch.Tensor, mesh,
                                vertex_major: bool = False) -> torch.Tensor:
    flat = contrib.reshape(contrib.shape[:-2] + (-1,))
    return slot_order_sum(flat, *_contrib_index(mesh, vertex_major))


def elem_contrib_to_nodes_work(rows: int, n_elems: int, n_nodes: int,
                               k_max: int, itemsize: int) -> tuple:
    """(bytes, flops) of one call on contrib [rows, 3 E]: contrib, the
    output [rows, N] and one int32 word a slot (where node n finds its
    k-th contribution: ``elem_slot``, or any table that says as much); an
    add per slot."""
    nbytes = rows * (3 * n_elems + n_nodes) * itemsize + n_nodes * k_max * 4
    return nbytes, k_max * rows * n_nodes


def elem_slot_of(mesh) -> torch.Tensor:
    """The node assembly's packed slot table [K, N] (``e * 3 + s``, -1
    padded; ``mesh/cluster.py``): the mesh's, or the ice subdomain's own."""
    return mesh.cluster.elem_slot if isinstance(mesh, MeshTables) \
        else mesh.elem_slot


def _elem_contrib_to_nodes(contrib: torch.Tensor, mesh,
                           vertex_major: bool) -> torch.Tensor:
    if contrib.device.type == "cpu":
        out = elem_contrib_to_nodes_plain(contrib, mesh, vertex_major)
    else:
        out = _assemble(contrib, mesh, vertex_major)
    return halo_fix_nodes(out, sub=on_subdomain(mesh))


def _assemble(contrib: torch.Tensor, mesh, vertex_major: bool):
    """The kernel on the packed slot table: a thread per node walks
    ``assembly_row_chunk`` rows of contrib flattened to [R, 3 E]."""
    kernels.cuda_only(contrib, "elem_contrib_to_nodes")
    dev, dt = contrib.device, contrib.dtype
    E = mesh.n_elems
    slot = elem_slot_of(mesh)
    K, N = slot.shape
    want = (3, E) if vertex_major else (E, 3)
    if tuple(contrib.shape[-2:]) != want:
        raise ValueError(f"contrib: trailing shape {tuple(contrib.shape[-2:])}"
                         f", expected {want}")
    flat = contrib.reshape(-1, 3 * E).contiguous()
    R = flat.shape[0]
    kernels.require(flat, "contrib", (R, 3 * E), dt, dev)
    kernels.require(slot, "elem_slot", (K, mesh.n_nodes), torch.int32, dev)
    out = torch.empty((R, N), dtype=dt, device=dev)
    blocks = -(-N // kernels.BLOCK_THREADS)
    kernels.launch("elem_contrib_to_nodes", dev, flat, R, E, slot, N, K,
                   assembly_row_chunk(R, blocks), int(vertex_major), out,
                   kernels.float_code(dt))
    return out.reshape(contrib.shape[:-2] + (N,))


def elem_contrib_to_nodes(contrib: torch.Tensor, mesh) -> torch.Tensor:
    """Accumulate per-(element, local vertex) contributions onto nodes:
    contrib [..., E, 3] is what element e adds to its k-th vertex; returns
    [..., N].  Each node pulls from its adjacent elements through
    ``nod_in_elem`` and its own slot within each (``nod_in_elem_slot``), in
    slot order; no scatter (the kernel reads both from one packed word a
    slot, ``elem_slot_of(mesh)``).  Leading axes are independent rows, so
    a caller stacks fields into one call.  ``mesh`` is the mesh or the ice
    subdomain."""
    return _elem_contrib_to_nodes(contrib, mesh, vertex_major=False)


def elem_contrib_to_nodes_3e(contrib: torch.Tensor, mesh) -> torch.Tensor:
    """``elem_contrib_to_nodes`` for contrib [..., 3, E] (vertex-major)."""
    return _elem_contrib_to_nodes(contrib, mesh, vertex_major=True)


# --------------------------------------------------------------------------
# vertical (column) solvers (kernel tridiag_solve)
# --------------------------------------------------------------------------
def tridiag_solve_plain(a, b, c, d):
    L = d.shape[-2]
    cp = torch.empty(torch.broadcast_shapes(a.shape, d.shape),
                     dtype=d.dtype, device=d.device)
    dp = torch.empty_like(cp)
    cp_prev = dp_prev = torch.zeros_like(cp[..., 0, :])
    for k in range(L):
        a_, b_, c_, d_ = a[..., k, :], b[..., k, :], c[..., k, :], d[..., k, :]
        m = b_ - cp_prev * a_
        cp[..., k, :] = c_ / m
        dp[..., k, :] = (d_ - dp_prev * a_) / m
        cp_prev, dp_prev = cp[..., k, :], dp[..., k, :]
    x = torch.empty_like(dp)
    x_next = torch.zeros_like(dp[..., 0, :])
    for k in range(L - 1, -1, -1):
        x[..., k, :] = dp[..., k, :] - cp[..., k, :] * x_next
        x_next = x[..., k, :]
    return x


def tridiag_solve_work(batch: int, levels: int, n_cols: int,
                       itemsize: int) -> tuple:
    """(bytes, flops) of one call: a, b, c [L, X], d and x [B, L, X]; per
    row the pivot (2 flops) and c / m once, and per right-hand side 3
    flops down and 2 up."""
    nbytes = (3 + 2 * batch) * levels * n_cols * itemsize
    return nbytes, (3 + 5 * batch) * levels * n_cols


def tridiag_solve(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                  d: torch.Tensor) -> torch.Tensor:
    """Thomas algorithm over the level axis: tridiag(a, b, c) x = d.

    a (sub-), b (main), c (super-diagonal) are [L, X] (the plain version
    also broadcasts them batched like d, as the JAX function does; the
    kernel takes [L, X] only); d is [L, X] or [B, L, X].  Rows outside a
    column's active range must be identity rows (a=c=0, b=1, d=0), as the
    caller prepares them.
    """
    if d.device.type == "cpu":
        return tridiag_solve_plain(a, b, c, d)
    kernels.cuda_only(d, "tridiag_solve")
    dev, dt = d.device, d.dtype
    L, X = d.shape[-2:]
    df = d.reshape(-1, L, X).contiguous()
    B = df.shape[0]
    abc = [t.contiguous() for t in (a, b, c)]
    for name, t in zip("abc", abc):
        kernels.require(t, name, (L, X), dt, dev)
    x = torch.empty_like(df)
    kernels.launch("tridiag_solve", dev, abc[0], abc[1], abc[2], df, B, L, X,
                   x, kernels.float_code(dt))
    return x.reshape(d.shape)


def cumsum_bottom_up(x: torch.Tensor) -> torch.Tensor:
    """out[k] = sum_{j>=k} x[j] along axis 0 (ref oce_ale.F90:1789-1799)."""
    return torch.flip(torch.cumsum(torch.flip(x, (0,)), 0), (0,))


# --------------------------------------------------------------------------
# preconditioned conjugate gradient (replaces psolve.c + pARMS)
# --------------------------------------------------------------------------
def node_sum(v: torch.Tensor) -> torch.Tensor:
    """Global sum of a node field: the plain sum on one device; under a
    dist context the owned-masked sum over the ranks (halo copies and pad
    slots are not counted)."""
    if _DIST_CTX is None:
        return v.sum()
    return _DIST_CTX.gsum_nodes(v)


def pcg(operator, rhs: torch.Tensor, precond, x0=None, tol: float = 1e-10,
        maxiter: int = 2000, chunk: int = 4):
    """Preconditioned CG for the SPD SSH operator (ref psolve.c:152-221;
    tolerances oce_ale.F90:2295-2301; SPD as noted at oce_ale.F90:2321).

    ``chunk`` iterations run between two convergence checks, and the host
    reads the residual once per check; once converged, the rest of the
    chunk is masked to no-ops (guarded against 0/0).  The iterations, the
    count and the answer are those of the JAX loop (``ops.py:430-499``).
    Returns (x, iterations, relative residual), all tensors.
    """
    x = torch.zeros_like(rhs) if x0 is None else x0
    r = rhs - operator(x)
    z = precond(r)
    p = z
    rz = node_sum(r * z)
    rr = node_sum(r * r)
    rhs_norm = torch.sqrt(node_sum(rhs * rhs)) + 1e-300
    tol2 = (tol * rhs_norm) ** 2
    it = torch.zeros((), dtype=torch.int64, device=rhs.device)
    while bool((rr > tol2) & (it < maxiter)):
        for _ in range(chunk):
            live = rr > tol2
            Ap = operator(p)
            pAp = node_sum(p * Ap)
            alpha = torch.where(live, rz / torch.where(pAp != 0, pAp, 1.0),
                                0.0)
            x = x + alpha * p
            r = r - alpha * Ap
            z = precond(r)
            rz_new = node_sum(r * z)
            rr = node_sum(r * r)
            beta = torch.where(live, rz_new / torch.where(rz != 0, rz, 1.0),
                               0.0)
            p = torch.where(live, z + beta * p, p)
            rz = torch.where(live, rz_new, rz)
            it = it + live.long()
    return x, it, torch.sqrt(rr) / rhs_norm
