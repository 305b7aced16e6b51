"""Semi-implicit free surface: operator, rhs, solves, hbar update.

The port of ``fesom2_tpu/core/ssh.py``.  The operator (ref
init_stiff_mat_ale, ``src/oce_ale.F90:1088-1354``) is

    A(eta) = eta * areasvol(surface)/dt + g*dt*alpha*theta * D(H * G(eta))

with G the elemental scalar gradient, H the element depth (less the
accumulated perturbation hbar_e under zlevel and zstar) and D the
edge-stencil divergence.  Meshes up to ``model.DENSE_SSH_MAX_NODES`` nodes solve with a
precomputed dense inverse plus one refinement sweep; larger ones with CG
(``ops.pcg``) on the operator in node-ring form (``RingOperator``, kernel
``ring_spmv``; off linfs rebuilt each step from hbar_e by ``RingALE``)
and the two-level block-Schwarz preconditioner (``BlockSchwarz``, kernel
``block_schwarz``).  The host-side builders are numpy and scipy, as in the
JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..constants import g
from .. import kernels
from ..mesh import MeshTables
from .ops import (scalar_gradient, edge_divergence, edge_transport,
                  elem_mean_node, halo_accumulate_nodes, halo_fix_nodes, pcg)
from .state import OceanState, Forcing


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def elem_depth(mesh: MeshTables):
    """zbar_e_bot - zbar_e_srf: negative total unperturbed element depth."""
    return mesh.zbar_e_bot - mesh.zbar[(mesh.ulevels_elem - 1).long()]


def _edge_stencil_flux(field_gx, field_gy, H_el, mesh: MeshTables):
    """Per-edge flux s1+s2 of the SSH stencil (ref :1202-1258 pattern)."""
    et1, et2 = mesh.edge_tri[:, 0], mesh.edge_tri[:, 1]
    has2 = et2 >= 0
    et2s = torch.where(has2, et2, 0)
    dX1, dY1 = mesh.edge_cross_dxdy[:, 0], mesh.edge_cross_dxdy[:, 1]
    dX2, dY2 = mesh.edge_cross_dxdy[:, 2], mesh.edge_cross_dxdy[:, 3]
    s1 = H_el[et1] * (field_gx[et1] * dY1 - field_gy[et1] * dX1)
    s2 = torch.where(
        has2, -H_el[et2s] * (field_gx[et2s] * dY2 - field_gy[et2s] * dX2), 0.0)
    return s1 + s2


def _surface_areasvol(mesh: MeshTables):
    return torch.gather(mesh.areasvol, 0,
                        (mesh.ulevels_node - 1).long()[None, :])[0]


def ale_hbar_e(state: OceanState, mesh: MeshTables) -> torch.Tensor:
    """The accumulated depth perturbation per element, hbar_e: the nodal
    mean of hbar on surface elements, 0 under cavities (ref
    update_stiff_mat_ale, oce_ale.F90:1371-1470)."""
    return torch.where(mesh.ulevels_elem == 1,
                       elem_mean_node(state.hbar, mesh), 0.0)


def ssh_operator(mesh: MeshTables, cfg, hbar_e=None):
    """The matrix-free SPD operator eta -> A(eta); ``hbar_e`` is the depth
    perturbation off linfs (None: static depth)."""
    dt = cfg.dt
    factor = g * dt * cfg.dyn.alpha * cfg.dyn.theta
    H = elem_depth(mesh)
    if hbar_e is not None:
        H = H - hbar_e
    diag_mass = _surface_areasvol(mesh) / dt

    def op(eta):
        gx, gy = scalar_gradient(eta, mesh)
        flux = _edge_stencil_flux(gx, gy, H, mesh)
        return eta * diag_mass + factor * edge_divergence(flux, mesh)

    return op


# --------------------------------------------------------------------------
# host-side assembly (numpy)
# --------------------------------------------------------------------------
def _stencil_arrays(mesh: MeshTables, cfg):
    return (_np(mesh.edges), _np(mesh.edge_tri), _np(mesh.elem_nodes),
            _np(mesh.gradient_sca), _np(mesh.edge_cross_dxdy),
            g * cfg.dt * cfg.dyn.alpha * cfg.dyn.theta)


def _mass_diag(mesh: MeshTables, cfg) -> np.ndarray:
    avn = _np(mesh.areasvol)
    uln0 = _np(mesh.ulevels_node) - 1
    return avn[uln0, np.arange(avn.shape[1])] / cfg.dt


def _elem_depth_np(mesh: MeshTables) -> np.ndarray:
    return _np(mesh.zbar_e_bot) - _np(mesh.zbar)[_np(mesh.ulevels_elem) - 1]


def ssh_sparse_coo(mesh: MeshTables, cfg):
    """The SSH operator as COO triplets (rows, cols, vals, N): the mass
    diagonal first, then the edge stencil (ref :1202-1270)."""
    N = mesh.n_nodes
    edges, etri, en, gsca, ecd, factor = _stencil_arrays(mesh, cfg)
    H = _elem_depth_np(mesh)
    rows, cols, vals = [np.arange(N)], [np.arange(N)], [_mass_diag(mesh, cfg)]
    for i in range(2):
        el = etri[:, i]
        ok = el >= 0
        els = np.where(ok, el, 0)
        dX = ecd[:, 2 * i]
        dY = ecd[:, 2 * i + 1]
        sgn = 1.0 if i == 0 else -1.0
        for k in range(3):
            fy = H[els] * (gsca[els, k] * dY - gsca[els, k + 3] * dX) * sgn
            fy = np.where(ok, fy * factor, 0.0)
            col = en[els, k]
            for j, rsgn in ((0, 1.0), (1, -1.0)):
                rows.append(edges[:, j])
                cols.append(col)
                vals.append(rsgn * fy)
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals), N)


def ssh_dense_matrix(mesh: MeshTables, cfg) -> np.ndarray:
    """The SSH operator as a dense [N, N] numpy matrix (host side)."""
    rows, cols, vals, N = ssh_sparse_coo(mesh, cfg)
    A = np.zeros((N, N))
    np.add.at(A, (rows, cols), vals)
    return A


def ssh_dense_inverse(mesh: MeshTables, cfg, dtype=torch.float64):
    """Dense inverse of the SSH operator, on the mesh's device."""
    A = ssh_dense_matrix(mesh, cfg)
    dead = np.abs(A).sum(1) == 0        # padded rows: identity, then zero
    A[dead, dead] = 1.0
    Ainv = np.linalg.inv(A)
    Ainv[dead, :] = 0.0
    Ainv[:, dead] = 0.0
    return torch.as_tensor(Ainv, device=mesh.zbar.device).to(dtype)


def ssh_matrix_diagonal(mesh: MeshTables, cfg) -> torch.Tensor:
    """Exact diagonal of the assembled operator (host-side numpy, ref
    init_stiff_mat_ale :1202-1270 keeping col == row)."""
    rows, cols, vals, N = ssh_sparse_coo(mesh, cfg)
    diag = np.zeros(N)
    np.add.at(diag, rows, np.where(rows == cols, vals, 0.0))
    return torch.as_tensor(diag, device=mesh.zbar.device).to(mesh.zbar.dtype)


def _csr_operator(mesh: MeshTables, cfg):
    """The operator as scipy CSR, duplicates summed, structural zeros
    dropped, identity on dead (padded) rows."""
    import scipy.sparse as sp
    rows, cols, vals, N = ssh_sparse_coo(mesh, cfg)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(N, N)).tocsr()
    A.sum_duplicates()
    A.eliminate_zeros()
    dead = np.asarray(np.abs(A).sum(1)).ravel() == 0
    if dead.any():
        A = (A + sp.diags(dead.astype(float))).tocsr()
    return A


# --------------------------------------------------------------------------
# ring operator (kernel ring_spmv)
# --------------------------------------------------------------------------
def ring_spmv_plain(cols: torch.Tensor, vals: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    y = torch.zeros_like(x)
    for k in range(cols.shape[0]):                     # fixed slot order
        y = y + vals[k] * x[cols[k]]
    return y


def ring_spmv_work(kr: int, n_nodes: int, itemsize: int) -> tuple:
    """(bytes, flops) of one product: cols and vals [Kr, N], x and y [N];
    a product and an add per entry."""
    return (kr * n_nodes * (4 + itemsize) + 2 * n_nodes * itemsize,
            2 * kr * n_nodes)


# the ring widths with a kernel of their own (csrc/ring_spmv.cu: the zstar
# channels' ALE ring and the level-7 globe's); any other Kr up to
# RING_MAX_SLOTS takes the generic kernel
RING_TEMPLATED = (8, 10)
RING_MAX_SLOTS = 64


def ring_spmv(cols: torch.Tensor, vals: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """y[n] = sum_k vals[k, n] * x[cols[k, n]] over the [Kr, N] ring
    (ref RingOperator.__call__, ssh.py:209-215)."""
    if x.device.type == "cpu":
        return ring_spmv_plain(cols, vals, x)
    kernels.cuda_only(x, "ring_spmv")
    dev, dt = x.device, x.dtype
    Kr, N = cols.shape
    if not 1 <= Kr <= RING_MAX_SLOTS:
        raise ValueError(f"ring_spmv: Kr = {Kr} slots, the kernel takes 1 "
                         f"to {RING_MAX_SLOTS}")
    x = x.contiguous()
    kernels.require(cols, "cols", (Kr, N), torch.int32, dev)
    kernels.require(vals, "vals", (Kr, N), dt, dev)
    kernels.require(x, "x", (N,), dt, dev)
    y = torch.empty_like(x)
    kernels.launch("ring_spmv", dev, cols, vals, x, Kr, N, y,
                   kernels.float_code(dt))
    return y


@dataclass
class RingOperator:
    """The SSH operator in node-ring form: the CSR stencil of
    init_stiff_mat_ale padded to the largest node degree, one packed
    gather per apply."""
    cols: torch.Tensor        # [Kr, N] int32, padding points at n itself
    vals: torch.Tensor        # [Kr, N], padding 0

    def __call__(self, eta: torch.Tensor) -> torch.Tensor:
        return halo_fix_nodes(ring_spmv(self.cols, self.vals, eta))


def build_ssh_ring(mesh: MeshTables, cfg,
                   dtype=torch.float64) -> RingOperator:
    """Assemble the static (linfs) SSH stencil into ring form (host numpy);
    zlevel and zstar take ``build_ssh_ring_ale``."""
    A = _csr_operator(mesh, cfg)
    N = A.shape[0]
    deg = np.diff(A.indptr)
    Kr = int(deg.max())
    row = np.repeat(np.arange(N), deg)
    slot = np.arange(A.nnz) - A.indptr[row]
    ring_cols = np.tile(np.arange(N), (Kr, 1))
    ring_vals = np.zeros((Kr, N))
    ring_cols[slot, row] = A.indices
    ring_vals[slot, row] = A.data
    dev = mesh.zbar.device
    return RingOperator(torch.as_tensor(ring_cols.astype(np.int32), device=dev),
                        torch.as_tensor(ring_vals, device=dev).to(dtype))


def ssh_sparse_coo_elems(mesh: MeshTables, cfg):
    """COO triplets of the SSH stencil with the element depth factored
    out: entry value = coef * H[elem] (host numpy).  Returns (rows, cols,
    elems, coefs, mass_diag, N); A(hbar) = diag(mass) + sum_i coef_i *
    (H0 - hbar_e)[elem_i] at (row_i, col_i), the reference's per-step
    value update (update_stiff_mat_ale, oce_ale.F90:1371-1470)."""
    N = mesh.n_nodes
    edges, etri, en, gsca, ecd, factor = _stencil_arrays(mesh, cfg)
    rows, cols, elems, coefs = [], [], [], []
    for i in range(2):
        el = etri[:, i]
        ok = el >= 0
        els = np.where(ok, el, 0)
        dX = ecd[:, 2 * i]
        dY = ecd[:, 2 * i + 1]
        sgn = 1.0 if i == 0 else -1.0
        for k in range(3):
            cf = (gsca[els, k] * dY - gsca[els, k + 3] * dX) * sgn * factor
            cf = np.where(ok, cf, 0.0)
            col = en[els, k]
            for j, rsgn in ((0, 1.0), (1, -1.0)):
                rows.append(edges[:, j])
                cols.append(col)
                elems.append(els)
                coefs.append(rsgn * cf)
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(elems), np.concatenate(coefs),
            _mass_diag(mesh, cfg), N)


@dataclass
class RingALE:
    """The zlevel and zstar SSH operator in ring form: the ring values are affine in
    hbar_e, vals(hbar_e) = vals0 - sum_c e_coef[c] * hbar_e[e_ids[c]].
    ``materialize`` rebuilds them once per step (plain torch); the CG
    iterations then apply the result through ``ring_spmv``."""
    cols: torch.Tensor        # [Kr, N] int32, padding points at n itself
    vals0: torch.Tensor       # [Kr, N] the operator at hbar_e = 0
    e_ids: torch.Tensor       # [C, Kr, N] int32 element ids, padding 0
    e_coef: torch.Tensor      # [C, Kr, N], padding 0

    def materialize(self, hbar_e: torch.Tensor) -> RingOperator:
        corr = (hbar_e[self.e_ids] * self.e_coef).sum(0)
        return RingOperator(self.cols, self.vals0 - corr)


def build_ssh_ring_ale(mesh: MeshTables, cfg, dtype=torch.float64) -> RingALE:
    """Assemble the ALE ring operator (host-side, vectorized numpy)."""
    rows, cols, elems, coefs, mass_diag, N = ssh_sparse_coo_elems(mesh, cfg)
    H0 = _elem_depth_np(mesh)

    # the (element-independent) mass diagonal as coef-0 entries
    diag_rows = np.arange(N)
    rows = np.concatenate([diag_rows, rows])
    cols = np.concatenate([diag_rows, cols])
    elems = np.concatenate([np.zeros(N, np.int64), elems])
    coefs = np.concatenate([np.zeros(N), coefs])
    base = np.concatenate([mass_diag, np.zeros(len(coefs) - N)])

    # group by (row, col): sort once, then rank entries within each group
    key = rows.astype(np.int64) * N + cols.astype(np.int64)
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uk, inv_first = np.unique(key_s, return_index=True)
    slot_of_entry = np.searchsorted(uk, key_s)
    rank = np.arange(len(key_s)) - inv_first[slot_of_entry]
    C = int(rank.max()) + 1

    urow = (uk // N).astype(np.int64)
    ucol = (uk % N).astype(np.int64)
    uslot = np.arange(len(uk)) - np.searchsorted(urow, urow)
    Kr = int(uslot.max()) + 1

    ring_cols = np.tile(np.arange(N), (Kr, 1))
    vals0 = np.zeros((Kr, N))
    e_ids = np.zeros((C, Kr, N), np.int64)
    e_coef = np.zeros((C, Kr, N))

    ring_cols[uslot, urow] = ucol
    vals0[uslot, urow] = np.bincount(
        slot_of_entry, weights=(base + coefs * H0[elems])[order],
        minlength=len(uk))
    er, es, ec = urow[slot_of_entry], uslot[slot_of_entry], rank
    cf = coefs[order]
    nz = cf != 0.0
    e_ids[ec[nz], es[nz], er[nz]] = elems[order][nz]
    e_coef[ec[nz], es[nz], er[nz]] = cf[nz]

    dead = np.abs(vals0).sum(0) + np.abs(e_coef).sum((0, 1)) == 0
    vals0[0, dead] = 1.0                                # dead rows: identity
    dev = mesh.zbar.device
    i32 = lambda a: torch.as_tensor(a.astype(np.int32), device=dev)
    f = lambda a: torch.as_tensor(a, device=dev).to(dtype)
    return RingALE(i32(ring_cols), f(vals0), i32(e_ids), f(e_coef))


# --------------------------------------------------------------------------
# block-Schwarz preconditioner (kernel block_schwarz)
# --------------------------------------------------------------------------
@dataclass
class BlockSchwarz:
    """Two-level additive Schwarz preconditioner: overlapping node blocks
    with dense inverses, plus a coarse solve over the non-overlapping
    partition (the counterpart of the reference's pARMS RAS, psolve.c:
    77-100; symmetric, so CG stays valid).  ``packed`` (not a field: the
    fields are the JAX package's tables) holds the kernel's layout of the
    same inverses, ``pack_block_schwarz(self)``; the wrapper makes it at
    the first CUDA apply where no one set it."""
    block_ids: torch.Tensor        # [nb, K] int32 node ids, -1 padding
    inv_blocks: torch.Tensor       # [nb, K, K]
    node_slots: torch.Tensor       # [N, S] int32 flat b*K+p, padding 0
    node_slot_valid: torch.Tensor  # [N, S] bool
    coarse_ids: torch.Tensor       # [nb, Kc] int32 own nodes, -1 padding
    coarse_inv: torch.Tensor       # [nb, nb] dense A0^-1
    coarse_part: torch.Tensor      # [N] int32 block of each node

    packed = None                  # PackedSchwarz or None
    checked = None                 # the tables the wrapper last checked

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        # a rank's boundary blocks write partial sums at halo slots: they
        # go to their owners (the identity on one device)
        return halo_accumulate_nodes(block_schwarz(self, r))


# the packed layout's row stride is n_b rounded up to this many elements
# (16-byte rows in float32 and float64: csrc/block_schwarz.cu's kAlign); a
# tile holds at most SCHWARZ_TILE_ROWS rows and SCHWARZ_TILE_BYTES bytes
# (one bulk copy into shared memory, at least one row), and a CUDA block
# takes at most SHARED_BYTES of shared memory (H100: 227 KB)
SCHWARZ_ALIGN = 4
SCHWARZ_TILE_ROWS = 24
SCHWARZ_TILE_BYTES = 96 * 1024
SHARED_BYTES = 232448


@dataclass
class PackedSchwarz:
    """A BlockSchwarz's block inverses as the ``block_schwarz`` kernel
    streams them: block b's own n_b x n_b entries, each row padded with
    zeros to a stride of n_b rounded up to ``SCHWARZ_ALIGN`` elements,
    block after block from ``inv_off[b]``.  n_b is the block's extent: its
    last node or node slot, so no padded row or column of ``inv_blocks``
    is kept.  The rows of all blocks, in order, index the kernel's
    per-row scratch: block b's rows are ``row_off[b]`` to ``row_off[b +
    1]``, ``ids`` names each row's node and ``node_slots`` each node's rows.
    Each block's rows are cut into tiles of at most ``SCHWARZ_TILE_ROWS``,
    as even as the block allows; an empty block has one tile of no rows
    (its coarse sum).  Every block's first tile comes before any block's
    second: the first tiles form the coarse residual, counted on
    ``counter[0]``, and once all have, the CUDA blocks take the coarse
    level's rows in chunks, counted on ``counter[1]`` (both 0 between
    applies)."""
    inv: torch.Tensor         # [sum n_b * stride_b] the blocks' inverses
    inv_off: torch.Tensor     # [nb] int64 first entry of block b
    row_off: torch.Tensor     # [nb + 1] int32 first row of block b
    ids: torch.Tensor         # [n_rows] int32 node of each row, -1 none
    node_slots: torch.Tensor  # [N, S] int32 a node's rows, -1 none
    tiles: torch.Tensor       # [n_tiles, 3] int32 (block, first row, rows)
    counter: torch.Tensor     # [2] int32 the kernel's two counters
    width: int                # K of the padded tables
    max_rows: int             # max n_b
    max_tile: int             # max rows * stride of a tile (entries)


def schwarz_extents(block_ids: np.ndarray, node_slots: np.ndarray,
                    node_valid: np.ndarray) -> np.ndarray:
    """n_b [nb] of the padded tables: 1 + the last position of block b
    that holds a node or that a valid node slot names."""
    nb, K = block_ids.shape
    ext = np.where(block_ids >= 0, np.arange(1, K + 1), 0).max(1) \
        if K else np.zeros(nb, np.int64)
    sb, pb = np.divmod(node_slots[node_valid].astype(np.int64), K)
    np.maximum.at(ext, sb, pb + 1)
    return ext.astype(np.int64)


def schwarz_stride(sizes) -> np.ndarray:
    """The packed row stride of blocks of ``sizes`` n_b."""
    n = np.asarray(sizes, np.int64)
    return -(-n // SCHWARZ_ALIGN) * SCHWARZ_ALIGN


def schwarz_tiles(sizes, itemsize: int,
                  tile_rows: int = SCHWARZ_TILE_ROWS) -> np.ndarray:
    """[n_tiles, 3] (block, first row, rows): block b's rows cut into k =
    ceil(n_b / m) tiles (at least one), m the rows of at most
    ``tile_rows`` and SCHWARZ_TILE_BYTES (at least one), the first n_b % k
    of them one row longer; every block's first tile first, then the
    others in block order."""
    out = []
    for b, (n, st) in enumerate(zip(np.asarray(sizes, np.int64),
                                    schwarz_stride(sizes))):
        m = min(tile_rows, max(1, SCHWARZ_TILE_BYTES // max(
            int(st) * itemsize, 1)))
        k = max(1, -(-int(n) // m))
        rows = [n // k + (i < n % k) for i in range(k)]
        first = np.concatenate([[0], np.cumsum(rows)[:-1]])
        out += [(b, int(f), int(r)) for f, r in zip(first, rows)]
    out = np.asarray(out, np.int64).reshape(-1, 3)
    return out[np.argsort(out[:, 1] > 0, kind="stable")].astype(np.int32)


def pack_block_schwarz(pc: BlockSchwarz,
                       tile_rows: int = SCHWARZ_TILE_ROWS) -> PackedSchwarz:
    """The kernel's layout of ``pc``'s inverses and tables, on their
    device (a copy bit for bit: ``unpack_block_schwarz`` gives the padded
    tables back); tiles of at most ``tile_rows`` rows.  Raises where a
    block's residual and one row of its inverse exceed a CUDA block's
    shared memory (n_b above about 14,500 in float64)."""
    ids = _np(pc.block_ids).astype(np.int64)
    slots, valid = _np(pc.node_slots).astype(np.int64), _np(pc.node_slot_valid)
    nb, K = ids.shape
    if valid.any() and not (0 <= slots[valid].min()
                            and slots[valid].max() < nb * K):
        raise ValueError("block_schwarz: a node slot outside the blocks")
    n = schwarz_extents(ids, slots, valid)
    stride = schwarz_stride(n)
    size = n * stride
    itemsize = pc.inv_blocks.element_size()
    tiles = schwarz_tiles(n, itemsize, tile_rows)
    max_tile = int((tiles[:, 2] * stride[tiles[:, 0]]).max()) if nb else 0
    if 16 + (int(stride.max(initial=0)) + max_tile) * itemsize \
            > SHARED_BYTES:
        raise ValueError(f"block_schwarz: blocks of {int(n.max())} nodes "
                         f"exceed a CUDA block's shared memory")
    inv_off = np.concatenate([[0], np.cumsum(size)[:-1]]).astype(np.int64)
    row_off = np.concatenate([[0], np.cumsum(n)]).astype(np.int64)
    dev = pc.inv_blocks.device
    inv = torch.zeros(int(size.sum()), dtype=pc.inv_blocks.dtype, device=dev)
    for b in range(nb):
        if n[b]:
            inv[inv_off[b]:inv_off[b] + size[b]].view(
                int(n[b]), int(stride[b]))[:, :n[b]] = \
                pc.inv_blocks[b, :n[b], :n[b]]
    sb, pb = np.divmod(slots, max(K, 1))
    packed_slots = np.where(valid, row_off[sb] + pb, -1)
    flat_ids = np.concatenate([ids[b, :n[b]] for b in range(nb)]) \
        if nb else np.zeros(0, np.int64)
    i32 = lambda a: torch.as_tensor(np.asarray(a).astype(np.int32),
                                    device=dev)
    return PackedSchwarz(
        inv, torch.as_tensor(inv_off, device=dev), i32(row_off),
        i32(flat_ids), i32(packed_slots), i32(tiles), i32([0, 0]), K,
        int(n.max()) if nb else 0, max_tile)


def unpack_block_schwarz(pk: PackedSchwarz) -> tuple:
    """(block_ids, inv_blocks, node_slots, node_slot_valid) in the padded
    layout from the packed one: an identity on the rows past each block's
    extent, 0 for the slot of no row."""
    K = pk.width
    row_off = _np(pk.row_off).astype(np.int64)
    inv_off = _np(pk.inv_off)
    nb = len(row_off) - 1
    n = np.diff(row_off)
    stride = schwarz_stride(n)
    dev = pk.inv.device
    inv = torch.eye(K, dtype=pk.inv.dtype, device=dev).repeat(nb, 1, 1)
    ids = np.full((nb, K), -1, np.int64)
    flat_ids = _np(pk.ids)
    for b in range(nb):
        inv[b, :n[b], :n[b]] = pk.inv[inv_off[b]:inv_off[b] + n[b]
                                      * stride[b]].view(
            int(n[b]), int(stride[b]))[:, :n[b]]
        ids[b, :n[b]] = flat_ids[row_off[b]:row_off[b + 1]]
    rows = _np(pk.node_slots).astype(np.int64)
    valid = rows >= 0
    blk = np.searchsorted(row_off, np.where(valid, rows, 0), side="right") - 1
    slots = np.where(valid, blk * K + rows - row_off[np.maximum(blk, 0)], 0)
    i32 = lambda a: torch.as_tensor(a.astype(np.int32), device=dev)
    return (i32(ids), inv, i32(slots), torch.as_tensor(valid, device=dev))


def _masked_take(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return torch.where(ids >= 0, x[ids.clamp_min(0)], 0.0)


def block_schwarz_plain(pc: BlockSchwarz, r: torch.Tensor) -> torch.Tensor:
    rb = _masked_take(r, pc.block_ids)                          # [nb, K]
    yb = torch.bmm(pc.inv_blocks, rb[..., None])[..., 0]
    contrib = torch.where(pc.node_slot_valid,
                          yb.reshape(-1)[pc.node_slots], 0.0)  # [N, S]
    r0 = _masked_take(r, pc.coarse_ids).sum(-1)                 # [nb]
    y0 = pc.coarse_inv @ r0
    # a coarse_part of -1 (the rank-local preconditioner of
    # build_block_schwarz_local has no coarse level) adds nothing
    return contrib.sum(-1) + _masked_take(y0, pc.coarse_part)


def block_schwarz_work(n_nodes: int, nb: int, k: int, slots: int, kc: int,
                       itemsize: int) -> tuple:
    """(bytes, flops) of one apply on the padded tables: r and y [N], the
    [nb, K, K] inverses and [nb, nb] coarse inverse, the index tables
    (block_ids [nb, K], node_slots [N, S] with its bool mask, coarse_ids
    [nb, Kc], coarse_part [N]); the dense products and the two gather
    sums."""
    nbytes = ((2 * n_nodes + nb * k * k + nb * nb) * itemsize
              + 4 * (nb * k + n_nodes * slots + nb * kc + n_nodes)
              + n_nodes * slots)
    return nbytes, 2 * nb * k * k + 2 * nb * nb + n_nodes * slots + nb * kc


def block_schwarz_packed_work(n_nodes: int, sizes, slots: int, kc: int,
                              itemsize: int) -> tuple:
    """(bytes, flops) of one apply on the packed layout, blocks of
    ``sizes`` n_b: r and y [N], each block's n_b rows at the aligned
    stride, the [nb, nb] coarse inverse, the index tables (ids [sum n_b],
    node_slots [N, S], coarse_ids [nb, Kc], coarse_part [N], row_off [nb +
    1], inv_off [nb] int64, tiles [n_tiles, 3]); the products over the
    blocks' own entries and the two gather sums."""
    n = np.asarray(sizes, np.int64)
    nb = len(n)
    stride = schwarz_stride(n)
    n_tiles = len(schwarz_tiles(n, itemsize))
    nbytes = ((2 * n_nodes + int((n * stride).sum()) + nb * nb) * itemsize
              + 4 * (int(n.sum()) + n_nodes * slots + nb * kc + n_nodes
                     + nb + 1 + 3 * n_tiles) + 8 * nb)
    return nbytes, (2 * int((n * n).sum()) + 2 * nb * nb + n_nodes * slots
                    + nb * kc)


def block_schwarz(pc: BlockSchwarz, r: torch.Tensor) -> torch.Tensor:
    """Apply the preconditioner to a node field r [N] (ref
    BlockSchwarz.__call__, ssh.py:429-454): the plain version on the CPU,
    the kernel on the packed layout on the card."""
    if r.device.type == "cpu":
        return block_schwarz_plain(pc, r)
    kernels.cuda_only(r, "block_schwarz")
    if pc.packed is None:
        pc.packed = pack_block_schwarz(pc)
    return _block_schwarz_launch(pc, pc.packed, r)


def _block_schwarz_launch(pc: BlockSchwarz, pk: PackedSchwarz,
                          r: torch.Tensor) -> torch.Tensor:
    dev, dt = r.device, r.dtype
    r = r.contiguous()
    N = r.shape[0]
    kernels.require(r, "r", (N,), dt, dev)
    nb, Kc = pc.coarse_ids.shape
    S = pk.node_slots.shape[1]
    n_rows, n_tiles = pk.ids.shape[0], pk.tiles.shape[0]
    # the tables, once for each packed form (held, so not another at the
    # same address) and each device, dtype and N: a model's step applies
    # one pair some 27 times
    if pc.checked is None or pc.checked[0] is not pk \
            or pc.checked[1:] != (dev, dt, N):
        i32 = torch.int32
        kernels.require(pk.tiles, "tiles", (n_tiles, 3), i32, dev)
        kernels.require(pk.row_off, "row_off", (nb + 1,), i32, dev)
        kernels.require(pk.inv_off, "inv_off", (nb,), torch.int64, dev)
        kernels.require(pk.ids, "ids", (n_rows,), i32, dev)
        kernels.require(pk.inv, "inv", tuple(pk.inv.shape), dt, dev)
        kernels.require(pk.node_slots, "node_slots", (N, S), i32, dev)
        kernels.require(pk.counter, "counter", (2,), i32, dev)
        kernels.require(pc.coarse_ids, "coarse_ids", (nb, Kc), i32, dev)
        kernels.require(pc.coarse_inv, "coarse_inv", (nb, nb), dt, dev)
        kernels.require(pc.coarse_part, "coarse_part", (N,), i32, dev)
        if pk.inv.dim() != 1 or pk.inv.data_ptr() % 16:
            raise ValueError("block_schwarz: the packed inverses must be "
                             "one 16-byte aligned row of entries")
        pc.checked = (pk, dev, dt, N)
    yb = torch.empty(n_rows, dtype=dt, device=dev)
    r0 = torch.empty(nb, dtype=dt, device=dev)
    y0 = torch.empty(nb, dtype=dt, device=dev)
    y = torch.empty_like(r)
    kernels.launch("block_schwarz", dev, r, N, pk.tiles, n_tiles, pk.row_off,
                   pk.inv_off, pk.ids, pk.inv, nb, pk.max_rows, pk.max_tile,
                   pk.node_slots, S, pc.coarse_ids, Kc, pc.coarse_inv,
                   pc.coarse_part, pk.counter, yb, n_rows, r0, y0, y,
                   kernels.float_code(dt))
    return y


def build_block_schwarz(mesh: MeshTables, cfg, block_size: int = 256,
                        dtype=torch.float64) -> BlockSchwarz:
    """Build the preconditioner (host numpy): compact geometric blocks of
    about ``block_size`` nodes from recursive coordinate bisection, each
    extended by its 1-ring overlap and inverted densely, scaled for a
    partition of unity; the coarse level aggregates over the
    non-overlapping blocks.  The same algorithm as the JAX builder, so the
    tables come out identical."""
    import scipy.sparse as sp
    from ..parallel.partition import _partition_numpy, _sphere_xyz

    A = _csr_operator(mesh, cfg)
    N = A.shape[0]
    nparts = max(1, int(round(N / block_size)))
    part = np.asarray(_partition_numpy(_sphere_xyz(mesh), np.ones(N), nparts))
    nb = int(part.max()) + 1

    # block node lists + 1-ring overlap from the matrix graph
    indptr, indices = A.indptr, A.indices
    blocks = []
    for b in range(nb):
        own = np.nonzero(part == b)[0]
        if own.size == 0:
            blocks.append(own)
            continue
        ring = np.unique(indices[np.concatenate(
            [np.arange(indptr[i], indptr[i + 1]) for i in own])])
        blocks.append(np.unique(np.concatenate([own, ring])))
    K = max(1, max(len(b) for b in blocks))

    block_ids = np.full((nb, K), -1, np.int64)
    inv_blocks = np.zeros((nb, K, K))
    for b, ids in enumerate(blocks):
        n = len(ids)
        if n == 0:
            inv_blocks[b] = np.eye(K)
            continue
        block_ids[b, :n] = ids
        inv_blocks[b, :n, :n] = np.linalg.inv(A[np.ix_(ids, ids)].toarray())
        if n < K:
            inv_blocks[b, n:, n:] = np.eye(K - n)

    # node -> (block, position) membership for the gather-based combine
    memb = [[] for _ in range(N)]
    for b, ids in enumerate(blocks):
        for p, nid in enumerate(ids):
            memb[nid].append(b * K + p)
    S = max(1, max(len(m) for m in memb))
    node_slots = np.zeros((N, S), np.int64)
    node_valid = np.zeros((N, S), bool)
    for nid, m in enumerate(memb):
        node_slots[nid, :len(m)] = m
        node_valid[nid, :len(m)] = True

    # partition-of-unity scaling, symmetric: 1/sqrt(overlap count)
    wsqrt = 1.0 / np.sqrt(np.maximum(node_valid.sum(-1).astype(float), 1.0))
    for b, ids in enumerate(blocks):
        n = len(ids)
        if n:
            w = wsqrt[ids]
            inv_blocks[b, :n, :n] = w[:, None] * inv_blocks[b, :n, :n] \
                * w[None, :]

    # coarse level: piecewise-constant aggregation, A0 = R0 A R0^T
    Kc = max(1, int(np.bincount(part, minlength=nb).max()))
    coarse_ids = np.full((nb, Kc), -1, np.int64)
    for b in range(nb):
        own = np.nonzero(part == b)[0]
        coarse_ids[b, :len(own)] = own
    R0 = sp.coo_matrix((np.ones(N), (part, np.arange(N))),
                       shape=(nb, N)).tocsr()
    A0 = (R0 @ A @ R0.T).toarray()
    empty = np.bincount(part, minlength=nb) == 0
    if empty.any():
        A0[empty] = 0.0
        A0[:, empty] = 0.0
        A0[empty, empty] = 1.0
    coarse_inv = np.linalg.inv(A0)

    dev = mesh.zbar.device
    i32 = lambda a: torch.as_tensor(np.asarray(a).astype(np.int32), device=dev)
    f = lambda a: torch.as_tensor(a, device=dev).to(dtype)
    return BlockSchwarz(i32(block_ids), f(inv_blocks), i32(node_slots),
                        torch.as_tensor(node_valid, device=dev),
                        i32(coarse_ids), f(coarse_inv), i32(part))


def build_block_schwarz_local(mesh: MeshTables, cfg, S: int,
                              node_l2g: np.ndarray, node_g2l: np.ndarray,
                              n_own: int, n_loc: int,
                              block_size: int = 256) -> dict:
    """The per-rank block-Schwarz preconditioner on the [owned | halo]
    numbering of ``parallel/dist.py``, stacked [S, ...] as numpy
    (``fesom2_tpu/core/ssh.py:559-652``; the pARMS-RAS role of the
    parallel solve, psolve.c:16-115).  Each rank's owned nodes are cut
    into blocks of about ``block_size`` by coordinate bisection, each block
    is extended by its matrix 1-ring (inside owned + halo by the layout's
    closure) and inverted densely; the blocks are weighted by the global
    partition of unity (overlap counts over every rank's blocks), so the
    sum over the ranks is a symmetric additive Schwarz preconditioner and
    CG stays valid.  No coarse level.  A rank applies its blocks with the
    ``block_schwarz`` kernel (``rank_model`` turns the tables into a
    BlockSchwarz whose coarse level adds nothing) and hands the partial
    sums at halo slots to their owners (``halo_accumulate_nodes``).
    Returns dict(block_ids [S, nb, K], inv_blocks [S, nb, K, K],
    node_slots [S, n_loc, R], node_slot_valid [S, n_loc, R])."""
    from ..parallel.partition import _partition_numpy, _sphere_xyz

    A = _csr_operator(mesh, cfg)
    N = A.shape[0]
    indptr, indices = A.indptr, A.indices
    xyz = _sphere_xyz(mesh)

    shard_blocks = []
    for s in range(S):
        own = node_l2g[s, :n_own]
        own = own[own >= 0]
        nparts = max(1, int(round(len(own) / block_size)))
        p = np.asarray(_partition_numpy(xyz[own], np.ones(len(own)), nparts))
        blocks = []
        for b in range(int(p.max()) + 1):
            ids = own[p == b]
            if ids.size == 0:
                continue
            ring = np.unique(indices[np.concatenate(
                [np.arange(indptr[i], indptr[i + 1]) for i in ids])])
            blocks.append(np.unique(np.concatenate([ids, ring])))
        shard_blocks.append(blocks)

    counts = np.zeros(N)
    for blocks in shard_blocks:
        for ids in blocks:
            counts[ids] += 1
    wsqrt = 1.0 / np.sqrt(np.maximum(counts, 1.0))

    nb = max(len(b) for b in shard_blocks)
    K = max(1, max((len(ids) for blocks in shard_blocks for ids in blocks),
                   default=1))
    bi = np.full((S, nb, K), -1, np.int64)
    inv = np.zeros((S, nb, K, K))
    memb = [[[] for _ in range(n_loc)] for _ in range(S)]
    for s in range(S):
        g2l = node_g2l[s]
        for b, ids in enumerate(shard_blocks[s]):
            loc = g2l[ids]
            if (loc < 0).any():
                raise AssertionError(
                    "block 1-ring escaped the shard halo closure")
            n = len(ids)
            bi[s, b, :n] = loc
            w = wsqrt[ids]
            Abinv = np.linalg.inv(A[np.ix_(ids, ids)].toarray())
            inv[s, b, :n, :n] = w[:, None] * Abinv * w[None, :]
            if n < K:
                inv[s, b, n:, n:] = np.eye(K - n)
            for pth, l in enumerate(loc):
                memb[s][l].append(b * K + pth)
        for b in range(len(shard_blocks[s]), nb):
            inv[s, b] = np.eye(K)
    R = max(1, max(len(m) for sm in memb for m in sm))
    node_slots = np.zeros((S, n_loc, R), np.int64)
    node_valid = np.zeros((S, n_loc, R), bool)
    for s in range(S):
        for nid, m in enumerate(memb[s]):
            node_slots[s, nid, :len(m)] = m
            node_valid[s, nid, :len(m)] = True
    return dict(block_ids=bi, inv_blocks=inv, node_slots=node_slots,
                node_slot_valid=node_valid)


# --------------------------------------------------------------------------
# rhs, solves, hbar
# --------------------------------------------------------------------------
def compute_ssh_rhs(state: OceanState, mesh: MeshTables, cfg, forcing: Forcing,
                    u_rhs, v_rhs):
    """ssh_rhs = -alpha*div(int (u+du) dz) + (1-alpha)*ssh_rhs_old, less
    alpha*water_flux*area off linfs (ref compute_ssh_rhs_ale :1478)."""
    alpha = cfg.dyn.alpha
    he = torch.where(mesh.elem_layer_mask, state.helem, 0.0)
    c = alpha * edge_transport((state.u + u_rhs) * he,
                               (state.v + v_rhs) * he, mesh).sum(0)
    rhs = edge_divergence(c, mesh)
    if cfg.ale.which_ALE != "linfs":
        rhs = rhs - alpha * forcing.water_flux * _surface_areasvol(mesh)
    return rhs + (1.0 - alpha) * state.ssh_rhs_old


def _state_operator(state: OceanState, mesh: MeshTables, cfg):
    if cfg.ale.which_ALE == "linfs":
        return ssh_operator(mesh, cfg)
    return ssh_operator(mesh, cfg, hbar_e=ale_hbar_e(state, mesh))


def solve_ssh_dense(state: OceanState, mesh: MeshTables, cfg, dense_inv, rhs,
                    n_refine: int = 1):
    """d_eta = A^-1 rhs by a product with the dense inverse plus
    ``n_refine`` sweeps of iterative refinement against the operator (the
    hbar-corrected one off linfs: the stored inverse is of the
    unperturbed operator, and |hbar_e|/H ~ 1e-4 lets 1-2 sweeps converge).
    Returns (d_eta, number of products); ``ssh_relative_residual`` gives
    the residual apart for callers that ask."""
    op = _state_operator(state, mesh, cfg)
    x = dense_inv @ rhs
    for _ in range(n_refine):
        x = x + dense_inv @ (rhs - op(x))
    return x, 1 + n_refine


def ssh_relative_residual(mesh: MeshTables, cfg, d_eta, rhs,
                          hbar_e=None) -> torch.Tensor:
    """|rhs - A d_eta| / |rhs| for the SSH operator."""
    r = rhs - ssh_operator(mesh, cfg, hbar_e)(d_eta)
    return torch.linalg.norm(r) / (torch.linalg.norm(rhs) + 1e-300)


def solve_ssh(state: OceanState, mesh: MeshTables, cfg, precond, rhs, ring,
              x0=None):
    """CG solve for d_eta (replaces psolve; tolerances oce_ale.F90:2296-
    2301): ``ring`` is a RingOperator (linfs) or a RingALE (zlevel, zstar;
    its values rebuilt here from hbar_e), or None for the matrix-free
    operator; ``precond`` the BlockSchwarz or any r -> M r.  The
    reference's soltol=1e-10 assumes f64; the tolerance is 2e-5 in f32.
    Returns (d_eta, iterations, relative residual)."""
    if ring is None:
        op = _state_operator(state, mesh, cfg)
    elif isinstance(ring, RingALE):
        op = ring.materialize(ale_hbar_e(state, mesh))
    else:
        op = ring
    tol = 1e-10 if rhs.dtype == torch.float64 else 2e-5
    return pcg(op, rhs, precond, x0=x0, tol=tol, maxiter=2000)


def compute_hbar(state: OceanState, mesh: MeshTables, cfg,
                 forcing: Forcing) -> OceanState:
    """hbar(n+1/2) update (ref compute_hbar_ale :1585-1676)."""
    he = torch.where(mesh.elem_layer_mask, state.helem, 0.0)
    c = edge_transport(state.u * he, state.v * he, mesh).sum(0)
    rhs_old = edge_divergence(c, mesh)
    av_srf = _surface_areasvol(mesh)
    if cfg.ale.which_ALE != "linfs":
        rhs_old = rhs_old - forcing.water_flux * av_srf
    hbar = state.hbar + rhs_old * cfg.dt / torch.where(av_srf > 0, av_srf, 1.0)
    return replace(state, hbar=hbar, hbar_old=state.hbar, ssh_rhs_old=rhs_old)
