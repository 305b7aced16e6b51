"""What the card-only gather kernels compute, held on the CPU.

The CUDA kernels cannot run here, so these tests hold their arithmetic and
the tables they walk:

* ``onehot_gather`` runs the one-hot product on the tensor cores with each
  float32 value split into three bf16 pieces.  A torch emulation of that
  product (``gather_cost_model.onehot_gather_emulation``: bf16 casts, one
  float32 accumulator per piece, ``(hi + mid) + lo``) equals
  ``window_gather_plain`` bit for bit on values from 1e-30 to the largest
  float32, negative ones and indices outside the window; what differs by
  design (``-0.0``, values under 2^-109) is pinned down too.
* ``node_edge_reduce`` walks the static ``edge_slot`` table (a word per
  slot: edge and sign).  ``cluster.edge_reduce_emulation`` equals, bit for
  bit, the plain version's signed terms summed in slot order (the order of
  the kernel and of the first design's kernel) and the plain version itself,
  which sums its slots in that order too (``ops.slot_order_sum``); on the channel
  and the level-3 globe, ``KE`` as it is and padded with two empty slots,
  for one row and for ``[2, nl, Ed]``.
* the globe's curve numbering is the subdivision numbering's mesh under a
  permutation, and it is local: per 256-node tile of the level-5 globe the
  distinct edges fall by 1.5x and their 32-byte sectors by 2x.
"""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from fesom2_tpu_torch import kernels
from fesom2_tpu_torch.core import ops, ssh
from fesom2_tpu_torch.config import ModelConfig
from fesom2_tpu_torch.mesh import build_mesh, build_mesh_from_raw, cluster
from fesom2_tpu_torch.mesh import globe
from fesom2_tpu_torch.mesh.channel import channel_raw_mesh
from fesom2_tpu_torch.scripts import gather_cost_model as probe

PC = dict(force_rotation=True, cyclic_length_deg=360.0,
          use_partial_cell=True)


# --------------------------------------------------------------------------
# onehot_gather: the three-piece split product
# --------------------------------------------------------------------------
def _split_inputs():
    """vals [6, 64, 8] float32 with tiles of ordinary, huge (1e30), tiny
    (1e-30) and 2^-100 values, the largest finite float32 of both signs and
    exact powers of two; idx [6, 32] with three indices outside [0, W)."""
    rng = np.random.default_rng(5)
    G, W, T, NL = 6, 64, 32, 8
    v = rng.standard_normal((G, W, NL)).astype(np.float32)
    v[1] *= np.float32(1e30)
    v[2] *= np.float32(1e-30)
    v[3] *= np.float32(2.0 ** -100)
    top = np.finfo(np.float32).max
    v[4, :, 0], v[4, :, 1] = top, -top
    v[4, :, 2] = np.float32(2.0) ** rng.integers(-100, 100, W)
    v[5] = np.abs(v[5]) * np.float32(-3.0)
    idx = rng.integers(0, W, (G, T)).astype(np.int32)
    idx[0, 0], idx[3, 7], idx[5, 31] = W, 1000, -70
    return torch.as_tensor(v), torch.as_tensor(idx)


def test_split_pieces_are_bf16_and_add_up():
    v, _ = _split_inputs()
    hi, mid, lo = probe.split_bf16x3(v)
    for piece in (hi, mid, lo):
        assert torch.equal(piece.to(torch.bfloat16).float(), piece)
        assert torch.isfinite(piece).all()
    assert torch.equal((hi + mid) + lo, v)
    assert probe.SPLIT_PIECES == 3


def test_split_product_equals_the_gather_bitwise():
    v, idx = _split_inputs()
    got = probe.onehot_gather_emulation(v, idx)
    want = probe.window_gather_plain(v, idx)
    assert int(want.isnan().any(-1).sum()) == 3
    assert torch.equal(got.isnan(), want.isnan())
    keep = ~want.isnan()
    assert torch.equal(got.view(torch.int32)[keep],
                       want.view(torch.int32)[keep])
    # and the float32 product form the wrapper runs on the CPU
    prod = probe.onehot_gather_plain(v, idx)
    assert torch.equal(prod.nan_to_num(), want.nan_to_num())


def test_split_product_corner_cases():
    """-0.0 comes out of a product as +0.0 (the gather keeps the sign); a
    value under 2^-109 loses what lies under bf16's smallest subnormal,
    2^-133; an infinity turns its column of the tile to NaN."""
    _, idx = _split_inputs()
    idx = idx[:1].clamp(0, 63)
    z = torch.zeros(1, 64, 8)
    z[0, :, 0] = -0.0
    for fn in (probe.onehot_gather_emulation, probe.onehot_gather_plain):
        assert not torch.signbit(fn(z, idx)).any()
    assert torch.signbit(probe.window_gather_plain(z, idx))[0, :, 0].all()
    rng = np.random.default_rng(6)
    tiny = torch.as_tensor((rng.standard_normal((1, 64, 8))
                            * 2.0 ** -120).astype(np.float32))
    err = (probe.onehot_gather_emulation(tiny, idx)
           - probe.window_gather_plain(tiny, idx)).abs().max()
    assert 0.0 < float(err) < 2.0 ** -133
    inf = torch.ones(1, 64, 8)
    inf[0, 5, 3] = float("inf")
    for fn in (probe.onehot_gather_emulation, probe.onehot_gather_plain):
        out = fn(inf, idx)
        assert out[0, :, 3].isnan().all() and not out[0, :, :3].isnan().any()


def test_onehot_method_bound_counts_three_tensor_core_products():
    G, W, T, NL = probe.PROBE_SHAPE.values()
    nbytes, flops = probe.onehot_gather_work(G, W, T, NL)
    assert flops == 3 * 2 * G * T * W * NL
    ms, by = kernels.bound_ms((nbytes, flops), torch.float32,
                              kernels.PEAK_TENSOR_FLOPS[torch.bfloat16])
    # 38.7 GFLOP at 989 TFLOP/s against 126 MB at 3.35 TB/s
    assert by == "operations" and ms == pytest.approx(0.0391, rel=1e-2)
    assert nbytes / kernels.PEAK_BYTES_PER_S * 1e3 == pytest.approx(
        0.0377, rel=1e-2)


# --------------------------------------------------------------------------
# node_edge_reduce: the slot-word table walk
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    torch.set_num_threads(1)
    path = globe.write_globe(str(tmp_path_factory.mktemp("globe")), level=3)
    return {"channel": build_mesh_from_raw(
                channel_raw_mesh(8, 24, 10, dz=400.0), cyclic_length_deg=4.5,
                device="cpu"),
            "globe": build_mesh(path, device="cpu", **PC)}


def _padded(mesh, extra: int):
    """The mesh with ``extra`` empty slots behind every node's edges."""
    if not extra:
        return mesh
    N = mesh.n_nodes
    ne = torch.cat([mesh.node_edges,
                    torch.full((N, extra), -1, dtype=torch.int32)], 1)
    sg = torch.cat([mesh.node_edge_sign,
                    torch.zeros((N, extra), dtype=mesh.node_edge_sign.dtype)],
                   1)
    wide = dataclasses.replace(mesh, node_edges=ne, node_edge_sign=sg)
    return dataclasses.replace(wide,
                               cluster=cluster.build_cluster_tables(wide))


def _slot_order_sums(flux, mesh, pair):
    """sign * flux at each node's incident edges, summed in the order
    k = 0..KE-1 (the JAX package's reduce over its slot axis)."""
    ne = mesh.node_edges.T
    valid = ne >= 0
    sign = torch.where(valid, mesh.node_edge_sign.T, 0.0)
    terms = flux[..., torch.where(valid, ne, 0)] * sign
    plus = torch.zeros_like(terms[..., 0, :])
    minus = torch.zeros_like(plus)
    for k in range(terms.shape[-2]):
        v = terms[..., k, :]
        if pair:
            plus = plus + v.clamp_min(0.0)
            minus = minus + v.clamp_max(0.0)
        else:
            plus = plus + v
    return (plus, minus) if pair else (plus,)


@pytest.mark.parametrize("rows", [(), (2, None)], ids=["one_row", "2_nl_Ed"])
@pytest.mark.parametrize("pair", [False, True], ids=["div", "pair"])
@pytest.mark.parametrize("extra", [0, 2], ids=["KE", "KE_padded"])
@pytest.mark.parametrize("name", ["channel", "globe"])
def test_edge_slot_walk_matches_plain(meshes, name, extra, pair, rows):
    mesh = _padded(meshes[name], extra)
    KE, N = mesh.cluster.edge_slot.shape
    assert (KE, N) == (meshes[name].node_edges.shape[1] + extra, mesh.n_nodes)
    shape = tuple(mesh.nl - 1 if r is None else r for r in rows)
    rng = np.random.default_rng(3)
    flux = torch.as_tensor(rng.uniform(-1, 1, shape + (mesh.n_edges,)))
    got = cluster.edge_reduce_emulation(flux, mesh.cluster, pair)
    got = got if pair else (got,)
    plain = (ops.edge_signed_reduce2_plain if pair
             else ops.edge_divergence_plain)(flux, mesh)
    plain = plain if pair else (plain,)
    for g, w, p in zip(got, _slot_order_sums(flux, mesh, pair), plain):
        assert g.shape == shape + (N,)
        assert torch.equal(g, w)
        assert torch.equal(g, p)


@pytest.mark.parametrize("name", ["channel", "globe"])
def test_edge_slot_words_hold_edges_and_signs(meshes, name):
    mesh = meshes[name]
    word = mesh.cluster.edge_slot.T.long()
    ne, sign = mesh.node_edges.long(), mesh.node_edge_sign
    assert torch.equal(word < 0, ne < 0)
    used = ne >= 0
    assert torch.equal((word >> 1)[used], ne[used])
    assert torch.equal(1.0 - 2.0 * (word & 1)[used].to(sign.dtype),
                       sign[used])
    bad = dataclasses.replace(mesh, node_edge_sign=sign * 0.5)
    with pytest.raises(ValueError):
        cluster.build_cluster_tables(bad)


@pytest.mark.parametrize("pair", [False, True], ids=["div", "pair"])
def test_edge_reduce_wrapper_passes_what_the_kernel_takes(meshes, pair,
                                                          monkeypatch):
    """The launch, recorded on the CPU: the C signature's arguments, the
    slot table, and ``row_chunk`` rows per thread."""
    mesh = meshes["globe"]
    L, N, Ed = mesh.nl - 1, mesh.n_nodes, mesh.n_edges
    calls = []

    def record(kernel, device, *args, entry=""):
        sig = kernels._ARGTYPES[kernel + entry]
        assert len(args) + 1 == len(sig)
        for a, t in zip(args, sig):
            if t is ctypes.c_void_p:
                assert a is None or (isinstance(a, torch.Tensor)
                                     and a.is_contiguous())
            else:
                assert type(a) is int
        calls.append(args)

    monkeypatch.setattr(kernels, "launch", record)
    monkeypatch.setattr(kernels, "cuda_only", lambda x, what: None)
    out = ops._node_edge_reduce(torch.zeros(2, L, Ed, dtype=torch.float64),
                                mesh, pair)
    assert (len(out) == 2 and out[1].shape == (2, L, N)) if pair \
        else out.shape == (2, L, N)
    ops._node_edge_reduce(torch.zeros(Ed, dtype=torch.float64), mesh, pair)
    many, one = calls
    assert many[3] is mesh.cluster.edge_slot
    blocks = -(-N // kernels.BLOCK_THREADS)
    assert many[1:3] == (2 * L, Ed) and many[4:7] == (
        N, mesh.node_edges.shape[1], cluster.row_chunk(2 * L, blocks))
    assert one[1] == 1 and one[6] == 1 and one[9] == int(pair)
    assert (many[8] is None) == (not pair)


def test_rows_per_thread():
    # the level-7 globe, 446 blocks: [2, 47, Ed] in 19 runs of 5 rows,
    # [47, Ed] in 16 runs of 3, one row by one thread per node
    assert cluster.row_chunk(94, 446) == 5
    assert cluster.row_chunk(47, 446) == 3
    assert cluster.row_chunk(1, 446) == 1
    assert cluster.row_chunk(0, 446) == 0
    # the 2,875-node channel, 12 blocks: a row a thread; the 46,000-node
    # channel, 180 blocks: 40 runs of 2 rows
    assert cluster.row_chunk(80, 12) == 1
    assert cluster.row_chunk(80, 180) == 2


# --------------------------------------------------------------------------
# the globe numbered along the curve
# --------------------------------------------------------------------------
def test_hilbert_index_walks_neighbouring_cells():
    n = 16
    x, y = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    d = globe._hilbert_index(x.ravel().astype(np.int64),
                             y.ravel().astype(np.int64), 4)
    assert np.array_equal(np.sort(d), np.arange(n * n))
    order = np.argsort(d)
    step = (np.abs(np.diff(x.ravel()[order]))
            + np.abs(np.diff(y.ravel()[order])))
    assert (step == 1).all()


@pytest.mark.parametrize("level", [3, 4])
def test_curve_numbering_is_a_permutation_of_the_subdivision(level):
    """The same positions, triangles (as sets of positions), coast flags
    and depths; both clockwise; depths to rounding (the mean edge length
    they scale with is summed in another order)."""
    layers = dict(n_layers=12, dz_bottom=1000.0)
    a = globe.globe_raw_mesh(level, **layers)
    b = globe.globe_raw_mesh(level, numbering="subdivision", **layers)
    assert a.coords_deg.shape == b.coords_deg.shape
    key = lambda raw: np.lexsort((raw.coords_deg[:, 1], raw.coords_deg[:, 0]))
    ka, kb = key(a), key(b)
    assert np.array_equal(a.coords_deg[ka], b.coords_deg[kb])
    assert not np.array_equal(a.coords_deg, b.coords_deg)
    assert np.array_equal(a.node_flag[ka], b.node_flag[kb])
    assert np.abs(a.depth[ka] - b.depth[kb]).max() <= 1e-9
    # node i of a is node perm[i] of b
    perm = np.empty(ka.shape[0], np.int64)
    perm[ka] = kb
    tri_set = lambda tri: set(map(tuple, np.sort(tri, axis=1)))
    assert tri_set(perm[a.elem_nodes]) == tri_set(b.elem_nodes)
    assert len(tri_set(a.elem_nodes)) == a.elem_nodes.shape[0]
    for numbering in globe.NUMBERINGS:
        v, tri, _ = globe.ocean_triangulation(level, numbering)
        p, q, r = v[tri[:, 0]], v[tri[:, 1]], v[tri[:, 2]]
        assert ((np.cross(q - p, r - p) * p).sum(1) < 0).all()
    # triangles follow their lowest node
    assert (np.diff(a.elem_nodes.min(1)) >= 0).all()
    with pytest.raises(ValueError):
        globe.ocean_triangulation(level, "random")


@pytest.mark.parametrize("numbering", globe.NUMBERINGS)
def test_ssh_operator_spd_under_both_numberings(tmp_path, numbering):
    path = globe.write_globe(str(tmp_path), level=3, n_layers=12,
                             dz_bottom=1000.0, numbering=numbering)
    mesh = build_mesh(path, device="cpu", partial_cell_thresh=0.0, **PC)
    cfg = ModelConfig()
    cfg.timestep.step_per_day = 96
    A = ssh.ssh_dense_matrix(mesh, cfg)
    assert np.abs(A - A.T).max() <= 1e-12 * np.abs(A).max()
    assert np.linalg.eigvalsh(0.5 * (A + A.T)).min() > 0.0


def test_curve_numbering_is_local_on_the_level_5_globe(tmp_path):
    """Per tile of 256 consecutive nodes, one float64 field row: the
    distinct edges named fall by more than 1.5x, the 32-byte sectors that
    hold them by more than 2x (measured: 1,297 -> 819 edges, 507 -> 230
    sectors), and the elements around the tile likewise."""
    stats = {}
    for numbering in globe.NUMBERINGS:
        path = globe.write_globe(str(tmp_path / numbering), level=5,
                                 numbering=numbering)
        mesh = build_mesh(path, device="cpu", **PC)
        stats[numbering] = {
            "edges": cluster.table_tile_stats(mesh.node_edges, 256, 8),
            "elems": cluster.table_tile_stats(mesh.nod_in_elem, 256, 8)}
        ct = mesh.cluster
        listed = cluster.tile_stats(ct.mean_tile_ptr, ct.mean_tile_elems, 8)
        for k in ("entries_per_tile", "sectors_per_tile"):
            assert stats[numbering]["elems"][k] == pytest.approx(listed[k])
    for what, fewer, sectors in (("edges", 1.5, 2.0), ("elems", 1.8, 3.0)):
        old, new = stats["subdivision"][what], stats["curve"][what]
        assert old["entries_per_tile"] > fewer * new["entries_per_tile"]
        assert old["sectors_per_tile"] > sectors * new["sectors_per_tile"]
        # staging a tile once moves fewer sectors than its warps' gathers
        # ask for one by one
        assert new["sectors_per_tile"] < new["warp_sectors_per_tile"]
