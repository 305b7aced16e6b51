"""The static tables of the two cluster kernels (``mesh/cluster.py``).

``elem_to_node_mean`` and ``fct_bounds`` run on the card from tables that
are derived on the host: level ranges in place of the layer masks, per-tile
lists of elements and of neighbour nodes, packed slot words.  The CUDA
kernels cannot run here, so these tests hold what they read and how they
walk it: the ranges against the masks, a torch emulation of each kernel's
data flow against the plain version (``fct_bounds`` bitwise with a NaN
planted, ``elem_to_node_mean`` bitwise), on the channel and on the
level-3 globe with partial cells (columns of 5 to 46 levels), for tiles
smaller and larger than the mesh; the wrappers' argument lists against
the C signatures; and the byte and flop counters of every kernel against
figures worked out by hand.

Two meshes carry ice-shelf cavities: the level-3 globe with the shelf of
``globe.shelf_draft`` (columns whose top lies below the surface), and
that globe with the tops of some elements moved below the bottoms of
their neighbours (``split_mesh``), so that a node and a neighbour share
wet levels in two runs with a gap between them, as beside a real shelf
(477 such pairs on the level-7 shelf globe): the neighbour table holds one
entry per run.
"""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from fesom2_tpu_torch import kernels
from fesom2_tpu_torch.core import eos, ops, ssh, tracers
from fesom2_tpu_torch.core.mixing import kpp
from fesom2_tpu_torch.mesh import build_mesh, build_mesh_from_raw, cluster
from fesom2_tpu_torch.mesh import globe
from fesom2_tpu_torch.mesh.channel import channel_raw_mesh
from fesom2_tpu_torch.scripts import gather_cost_model as probe

MESHES = ("channel", "globe", "shelf", "split")
TILES = (32, 256, 1024)


def split_mesh(mesh):
    """``mesh`` with the top of an element moved to the level below its
    neighbour's bottom wherever the neighbour, open to the surface, ends
    at least three levels above it (each element moved once, its
    neighbours then left alone): the two nodes of their common edge share
    wet levels in two runs.  The node tops follow (the least over the
    node's elements), and both layer masks."""
    ule = mesh.ulevels_elem.numpy().astype(np.int64).copy()
    nle = mesh.nlevels_elem.numpy().astype(np.int64)
    nb = mesh.elem_neighbors.numpy()
    touched = np.zeros(ule.shape[0], bool)
    for e in range(ule.shape[0]):
        for f in nb[e]:
            if f >= 0 and not touched[e] and not touched[f] \
                    and ule[e] == 1 and ule[f] == 1 and nle[f] - nle[e] >= 3:
                ule[f] = nle[e] + 1
                touched[e] = touched[f] = True
    en = mesh.elem_nodes.numpy().astype(np.int64)
    uln = np.full(mesh.n_nodes, mesh.nl, np.int64)
    for j in range(3):
        np.minimum.at(uln, en[:, j], ule)
    nln = mesh.nlevels_node.numpy().astype(np.int64)
    lay = np.arange(mesh.nl - 1)[:, None]
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32)
    out = dataclasses.replace(
        mesh, ulevels_elem=i32(ule), ulevels_node=i32(uln),
        elem_layer_mask=torch.as_tensor((lay >= ule - 1) & (lay < nle - 1)),
        node_layer_mask=torch.as_tensor((lay >= uln - 1) & (lay < nln - 1)))
    return dataclasses.replace(out, cluster=cluster.build_cluster_tables(out))


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    torch.set_num_threads(1)
    path = globe.write_globe(str(tmp_path_factory.mktemp("globe")), level=3)
    shelf = globe.write_globe(str(tmp_path_factory.mktemp("shelf")), level=3,
                              shelf=True)
    out = {"channel": build_mesh_from_raw(
               channel_raw_mesh(8, 24, 10, dz=400.0), cyclic_length_deg=4.5,
               device="cpu"),
           "globe": build_mesh(path, force_rotation=True,
                               use_partial_cell=True, device="cpu"),
           "shelf": build_mesh(shelf, force_rotation=True,
                               use_partial_cell=True, device="cpu")}
    out["split"] = split_mesh(out["shelf"])
    return out


def unpack(word):
    w = word.numpy().astype(np.int64) & 0xFFFFFFFF
    return w & 0xFFFF, (w >> 16) & 0xFF, w >> 24


@pytest.mark.parametrize("name", MESHES)
def test_layer_masks_are_level_ranges(meshes, name):
    mesh = meshes[name]
    lay = np.arange(mesh.nl - 1)[:, None]
    for mask, ule, nle in (
            (mesh.elem_layer_mask, mesh.ulevels_elem, mesh.nlevels_elem),
            (mesh.node_layer_mask, mesh.ulevels_node, mesh.nlevels_node)):
        lo, hi = cluster.level_ranges(mask.numpy())
        assert np.array_equal((lay >= lo) & (lay < hi), mask.numpy())
        assert np.array_equal(lo, ule.numpy() - 1)
        assert np.array_equal(hi, nle.numpy() - 1)
    if name == "globe":
        assert int(mesh.nlevels_node.min()) == 5
        assert int(mesh.nlevels_node.max()) > 40
    if name in ("shelf", "split"):
        assert int((mesh.ulevels_node > 1).sum()) > 30
        assert int(mesh.ulevels_elem.max()) > 3


def _pairs(ct, tile):
    """(node, neighbour, lo, hi) of every used entry of the FCT table."""
    local, lo, hi = unpack(ct.fct_slot)                 # [M, N]
    N = local.shape[1]
    base = ct.fct_tile_ptr.numpy()[np.arange(N) // tile]
    nb = ct.fct_tile_nodes.numpy()[base[None] + local]
    node = np.broadcast_to(np.arange(N)[None], local.shape)
    used = lo < hi
    return node[used], nb[used], lo[used], hi[used]


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", ["shelf", "split"])
def test_neighbour_runs_split_beside_a_shelf(meshes, name, tile):
    """Each (node, neighbour) pair's entries are disjoint runs, apart by at
    least one level, whose union is the set of levels on which a shared
    element and the neighbour are wet (worked out level by level); the
    split mesh has such pairs, and the table grows by their extra
    entries; every level bound fits its 8 bits."""
    mesh = meshes[name]
    ct = cluster.build_cluster_tables(mesh, tile)
    L, N = mesh.nl - 1, mesh.n_nodes
    node, nb, lo, hi = _pairs(ct, tile)
    assert hi.max() <= L < 256
    emask = mesh.elem_layer_mask.numpy()
    nmask = mesh.node_layer_mask.numpy()
    nie = mesh.nod_in_elem.numpy()
    en = mesh.elem_nodes.numpy()
    want = {}
    for n in range(N):
        for e in nie[n][nie[n] >= 0]:
            for m in en[e]:
                lev = want.setdefault((n, int(m)), np.zeros(L, bool))
                lev |= emask[:, e] & nmask[:, m]
    got = {}
    order = np.lexsort((lo, nb, node))
    for n, m, a, b in zip(node[order], nb[order], lo[order], hi[order]):
        runs = got.setdefault((int(n), int(m)), [])
        assert not runs or a > runs[-1][1]          # apart, in level order
        runs.append((a, b))
    want = {k: v for k, v in want.items() if v.any()}
    assert set(got) == set(want)
    for k, runs in got.items():
        lev = np.zeros(L, bool)
        for a, b in runs:
            lev[a:b] = True
        assert np.array_equal(lev, want[k]), k
    n_split = sum(len(r) - 1 for r in got.values())
    if name == "split":
        assert n_split > 10
        assert ct.fct_slot.shape[0] >= meshes["shelf"].cluster.fct_slot.shape[0]
    # the full levels of a node lie inside its first (self) entry
    info = ct.fct_node.numpy().astype(np.int64) & 0xFFFFFFFF
    f_lo, f_hi = info & 0xFF, (info >> 8) & 0xFF
    _, s_lo, s_hi = unpack(ct.fct_slot)
    full = f_lo < f_hi
    assert (s_lo[0][full] <= f_lo[full]).all()
    assert (s_hi[0][full] >= f_hi[full]).all()


def test_level_ranges_refuse_a_gap():
    mask = np.ones((6, 3), bool)
    mask[2, 1] = False
    with pytest.raises(ValueError):
        cluster.level_ranges(mask)
    with pytest.raises(ValueError):
        cluster.level_ranges(np.ones((256, 2), bool))


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", MESHES)
def test_tables_hold_the_masks_and_the_adjacency(meshes, name, tile):
    """The packed words give back ``nod_in_elem``, the areas and both
    layer masks; the tile lists are sorted and hold each entry once."""
    mesh = meshes[name]
    ct = cluster.build_cluster_tables(mesh, tile)
    N, K = mesh.nod_in_elem.shape
    L = mesh.nl - 1
    nie = mesh.nod_in_elem.numpy()
    valid = nie.T >= 0
    local, lo, hi = unpack(ct.mean_slot)
    ptr = ct.mean_tile_ptr.numpy()
    base = ptr[np.arange(N) // tile]
    elems = ct.mean_tile_elems.numpy()[base[None] + local]
    assert np.array_equal(elems[valid], nie.T[valid])
    area = mesh.elem_area.numpy()
    assert np.array_equal(ct.mean_weight.numpy(),
                          np.where(valid, area[np.clip(nie.T, 0, None)], 0.0))
    lay = np.arange(L)[:, None, None]
    emask = mesh.elem_layer_mask.numpy()[:, np.clip(nie.T, 0, None)]
    assert np.array_equal(((lay >= lo) & (lay < hi))[:, valid],
                          emask[:, valid])
    for p, ids in ((ptr, ct.mean_tile_elems.numpy()),
                   (ct.fct_tile_ptr.numpy(), ct.fct_tile_nodes.numpy())):
        assert p[0] == 0 and p[-1] == ids.shape[0]
        assert p.shape[0] == -(-N // tile) + 1
        for t in range(p.shape[0] - 1):
            assert (np.diff(ids[p[t]:p[t + 1]]) > 0).all()
    assert ct.mean_u_max == np.diff(ptr).max()
    assert ct.fct_u_max == np.diff(ct.fct_tile_ptr.numpy()).max()
    # the node words: the node's own wet range
    info = ct.fct_node.numpy().astype(np.int64) & 0xFFFFFFFF
    nlay = np.arange(L)[:, None]
    assert np.array_equal((nlay >= ((info >> 16) & 0xFF)) & (nlay < info >> 24),
                          mesh.node_layer_mask.numpy())
    # entry 0 of every node is the node itself
    flocal = unpack(ct.fct_slot)[0]
    fbase = ct.fct_tile_ptr.numpy()[np.arange(N) // tile]
    assert np.array_equal(ct.fct_tile_nodes.numpy()[fbase + flocal[0]],
                          np.arange(N))


@pytest.mark.parametrize("respect_levels", (True, False))
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", MESHES)
def test_mean_emulation_matches_plain(meshes, name, tile, respect_levels):
    mesh = meshes[name]
    ct = cluster.build_cluster_tables(mesh, tile)
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.uniform(-1, 1, (2, mesh.nl - 1, mesh.n_elems)))
    got = cluster.mean_emulation(x, ct, respect_levels)
    want = ops.elem_to_node_mean_plain(x, mesh, respect_levels)
    # both sum the slots in the kernel's order
    assert torch.equal(got, want)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", MESHES)
def test_fct_emulation_matches_plain_bitwise(meshes, name, tile):
    """Equal bit for bit: on random fields, with a NaN planted in each
    input, and with every value below the -1e3 filler (where the levels
    that hold no filler must start from the node itself)."""
    mesh = meshes[name]
    ct = cluster.build_cluster_tables(mesh, tile)
    L, N = mesh.nl - 1, mesh.n_nodes
    rng = np.random.default_rng(11)
    ttf = torch.as_tensor(rng.uniform(0, 30, (2, L, N)))
    lo = torch.as_tensor(rng.uniform(0, 30, (2, L, N)))

    def same(ttf, lo, nans):
        got = cluster.fct_emulation(ttf, lo, ct, mesh.nlevels_node)
        want = tracers.fct_bounds_plain(ttf, lo, mesh)
        for g, w in zip(got, want):
            assert torch.equal(g.isnan(), w.isnan())
            assert bool(w.isnan().any()) == nans
            assert torch.equal(g.nan_to_num(), w.nan_to_num())

    same(ttf, lo, False)
    same(ttf - 5e3, lo - 5e3, False)
    ttf[0, 2, N // 2] = float("nan")
    lo[1, 1, N // 3] = float("nan")
    same(ttf, lo, True)


def test_tables_follow_the_mesh_through_replace(meshes, tmp_path):
    """The mesh is built with its tables, for tiles of ``TILE_NODES``; they
    stay with it when another field is replaced (the soufflet step replaces
    the Coriolis parameter every step) and when a model holds the mesh as
    buffers, and ``mesh_from_numpy`` derives the same ones."""
    from fesom2_tpu_torch.convert import mesh_from_numpy, to_numpy
    from fesom2_tpu_torch.mesh.channel import write_mesh
    from fesom2_tpu_torch.model import setup_soufflet_model
    mesh = meshes["channel"]
    ct = mesh.cluster
    assert ct.tile_nodes == cluster.TILE_NODES
    other = dataclasses.replace(mesh, coriolis=mesh.coriolis * 2.0)
    assert other.cluster is ct
    arrays = to_numpy(mesh)
    del arrays["cluster"]
    fresh = (cluster.build_cluster_tables(mesh),
             mesh_from_numpy(arrays, "cpu").cluster,
             setup_soufflet_model(write_mesh(
                 channel_raw_mesh(8, 24, 10, dz=400.0), str(tmp_path)),
                 device="cpu").mesh.cluster)
    for f in dataclasses.fields(ct):
        for got in fresh:
            a, b = getattr(got, f.name), getattr(ct, f.name)
            assert torch.equal(a, b) if isinstance(b, torch.Tensor) \
                else a == b, f.name


def test_level_chunk():
    # the level-7 globe: 446 tiles; 2 rows of 47 layers -> 5 chunks of 10
    assert cluster.level_chunk(47, 2, 446) == 10
    # two tracers: 892 blocks per chunk -> 3 chunks of 16
    assert cluster.level_chunk(47, 1, 892) == 16
    # the channel: 12 tiles, never under 4 planes a block
    assert cluster.level_chunk(40, 2, 12) == 2
    assert cluster.level_chunk(40, 1, 24) == 4
    assert cluster.level_chunk(1, 1, 1) == 1
    assert cluster.level_chunk(5, 1, 10 ** 6) == 5


@pytest.mark.parametrize("name", MESHES)
def test_wrappers_pass_what_the_kernels_take(meshes, name, monkeypatch):
    """The two wrappers' launches, recorded on the CPU: as many arguments
    as the C signature has, pointers where it takes pointers."""
    mesh = meshes[name]
    L, N, E = mesh.nl - 1, mesh.n_nodes, mesh.n_elems
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
        calls.append((kernel, args))

    monkeypatch.setattr(kernels, "launch", record)
    monkeypatch.setattr(kernels, "cuda_only", lambda x, what: None)
    x = torch.zeros(2, L, E, dtype=torch.float64)
    assert ops._elem_to_node_mean_tiled(x, mesh, True).shape == (2, L, N)
    assert ops._elem_to_node_mean_flat(x[:, 0], mesh).shape == (2, N)
    assert [c[0] for c in calls] == ["elem_to_node_mean"] * 2
    tiled, flat = calls[0][1], calls[1][1]
    assert tiled[6] is mesh.cluster.mean_slot
    assert flat[3] is mesh.nod_in_elem
    assert tiled[10:14] == (cluster.TILE_NODES, mesh.cluster.mean_u_max,
                            cluster.level_chunk(L, 2, -(-N // 256)), 1)
    with pytest.raises(ValueError):
        ops._elem_to_node_mean_tiled(x[:, :-1], mesh, True)


WORK = [
    # node_edge_reduce, 3 rows of 10 edges, 4 nodes of 5 slots, float64:
    # flux 240 + tables 4*5*(4+8) = 240 + out 96; (2+2)*5*3*4 flops
    (ops.node_edge_reduce_work(3, 10, 4, 5, False, 8), (576, 240)),
    # the pair form: two outputs, (2+4)*5*3*4 flops
    (ops.node_edge_reduce_work(3, 10, 4, 5, True, 8), (672, 360)),
    # elem_to_node_mean layered, 2 rows x 3 levels, E=7, N=4, K=6, float32,
    # lists of 9 entries in 2 tiles of 2: fields 2*3*11*4 = 264, tables
    # 6*4*8 = 192, lists 4*(9+3) = 48; 19 flops per output
    (ops.elem_to_node_mean_work(2, 3, 7, 4, 6, 4, 9, 2), (504, 456)),
    # flat: fields 2*11*4 = 88, nod_in_elem 96, areas 28
    (ops.elem_to_node_mean_work(2, 1, 7, 4, 6, 4), (212, 152)),
    # tridiag_solve, 2 right-hand sides of 5 x 3, float64: 7 arrays
    (ops.tridiag_solve_work(2, 5, 3, 8), (840, 195)),
    # fct_bounds, 2 tracers x 3 levels x 4 nodes, M=7, float64, lists of 10
    # in 2 tiles: fields 4*24*8 = 768, words 4*4*9 = 144, lists 4*13 = 52
    (tracers.fct_bounds_work(2, 3, 4, 7, 8, 10, 2), (964, 816)),
    # ring_spmv, 8 x 100, float32: cols+vals 6400, x and y 800
    (ssh.ring_spmv_work(8, 100, 4), (7200, 1600)),
    # block_schwarz, N=100, 3 blocks of 40, 2 slots, 5 coarse ids, float64:
    # (200 + 4800 + 9)*8 = 40072, ints 4*(120+200+15+100) = 1740, mask 200
    (ssh.block_schwarz_work(100, 3, 40, 2, 5, 8), (42012, 9833)),
    # pressure_bv, 4 layers x 10 columns, 25 wet, JM, float64: reads
    # (150+10)*8 + 40, writes (8+10+1)*10*8
    (eos.pressure_bv_work(4, 10, 25, 1, 8), (2880, 165 * 25)),
    (eos.pressure_bv_work(4, 10, 25, 2, 4), (1480, 59 * 25)),
    # kpp_column, 5 levels x 10 columns, 25 wet, float64
    (kpp.kpp_column_work(5, 10, 25, False, 8), (2880, 5000)),
    (kpp.kpp_column_work(5, 10, 25, True, 8), (4080, 6500)),
    # the probe, G=2, W=8, T=3, NL=4, 5 distinct rows named
    (probe.window_gather_work(2, 3, 4, 5), (200, 0)),
    # the one-hot method: three bf16 products of 2*2*3*8*4 = 384 flops
    (probe.onehot_gather_work(2, 8, 3, 4), (376, 1152)),
    # packed, blocks of 40, 0 and 1 nodes (strides 40, 0, 4; tiles 2, 1,
    # 1): (200 + 1604 + 9)*8 = 14504, ints 4*(41+200+15+100+4+12) = 1488,
    # inv_off 24; 2*(1600+1) + 18 + 200 + 15 flops
    (ssh.block_schwarz_packed_work(100, [40, 0, 1], 2, 5, 8), (16016, 3435)),
]


@pytest.mark.parametrize("case", range(len(WORK)))
def test_work_counters_give_the_hand_computed_figures(case):
    got, want = WORK[case]
    assert got == want


def test_bound_takes_the_larger_of_bytes_and_operations():
    ms, by = kernels.bound_ms((3.35e9, 1e6), torch.float64)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = kernels.bound_ms((1e3, 67e9), torch.float32)
    assert by == "operations" and ms == pytest.approx(1.0)
    ms, by = kernels.bound_ms((1e3, 34e9), torch.float64)
    assert by == "operations" and ms == pytest.approx(1.0)


@pytest.mark.parametrize("name", MESHES)
def test_tile_stats(meshes, name):
    mesh = meshes[name]
    ct = cluster.build_cluster_tables(mesh, 32)
    st = cluster.tile_stats(ct.mean_tile_ptr, ct.mean_tile_elems, 8)
    assert st["tiles"] == -(-mesh.n_nodes // 32)
    assert st["entries_per_tile"] * st["tiles"] == ct.mean_tile_elems.numel()
    # four float64 values share a sector: between a quarter and all
    assert st["entries_per_tile"] / 4 <= st["sectors_per_tile"] \
        <= st["entries_per_tile"]


def test_neighbour_ranges_on_two_triangles():
    """Nodes 0-3, elements (0, 1, 2) and (1, 3, 2): the shared edge 1-2
    gets the union of both elements' runs; a node around which nothing is
    wet lists itself with no levels; runs with a gap between them (beside
    an ice shelf) give one entry each, in level order."""
    elem_nodes = np.array([[0, 1, 2], [1, 3, 2]])
    nie = np.array([[0, -1], [0, 1], [0, 1], [1, -1]])
    wet = np.array([0, 0, 0, 0]), np.array([6, 6, 6, 6])
    node, nb, lo, hi = cluster._neighbour_ranges(
        nie, elem_nodes, np.array([0, 2]), np.array([3, 5]), *wet)
    runs = {(int(n), int(m)): (int(a), int(b))
            for n, m, a, b in zip(node, nb, lo, hi)}
    assert runs[(1, 2)] == runs[(2, 1)] == runs[(1, 1)] == (0, 5)
    assert runs[(0, 1)] == runs[(0, 0)] == (0, 3)
    assert runs[(3, 2)] == runs[(3, 3)] == (2, 5)
    assert (0, 3) not in runs and len(runs) == 14
    # every node comes first in its own list
    firsts = {int(n): int(m) for n, m in zip(node[::-1], nb[::-1])}
    assert firsts == {0: 0, 1: 1, 2: 2, 3: 3}
    # element 1 dry everywhere: node 3 stands alone
    node, nb, lo, hi = cluster._neighbour_ranges(
        nie, elem_nodes, np.array([0, 0]), np.array([3, 0]), *wet)
    alone = [(int(m), int(a), int(b))
             for n, m, a, b in zip(node, nb, lo, hi) if n == 3]
    assert alone == [(3, 0, 0)]
    node, nb, lo, hi = cluster._neighbour_ranges(
        nie, elem_nodes, np.array([0, 4]), np.array([3, 6]), *wet)
    entries = [(int(n), int(m), int(a), int(b))
               for n, m, a, b in zip(node, nb, lo, hi)]
    for n, m in ((1, 2), (2, 1), (1, 1), (2, 2)):
        assert [e[2:] for e in entries if e[:2] == (n, m)] == [(0, 3), (4, 6)]
    assert [e[2:] for e in entries if e[:2] == (3, 2)] == [(4, 6)]
    assert len(entries) == 18
    assert [e[1] for e in entries if e[0] == 1][:2] == [1, 1]
