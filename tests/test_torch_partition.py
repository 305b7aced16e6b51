"""The port's partitioner (``fesom2_tpu_torch/parallel/partition.py``)
against the JAX package's ``parallel/partition.py``.

The port builds its own copy of ``native/partitioner.cpp`` with the host
C++ compiler; the JAX package loads its committed library.  On the level-3
and level-5 globes (501 and 7,332 nodes, CPU): the default partition
(weighted bisection with Kernighan-Lin sweeps) equal to JAX's bit for bit
for S = 2, 4, 8, the node graph and the edge cut equal, the two-level
partition equal, ``build_layout``'s default layout of the mesh equal to
JAX's, the block-Schwarz blocks still cut by the plain bisection (JAX's
tables), the block_schwarz kernel's packed layout of the globe's and of
the rank-local preconditioners (level 5 over 4 ranks) round-tripping bit
for bit with its data flow walked in numpy against the plain version and
JAX's apply (1e-13), and a failed build raising with the compiler's
output.
"""
import numpy as np
import pytest
import torch

from fesom2_tpu.mesh import build_mesh as jax_build_mesh
from fesom2_tpu.core import ssh as jssh
from fesom2_tpu.parallel import dist as jdist, partition as jpart

from fesom2_tpu_torch.convert import to_numpy
from fesom2_tpu_torch.core import ssh
from fesom2_tpu_torch.mesh import build_mesh, globe
from fesom2_tpu_torch.model import pi_config
from fesom2_tpu_torch.parallel import dist, partition

from test_torch_ssh_cg import (assert_packing_round_trips,
                               assert_tables_equal, kernel_walk)


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """{level: (JAX mesh, port mesh)} of the code-built globes."""
    torch.set_num_threads(1)
    out = {}
    for level in (3, 5):
        path = globe.write_globe(str(tmp_path_factory.mktemp(f"g{level}")),
                                 level=level)
        kw = dict(force_rotation=True, cyclic_length_deg=360.0)
        out[level] = (jax_build_mesh(path, **kw),
                      build_mesh(path, **kw, device="cpu"))
    return out


@pytest.mark.parametrize("level", [3, 5])
@pytest.mark.parametrize("S", [2, 4, 8])
def test_partition_equals_jax_default(meshes, level, S):
    jm, tm = meshes[level]
    assert jpart._load_native() is not None
    got = partition.partition_nodes(tm, S)
    want = jpart.partition_nodes(jm, S)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert sorted(np.unique(got)) == list(range(S))
    # the sweeps move nodes off the bisection's cut and shorten it
    plain = partition._partition_numpy(partition._sphere_xyz(tm),
                                       partition.node_weights(tm), S)
    assert partition.edge_cut(tm, got) <= partition.edge_cut(tm, plain)


@pytest.mark.parametrize("level", [3, 5])
def test_graph_and_edge_cut_equal_jax(meshes, level):
    jm, tm = meshes[level]
    rowptr, colind = partition.node_graph_csr(tm)
    jrowptr, jcolind = jpart.node_graph_csr(jm)
    for a, b in ((rowptr, jrowptr), (colind, jcolind)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(partition.node_weights(tm), jpart.node_weights(jm))
    assert np.array_equal(partition._sphere_xyz(tm), jpart._sphere_xyz(jm))
    rng = np.random.default_rng(level)
    for part in (partition.partition_nodes(tm, 4),
                 rng.integers(0, 3, tm.n_nodes).astype(np.int32)):
        cut = partition.edge_cut(tm, part)
        assert cut == jpart.edge_cut(jm, part)
        edges = tm.edges.numpy()
        assert cut == int((part[edges[:, 0]] != part[edges[:, 1]]).sum())


@pytest.mark.parametrize("n_part", [(2, 2), (2, 4), 4])
def test_hierarchical_equals_jax(meshes, n_part):
    jm, tm = meshes[5]
    part, top = partition.partition_nodes_hierarchical(tm, n_part)
    jpart_, jtop = jpart.partition_nodes_hierarchical(jm, n_part)
    assert np.array_equal(part, jpart_) and np.array_equal(top, jtop)


@pytest.mark.parametrize("S", [2, 4])
def test_default_layout_equals_jax(meshes, S):
    """``build_layout`` without ``part`` cuts by each package's default
    partition: the same parts, maps and schedules (the mesh alone; the
    model's layout, with statics and preconditioners, is held in
    ``tests/test_torch_dist.py``)."""
    jm, tm = meshes[3]
    lay, jlay = dist.build_layout(tm, S), jdist.build_layout(jm, S)
    assert (lay.n_own, lay.n_loc, lay.e_loc, lay.ed_loc, lay.sizes) == (
        jlay.n_own, jlay.n_loc, jlay.e_loc, jlay.ed_loc, jlay.sizes)
    for name in ("part", "node_l2g", "elem_l2g", "edge_l2g", "node_from",
                 "elem_from"):
        assert np.array_equal(np.asarray(getattr(lay, name)),
                              np.asarray(getattr(jlay, name))), name
    for name in ("node_send", "node_src", "elem_send", "elem_src"):
        assert np.array_equal(getattr(lay.sched, name),
                              np.asarray(getattr(jlay.sched, name))), name
    assert np.array_equal(lay.part, partition.partition_nodes(tm, S))


def test_block_schwarz_blocks_unchanged(meshes):
    """The preconditioner's blocks stay cut by the plain bisection, as the
    JAX builder cuts them (``fesom2_tpu/core/ssh.py:462-477``)."""
    jm, tm = meshes[3]
    cfg = pi_config()
    pc = ssh.build_block_schwarz(tm, cfg, block_size=64)
    assert_tables_equal(pc, jssh.build_block_schwarz(jm, cfg, block_size=64),
                        ("block_ids", "node_slots", "node_slot_valid",
                         "coarse_ids", "coarse_part"),
                        ("inv_blocks", "coarse_inv"))
    xyz = partition._sphere_xyz(tm)
    ones = np.ones(tm.n_nodes)
    assert np.array_equal(partition._partition_numpy(xyz, ones, 8),
                          jpart._partition_numpy(jpart._sphere_xyz(jm),
                                                 ones, 8))


@pytest.fixture(scope="module")
def local_pcs(meshes):
    """The rank-local preconditioners of ``build_block_schwarz_local`` on
    the level-5 globe over 4 ranks, as ``dist.rank_model`` makes them."""
    _, tm = meshes[5]
    layout = dist.build_layout(tm, 4, cfg=pi_config())
    return [dist.rank_block_pc(dist.rank_bundle(layout, r)["block_pc"],
                               "cpu", torch.float64) for r in range(4)]


def test_block_schwarz_packing_on_the_globe(meshes):
    """The kernel's packed layout round-trips bit for bit on the globe's
    preconditioner, and its data flow, walked in numpy, equals the plain
    version and JAX's apply within 1e-13 of max|ref|."""
    jm, tm = meshes[3]
    cfg = pi_config()
    pc = ssh.build_block_schwarz(tm, cfg, block_size=64)
    assert pc.block_ids.shape[0] == 8
    assert_packing_round_trips(pc)
    r = np.random.default_rng(9).standard_normal(tm.n_nodes)
    got = kernel_walk(pc, r)
    plain = ssh.block_schwarz_plain(pc, torch.as_tensor(r)).numpy()
    ref = np.asarray(jssh.build_block_schwarz(jm, cfg, block_size=64)(r))
    for want in (plain, ref):
        assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()


def test_block_schwarz_packing_rank_local(local_pcs):
    """The same on each rank's tables (no coarse level; an empty block
    where a rank has fewer than the most): rank_block_pc packs them."""
    rng = np.random.default_rng(10)
    sizes = [np.diff(to_numpy(pc.packed.row_off)) for pc in local_pcs]
    assert any((n == 0).any() for n in sizes)
    for pc in local_pcs:
        pk = assert_packing_round_trips(pc)
        assert pc.packed is not None and torch.equal(pc.packed.inv, pk.inv)
        r = rng.standard_normal(pc.node_slots.shape[0])
        got = kernel_walk(pc, r)
        want = ssh.block_schwarz_plain(pc, torch.as_tensor(r)).numpy()
        assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()


def test_failed_build_raises(monkeypatch, tmp_path):
    """A source the compiler refuses raises with its output; nothing falls
    back to the bisection."""
    bad = tmp_path / "partitioner.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(partition, "SOURCE", bad)
    monkeypatch.setattr(partition, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(partition, "_LIB", None)
    with pytest.raises(RuntimeError, match="did not build"):
        partition.build()
    with pytest.raises(RuntimeError, match="did not build"):
        partition.partition_nodes(globe_stub(), 2)


def globe_stub():
    """The smallest mesh-like object partition_nodes reads."""
    class M:
        n_nodes = 3
        edges = torch.tensor([[0, 1], [1, 2]])
        nlevels_node = torch.tensor([3, 3, 3])
        geo_coords = torch.tensor([[0.0, 0.0], [0.1, 0.0], [0.2, 0.0]])
    return M()
