"""The port's CG free-surface solve against the JAX package's.

On the code-built channel (8 x 24 nodes, 10 layers), in float64 on the
CPU, where the wrappers run their plain versions:

- the host builders' tables equal JAX's: index tables bitwise, values to
  1e-13 of their largest magnitude;
- the ring, ALE ring and block-Schwarz applies agree with JAX's to 1e-12,
  and the ALE ring with the matrix-free operator (as
  ``tests/test_zstar.py:209-232`` holds it in the JAX package);
- the block_schwarz kernel's packed layout of the inverses unpacks to the
  padded tables bit for bit; its data flow walked in numpy (row tiles,
  16-byte lanes, shuffle trees, slot-order combine) equals the plain
  version and JAX's apply to 1e-13 (float64; 1e-5 in float32), and the
  wrapper's launch arguments match the C signature;
- ``pcg`` gives JAX's solution to 1e-9 in the same number of iterations;
- 3 steps with CG forced (``DENSE_SSH_MAX_NODES = 0`` in both packages),
  zstar and linfs, agree with JAX's ``Model.step_fn`` to 1e-8.

The preconditioner is cut into blocks of about 32 nodes (6 blocks) for the
table, apply and pcg tests; the whole-step tests use the model's default
of 256 (one block on this mesh).
"""
import ctypes
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fesom2_tpu.model as jax_model
from fesom2_tpu.core import ops as jops, ssh as jssh
from fesom2_tpu.core.state import zero_forcing as jax_zero_forcing
from fesom2_tpu.mesh import build_mesh as jax_build_mesh

import fesom2_tpu_torch.model as port_model
from fesom2_tpu_torch import kernels
from fesom2_tpu_torch.convert import state_from_numpy, tables_from, to_numpy
from fesom2_tpu_torch.core import ops, ssh
from fesom2_tpu_torch.core.state import zero_forcing
from fesom2_tpu_torch.mesh import build_mesh
from fesom2_tpu_torch.mesh.channel import channel_raw_mesh, write_mesh

BLOCK = 32
FIELDS = ("u", "v", "eta", "hbar", "d_eta", "tr", "tr_old", "w", "Kv", "Av",
          "hnode", "helem", "zbar_3d", "Z_3d")


@pytest.fixture(scope="module")
def mesh_dir(tmp_path_factory):
    torch.set_num_threads(1)
    return write_mesh(channel_raw_mesh(8, 24, 10, dz=400.0),
                      str(tmp_path_factory.mktemp("channel")))


@pytest.fixture(scope="module")
def meshes(mesh_dir):
    kw = dict(cyclic_length_deg=4.5, force_rotation=False)
    return jax_build_mesh(mesh_dir, **kw), build_mesh(mesh_dir, **kw,
                                                      device="cpu")


@pytest.fixture(scope="module")
def cfg():
    return port_model.soufflet_config(which_ale="zstar")


@pytest.fixture(scope="module")
def hbar_e(meshes):
    """A depth perturbation of the size a run gives (0.5 m), from a seed."""
    jm, _ = meshes
    rng = np.random.default_rng(11)
    return rng.uniform(-0.5, 0.5, jm.n_elems)


def _field(rng, n):
    return rng.standard_normal(n)


def rel_err(port, ref):
    ref = np.asarray(ref)
    got = to_numpy(port)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-300)


def assert_tables_equal(port, ref, exact, close):
    for name in exact:
        got, want = to_numpy(getattr(port, name)), np.asarray(getattr(ref,
                                                                      name))
        assert got.shape == want.shape and np.array_equal(got, want), name
    for name in close:
        assert rel_err(getattr(port, name), getattr(ref, name)) <= 1e-13, name


# --------------------------------------------------------------------------
# tables
# --------------------------------------------------------------------------
def test_ring_tables_match_jax(meshes, cfg):
    jm, tm = meshes
    assert_tables_equal(ssh.build_ssh_ring(tm, cfg),
                        jssh.build_ssh_ring(jm, cfg), ("cols",), ("vals",))


def test_ring_ale_tables_match_jax(meshes, cfg):
    jm, tm = meshes
    assert_tables_equal(ssh.build_ssh_ring_ale(tm, cfg),
                        jssh.build_ssh_ring_ale(jm, cfg),
                        ("cols", "e_ids"), ("vals0", "e_coef"))


def test_block_schwarz_tables_match_jax(meshes, cfg):
    jm, tm = meshes
    pc = ssh.build_block_schwarz(tm, cfg, block_size=BLOCK)
    assert pc.block_ids.shape[0] == 6
    assert_tables_equal(pc, jssh.build_block_schwarz(jm, cfg,
                                                     block_size=BLOCK),
                        ("block_ids", "node_slots", "node_slot_valid",
                         "coarse_ids", "coarse_part"),
                        ("inv_blocks", "coarse_inv"))


def test_tables_carried_from_jax(meshes, cfg):
    """``convert.tables_from`` gives the port's classes from the JAX
    objects, equal to what the port's builders make."""
    jm, tm = meshes
    for cls, port, ref in (
            (ssh.RingOperator, ssh.build_ssh_ring(tm, cfg),
             jssh.build_ssh_ring(jm, cfg)),
            (ssh.RingALE, ssh.build_ssh_ring_ale(tm, cfg),
             jssh.build_ssh_ring_ale(jm, cfg)),
            (ssh.BlockSchwarz, ssh.build_block_schwarz(tm, cfg, BLOCK),
             jssh.build_block_schwarz(jm, cfg, BLOCK))):
        got = tables_from(cls, ref, "cpu")
        assert type(got) is cls
        for f in dataclasses.fields(cls):
            a, b = getattr(got, f.name), getattr(port, f.name)
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert torch.allclose(a, b, rtol=1e-13, atol=0.0) \
                if b.is_floating_point() else torch.equal(a, b), f.name


# --------------------------------------------------------------------------
# applies
# --------------------------------------------------------------------------
def test_ring_apply_matches_jax(meshes, cfg):
    jm, tm = meshes
    eta = _field(np.random.default_rng(3), tm.n_nodes)
    got = ssh.build_ssh_ring(tm, cfg)(torch.as_tensor(eta))
    ref = jssh.build_ssh_ring(jm, cfg)(jnp.asarray(eta))
    assert rel_err(got, ref) <= 1e-12
    # and the linfs matrix-free operator
    assert rel_err(got, ssh.ssh_operator(tm, cfg)(torch.as_tensor(eta))) \
        <= 1e-12


def test_ring_ale_apply_matches_jax_and_matrix_free(meshes, cfg, hbar_e):
    jm, tm = meshes
    eta = _field(np.random.default_rng(4), tm.n_nodes)
    ring = ssh.build_ssh_ring_ale(tm, cfg)
    op = ring.materialize(torch.as_tensor(hbar_e))
    got = op(torch.as_tensor(eta))
    ref = jssh.build_ssh_ring_ale(jm, cfg).materialize(
        jnp.asarray(hbar_e))(jnp.asarray(eta))
    assert rel_err(got, ref) <= 1e-12
    mf = ssh.ssh_operator(tm, cfg, hbar_e=torch.as_tensor(hbar_e))
    assert rel_err(got, mf(torch.as_tensor(eta))) <= 1e-12
    # the hbar dependence is exercised
    got0 = ring.materialize(torch.zeros(tm.n_elems, dtype=torch.float64))(
        torch.as_tensor(eta))
    assert float((got0 - got).abs().max()) > 1e-6 * float(got.abs().max())


def test_block_schwarz_apply_matches_jax(meshes, cfg):
    jm, tm = meshes
    r = _field(np.random.default_rng(5), tm.n_nodes)
    got = ssh.build_block_schwarz(tm, cfg, BLOCK)(torch.as_tensor(r))
    ref = jssh.build_block_schwarz(jm, cfg, block_size=BLOCK)(jnp.asarray(r))
    assert rel_err(got, ref) <= 1e-12


@pytest.mark.parametrize("warm", [False, True])
def test_pcg_matches_jax(meshes, cfg, hbar_e, warm):
    """The zstar operator with the block preconditioner, from zero or from
    a warm start: the same iterations and solution as JAX's ops.pcg."""
    jm, tm = meshes
    rng = np.random.default_rng(6)
    rhs = _field(rng, tm.n_nodes) * 1e6
    x0 = _field(rng, tm.n_nodes) if warm else None
    op = ssh.build_ssh_ring_ale(tm, cfg).materialize(torch.as_tensor(hbar_e))
    pc = ssh.build_block_schwarz(tm, cfg, BLOCK)
    x, it, res = ops.pcg(op, torch.as_tensor(rhs), pc,
                         x0=None if x0 is None else torch.as_tensor(x0))
    jop = jssh.build_ssh_ring_ale(jm, cfg).materialize(jnp.asarray(hbar_e))
    jpc = jssh.build_block_schwarz(jm, cfg, block_size=BLOCK)
    jx, jit_, jres = jops.pcg(jop, jnp.asarray(rhs), jpc,
                              x0=None if x0 is None else jnp.asarray(x0))
    assert int(it) == int(jit_) and int(it) > 1
    assert rel_err(x, jx) <= 1e-9
    assert float(res) <= 1e-10 and float(jres) <= 1e-10


# --------------------------------------------------------------------------
# the kernel's packed layout and data flow
# --------------------------------------------------------------------------
def warp_tree(vals: np.ndarray) -> np.ndarray:
    """Lane 0 of a warp-shuffle tree (offsets 16, 8, 4, 2, 1) over the
    last axis of [..., 32]."""
    vals = vals.copy()
    for off in (16, 8, 4, 2, 1):
        vals[..., :off] = vals[..., :off] + vals[..., off:2 * off]
    return vals[..., 0]


def lane_sums(rows: np.ndarray, x: np.ndarray, width: int) -> np.ndarray:
    """[R, 32] of a warp's lanes over rows [R, L] times x [L] (L a multiple
    of ``width``): lane l adds the vectors of ``width`` elements l, l + 32,
    l + 64, ... in turn, each element's product rounded on its own."""
    R, L = rows.shape
    nvec = L // width
    m = -(-nvec // 32) * 32
    a = np.zeros((R, m * width), rows.dtype)
    a[:, :L] = rows
    z = np.zeros(m * width, rows.dtype)
    z[:L] = x
    a = a.reshape(R, m // 32, 32, width)
    z = z.reshape(m // 32, 32, width)
    acc = np.zeros((R, 32), rows.dtype)
    for k in range(m // 32):
        for w in range(width):
            acc = acc + a[:, k, :, w] * z[k, :, w]
    return acc


def kernel_walk(pc: ssh.BlockSchwarz, r: np.ndarray) -> np.ndarray:
    """csrc/block_schwarz.cu's data flow in numpy, in the working dtype of
    ``r``: the packed layout's tiles in turn (the block's residual gathered
    and zero-padded to the row stride; each row a warp's 16-byte lanes and
    shuffle tree; the coarse sum of the first tile's last warp), the coarse
    rows, then each node's rows in slot order plus its coarse value.  Every
    row is written by exactly one tile."""
    pk = ssh.pack_block_schwarz(pc)
    dt = r.dtype
    width = 16 // r.itemsize
    inv, inv_off = to_numpy(pk.inv).astype(dt), to_numpy(pk.inv_off)
    row_off, ids = to_numpy(pk.row_off), to_numpy(pk.ids)
    cids, cinv = to_numpy(pc.coarse_ids), to_numpy(pc.coarse_inv).astype(dt)
    N, nb = r.shape[0], len(row_off) - 1
    yb = np.full(len(ids), np.nan, dt)
    r0 = np.full(nb, np.nan, dt)
    for b, first, rows in to_numpy(pk.tiles):
        base, n = row_off[b], row_off[b + 1] - row_off[b]
        stride = -(-n // ssh.SCHWARZ_ALIGN) * ssh.SCHWARZ_ALIGN
        rb = np.zeros(stride, dt)
        own = ids[base:base + n]
        ok = (own >= 0) & (own < N)
        rb[:n][ok] = r[own[ok]]
        if first == 0:
            c = cids[b]
            c = np.where((c >= 0) & (c < N), r[np.clip(c, 0, N - 1)], 0)
            r0[b] = warp_tree(lane_sums(c.astype(dt)[None], np.ones(
                len(c), dt), 1))[0]
        blk = inv[inv_off[b]:inv_off[b] + n * stride].reshape(n, stride)
        sel = np.arange(first, first + rows)
        assert np.isnan(yb[base + sel]).all(), "a row written twice"
        yb[base + sel] = warp_tree(lane_sums(blk[sel], rb, width))
    assert not np.isnan(yb).any() and not np.isnan(r0).any()
    y0 = warp_tree(lane_sums(cinv, r0, 1))
    y = np.zeros(N, dt)
    for f in to_numpy(pk.node_slots).T:        # slot order
        y = y + np.where(f >= 0, yb[np.maximum(f, 0)], 0)
    part = to_numpy(pc.coarse_part)
    return y + np.where(part >= 0, y0[np.maximum(part, 0)], 0)


def assert_packing_round_trips(pc: ssh.BlockSchwarz):
    pk = ssh.pack_block_schwarz(pc)
    names = ("block_ids", "inv_blocks", "node_slots", "node_slot_valid")
    for name, got in zip(names, ssh.unpack_block_schwarz(pk)):
        want = getattr(pc, name)
        assert got.dtype == want.dtype and torch.equal(got, want), name
    # only the blocks' own entries, at the aligned stride
    n = np.diff(to_numpy(pk.row_off))
    stride = -(-n // ssh.SCHWARZ_ALIGN) * ssh.SCHWARZ_ALIGN
    assert pk.inv.shape == (int((n * stride).sum()),)
    assert (stride % ssh.SCHWARZ_ALIGN == 0).all() and \
        (to_numpy(pk.inv_off) % ssh.SCHWARZ_ALIGN == 0).all()
    assert n.max() == pk.max_rows <= pc.block_ids.shape[1]
    # the tiles cover each block's rows in order, none past the byte cap
    tiles = to_numpy(pk.tiles)
    assert (tiles[:, 2] <= ssh.SCHWARZ_TILE_ROWS).all()
    assert pk.max_tile == (tiles[:, 2] * stride[tiles[:, 0]]).max()
    assert pk.max_tile * pc.inv_blocks.element_size() <= \
        max(ssh.SCHWARZ_TILE_BYTES, stride.max() * 8)
    for b in range(len(n)):
        t = tiles[tiles[:, 0] == b]
        assert len(t) >= 1 and t[0, 1] == 0 and t[:, 2].sum() == n[b]
        assert (t[1:, 1] == np.cumsum(t[:, 2])[:-1]).all()
    # every block's first tile before any second one, in block order
    assert np.array_equal(tiles[:len(n), 0], np.arange(len(n)))
    assert (tiles[:len(n), 1] == 0).all() and (tiles[len(n):, 1] > 0).all()
    return pk


def test_block_schwarz_packing_round_trips(meshes, cfg):
    """Unpacking the kernel's layout gives the JAX-equal padded tables bit
    for bit; the blocks' extents are their node counts."""
    _, tm = meshes
    pc = ssh.build_block_schwarz(tm, cfg, BLOCK)
    pk = assert_packing_round_trips(pc)
    assert np.array_equal(np.diff(to_numpy(pk.row_off)),
                          (to_numpy(pc.block_ids) >= 0).sum(1))


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-13),
                                       (np.float32, 1e-5)])
def test_block_schwarz_kernel_walk_matches_plain_and_jax(meshes, cfg, dtype,
                                                         tol):
    jm, tm = meshes
    r = _field(np.random.default_rng(7), tm.n_nodes)
    pc = ssh.build_block_schwarz(tm, cfg, BLOCK)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    pc_t = ssh.BlockSchwarz(*(v.to(tdt) if v.is_floating_point() else v
                              for v in (getattr(pc, f.name) for f in
                                        dataclasses.fields(pc))))
    got = kernel_walk(pc_t, r.astype(dtype))
    plain = to_numpy(ssh.block_schwarz_plain(pc_t, torch.as_tensor(
        r.astype(dtype))))
    assert np.abs(got - plain).max() <= tol * np.abs(plain).max()
    ref = np.asarray(jssh.build_block_schwarz(jm, cfg, block_size=BLOCK)(
        jnp.asarray(r)))
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def test_block_schwarz_launch_arguments(meshes, cfg, monkeypatch):
    """The launch, recorded on the CPU: the C signature's arguments, the
    packed tables' shapes, the scratch of one value a row."""
    _, tm = meshes
    pc = ssh.build_block_schwarz(tm, cfg, BLOCK)
    pk = ssh.pack_block_schwarz(pc)
    calls = []

    def record(kernel, device, *args, entry=""):
        sig = kernels._ARGTYPES[kernel + entry]
        assert len(args) + 1 == len(sig)
        for a, typ in zip(args, sig):
            if typ is ctypes.c_void_p:
                assert isinstance(a, torch.Tensor) and a.is_contiguous()
            else:
                assert type(a) is int
        calls.append(args)

    monkeypatch.setattr(kernels, "launch", record)
    r = torch.zeros(tm.n_nodes, dtype=torch.float64)
    assert ssh._block_schwarz_launch(pc, pk, r).shape == (tm.n_nodes,)
    (args,) = calls
    n_rows = int(pk.row_off[-1])
    assert args[1] == tm.n_nodes and args[3] == pk.tiles.shape[0]
    assert args[8] == 6 and args[9] == pk.max_rows
    assert args[10] == pk.max_tile <= pk.max_rows * ssh.SCHWARZ_TILE_ROWS
    assert args[17] is pk.counter and pk.counter.tolist() == [0, 0]
    assert args[18].shape == (n_rows,) and args[19] == n_rows
    with pytest.raises(ValueError, match="dtype"):
        ssh._block_schwarz_launch(pc, pk, r.float())


# --------------------------------------------------------------------------
# the step with CG forced
# --------------------------------------------------------------------------
@pytest.mark.parametrize("which_ale", ["zstar", "linfs"])
def test_three_cg_steps_match_jax(mesh_dir, monkeypatch, which_ale):
    monkeypatch.setattr(jax_model, "DENSE_SSH_MAX_NODES", 0)
    monkeypatch.setattr(port_model, "DENSE_SSH_MAX_NODES", 0)
    jm = jax_model.setup_soufflet_model(mesh_path=mesh_dir,
                                        which_ale=which_ale)
    tm = port_model.setup_soufflet_model(mesh_dir, device="cpu",
                                         which_ale=which_ale)
    assert jm.ssh_dense_inv is None and tm.ssh_dense_inv is None
    assert isinstance(tm.ssh_ring, ssh.RingALE if which_ale == "zstar"
                      else ssh.RingOperator)
    js = jm.initial_state()
    ts = state_from_numpy({f.name: np.asarray(getattr(js, f.name))
                           for f in dataclasses.fields(js)}, "cpu")
    jstep, jf = jm.step_fn(), jax_zero_forcing(jm.mesh)
    tstep, tf = tm.step_fn(), zero_forcing(tm.mesh)
    kernels.reset_launches()
    for _ in range(3):
        js = jstep(js, jf)
        ts = tstep(ts, tf)
        assert tm.ssh_iters >= 1
    for name in FIELDS + ("d_eta_prev",):
        assert rel_err(getattr(ts, name), getattr(js, name)) <= 1e-8, name
    assert float(ts.d_eta.abs().max()) > 0.0
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
