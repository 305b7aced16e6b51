"""Each hand-written CUDA kernel against its plain torch version, on the
card, at a small size (the channel of 8 x 24 nodes, 10 layers; the gather
probe at G=16, W=64, T=32, NL=8; the column kernels pressure_bv and
kpp_column on the level-3 globe with 20 layers, partial cells; the cluster
kernels elem_to_node_mean and fct_bounds there too, with 19 layers; the
sea ice's elem_contrib_to_nodes and mevp_subcycles on the level-3 globe
and its ice subdomain, mevp_subcycles also on the whole level-7 globe, more
elements than the resident grid has threads, and the EVP and aEVP
variants of the subcycle kernel on all three; ring_spmv at every ring width
with a kernel of its own and at two the generic kernel takes; Icepack's
bl99_temperature_solve and itd_remap on the inputs of the first Icepack
coupled step on the level-3 and level-7 globes, and on the level-3 globe
under MU71, the similarity coefficients, 7 ice / 1 snow layers, no column
and a chunk schedule whose stop falls inside a chunk, and mevp_subcycles with its strength field on the whole level-7 globe;
dens_moc_bin on the level-3 globe's state after two coupled steps, with
odd layers; both kernels raise without nvcc; block_schwarz on the
channel's tables and on crafted blocks of unequal sizes, one node, none,
n_b off the row stride and a block past 48 KB of shared memory, with no
fallback to the plain version).

These tests need an NVIDIA GPU and skip without one.  They import no JAX,
so they run on a machine that has only torch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerance: 1e-12 (float64) and 1e-5 (float32) of max|plain|; fct_bounds,
tridiag_solve, the two probe kernels, the two ice kernels, itd_remap and
the ring_spmv width cases bitwise; bl99_temperature_solve with the plain
version's sweep count and melting flags;
pressure_bv's mld2 equal in float64.  ``chip_smoke.py`` makes the same
comparison at full size.
"""
import contextlib
import dataclasses
import inspect
import types

import numpy as np
import pytest
import torch

from fesom2_tpu_torch import kernels
from fesom2_tpu_torch.core import eos, ops, ssh, tracers
from fesom2_tpu_torch.core.mixing import kpp
from fesom2_tpu_torch.core.state import (allocate_state, initial_z3d,
                                         init_thickness_linfs)
from fesom2_tpu_torch.mesh import (build_mesh, build_mesh_from_raw, cluster,
                                   globe)
from fesom2_tpu_torch.mesh.channel import channel_raw_mesh
from fesom2_tpu_torch.model import pi_config, soufflet_config
from fesom2_tpu_torch.scripts import gather_cost_model as probe

NLAY = 10


@pytest.fixture(scope="module")
def mesh():
    return build_mesh_from_raw(channel_raw_mesh(8, 24, NLAY, dz=400.0),
                               cyclic_length_deg=4.5, device="cpu")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _on_card(obj, dtype):
    """A copy of a dataclass of tensors on the card, floats in dtype."""
    dev = torch.device("cuda")
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = v.to(dev)
            if v.is_floating_point():
                v = v.to(dtype)
        elif dataclasses.is_dataclass(v):
            v = _on_card(v, dtype)
        kw[f.name] = v
    return type(obj)(**kw)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_kernels_match_plain_on_card(mesh, rng, dtype, tol):
    _need_card()
    m = _on_card(mesh, dtype)
    dev = torch.device("cuda")

    def r(*shape, lo=-1.0, hi=1.0):
        return torch.as_tensor(rng.uniform(lo, hi, shape), device=dev).to(dtype)

    def check(got, want):
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert float((g - w).abs().max()) <= tol * float(w.abs().max())

    f = r(2, NLAY, m.n_edges)
    assert torch.equal(ops.edge_divergence(f, m),
                       ops.edge_divergence_plain(f, m))
    assert all(torch.equal(g, w) for g, w in zip(
        ops.edge_signed_reduce2(f, m), ops.edge_signed_reduce2_plain(f, m)))
    x = r(2, NLAY, m.n_elems)
    for respect in (True, False):
        check(ops.elem_to_node_mean(x, m, respect),
              ops.elem_to_node_mean_plain(x, m, respect))
    check(ops.elem_to_node_mean_flat(x[0], m),
          ops.elem_to_node_mean_flat_plain(x[0], m))
    a, c = r(NLAY, 50, lo=-0.4, hi=0.0), r(NLAY, 50, lo=-0.4, hi=0.0)
    b, d = r(NLAY, 50, lo=1.0, hi=2.0), r(2, NLAY, 50)
    assert torch.equal(ops.tridiag_solve(a, b, c, d),
                       ops.tridiag_solve_plain(a, b, c, d))
    ttf, lo = r(2, NLAY, m.n_nodes), r(2, NLAY, m.n_nodes)
    got = tracers.fct_bounds(ttf, lo, m)
    want = tracers.fct_bounds_plain(ttf, lo, m)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    ttf[0, 3, 50] = float("nan")        # a NaN spreads as in torch.maximum
    got = tracers.fct_bounds(ttf, lo, m)
    want = tracers.fct_bounds_plain(ttf, lo, m)
    for g, w in zip(got, want):
        assert torch.equal(g.isnan(), w.isnan()) and bool(w.isnan().any())
        assert torch.equal(g[~g.isnan()], w[~w.isnan()])


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [32, 256])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_cluster_kernels_on_varying_depth_on_card(tmp_path, rng, dtype, tol,
                                                  tile):
    """elem_to_node_mean and fct_bounds on the level-3 globe with 19
    layers (no multiple of a level chunk) and columns of 5 to 19 levels,
    with tiles smaller than the mesh (16 of them, the last one ragged)
    and larger; 1, 2 and 4 rows."""
    _need_card()
    path = globe.write_globe(str(tmp_path), level=3, n_layers=19,
                             dz_bottom=600.0)
    m = build_mesh(path, force_rotation=True, use_partial_cell=True,
                   device="cuda", dtype=dtype)
    m = dataclasses.replace(m, cluster=cluster.build_cluster_tables(m, tile))
    assert int(m.nlevels_node.min()) == 5
    L = m.nl - 1
    put = lambda a: torch.as_tensor(a, device="cuda").to(dtype)
    kernels.reset_launches()
    for rows in ((), (2,), (2, 2)):
        x = put(rng.uniform(-1, 1, rows + (L, m.n_elems)))
        for respect in (True, False):
            got = ops.elem_to_node_mean(x, m, respect)
            want = ops.elem_to_node_mean_plain(x, m, respect)
            assert float((got - want).abs().max()) \
                <= tol * float(want.abs().max())
    assert kernels.LAUNCHES["elem_to_node_mean"] == 6
    for ntr in (1, 2, 3):
        ttf = put(rng.uniform(0, 30, (ntr, L, m.n_nodes)))
        lo = put(rng.uniform(0, 30, (ntr, L, m.n_nodes)))
        ttf[0, 2, 40] = float("nan")
        got = tracers.fct_bounds(ttf, lo, m)
        want = tracers.fct_bounds_plain(ttf, lo, m)
        for g, w in zip(got, want):
            assert torch.equal(g.isnan(), w.isnan()) and bool(w.isnan().any())
            assert torch.equal(g.nan_to_num(), w.nan_to_num())
        # every value under the -1e3 filler: the filler-free levels
        got = tracers.fct_bounds(ttf - 5e3, lo - 5e3, m)
        want = tracers.fct_bounds_plain(ttf - 5e3, lo - 5e3, m)
        assert all(torch.equal(g.nan_to_num(), w.nan_to_num())
                   for g, w in zip(got, want))
    assert kernels.LAUNCHES["fct_bounds"] == 6


@pytest.mark.cuda
def test_refused_launch_raises_and_leaves_no_error_behind(mesh):
    """More shared memory than a block may have: the launch raises, and
    the next launch of the kernel is not blamed for it."""
    _need_card()
    m = _on_card(mesh, torch.float64)
    x = torch.zeros(2, NLAY, m.n_elems, dtype=torch.float64, device="cuda")
    huge = dataclasses.replace(m, cluster=dataclasses.replace(
        m.cluster, mean_u_max=40000))
    with pytest.raises(RuntimeError):
        ops.elem_to_node_mean(x, huge)
    assert torch.equal(ops.elem_to_node_mean(x, m), torch.zeros(
        2, NLAY, m.n_nodes, dtype=torch.float64, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_ssh_kernels_match_plain_on_card(mesh, rng, dtype, tol):
    """ring_spmv and block_schwarz (six blocks of about 32 nodes)."""
    _need_card()
    cfg = soufflet_config()
    ring = _on_card(ssh.build_ssh_ring(mesh, cfg), dtype)
    pc = _on_card(ssh.build_block_schwarz(mesh, cfg, block_size=32), dtype)
    assert pc.block_ids.shape[0] > 1
    x = torch.as_tensor(rng.uniform(-1, 1, mesh.n_nodes),
                        device="cuda").to(dtype)
    kernels.reset_launches()
    for got, want in ((ring(x), ssh.ring_spmv_plain(ring.cols, ring.vals, x)),
                      (pc(x), ssh.block_schwarz_plain(pc, x))):
        assert float((got - want).abs().max()) \
            <= tol * float(want.abs().max())
    assert kernels.LAUNCHES["ring_spmv"] == 1
    assert kernels.LAUNCHES["block_schwarz"] == 1


def _crafted_schwarz(rng, sizes, n_nodes, pad=3):
    """A BlockSchwarz of blocks of ``sizes`` nodes (drawn with overlap from
    ``n_nodes``), padded to K = max + ``pad`` as the builder pads (-1 ids,
    an identity past each block), seeded values for the inverses and the
    coarse level, every node in some block's coarse part."""
    nb, K = len(sizes), max(sizes) + pad
    ids = np.full((nb, K), -1)
    inv = np.tile(np.eye(K), (nb, 1, 1))
    memb = [[] for _ in range(n_nodes)]
    for b, n in enumerate(sizes):
        ids[b, :n] = rng.choice(n_nodes, n, replace=False)
        inv[b, :n, :n] = rng.uniform(-1, 1, (n, n))
        for p_, nid in enumerate(ids[b, :n]):
            memb[nid].append(b * K + p_)
    S = max(1, max(len(m) for m in memb))
    slots = np.zeros((n_nodes, S), np.int64)
    valid = np.zeros((n_nodes, S), bool)
    for nid, m in enumerate(memb):
        slots[nid, :len(m)], valid[nid, :len(m)] = m, True
    part = rng.integers(0, nb, n_nodes)
    Kc = max(1, int(np.bincount(part, minlength=nb).max()))
    cids = np.full((nb, Kc), -1)
    for b in range(nb):
        own = np.nonzero(part == b)[0]
        cids[b, :len(own)] = own
    i32 = lambda a: torch.as_tensor(np.asarray(a).astype(np.int32))
    return ssh.BlockSchwarz(i32(ids), torch.as_tensor(inv), i32(slots),
                            torch.as_tensor(valid), i32(cids),
                            torch.as_tensor(rng.uniform(-1, 1, (nb, nb))),
                            i32(part))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("sizes", [
    [1, 0, 37, 64, 33, 130, 2, 0],     # one node, empty, ragged, 5 tiles
    [5, 6, 7, 8, 9, 31, 32, 33, 65],   # n_b around the stride and tiles
    [0]])                              # nothing but an empty block
def test_block_schwarz_packed_blocks_on_card(rng, dtype, tol, sizes):
    """The kernel on blocks of unequal sizes, n_b not a multiple of the
    row stride, a block of one node and empty blocks: within the
    tolerance of the plain version on the padded tables, the same bits on
    a second call, one launch a call; the packing made on the card
    unpacks to the padded tables bit for bit."""
    _need_card()
    pc = _on_card(_crafted_schwarz(rng, sizes, 300), dtype)
    x = torch.as_tensor(rng.uniform(-1, 1, 300), device="cuda").to(dtype)
    kernels.reset_launches()
    got = pc(x)
    again = ssh.block_schwarz(pc, x)
    want = ssh.block_schwarz_plain(pc, x)
    assert kernels.LAUNCHES["block_schwarz"] == 2
    assert torch.equal(got, again)
    assert float((got - want).abs().max()) \
        <= tol * max(float(want.abs().max()), 1e-300)
    names = ("block_ids", "inv_blocks", "node_slots", "node_slot_valid")
    for name, t in zip(names, ssh.unpack_block_schwarz(pc.packed)):
        assert t.device.type == "cuda" and torch.equal(t, getattr(pc, name))


@pytest.mark.cuda
def test_block_schwarz_block_past_48kb_on_card(rng):
    """A block of 6,200 nodes: its residual takes more than 48 KB of
    shared memory in float64, which the launch asks for."""
    _need_card()
    pc = _on_card(_crafted_schwarz(rng, [6200, 40], 7000), torch.float64)
    x = torch.as_tensor(rng.uniform(-1, 1, 7000), device="cuda")
    got, want = pc(x), ssh.block_schwarz_plain(pc, x)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


@pytest.mark.cuda
def test_block_schwarz_does_not_fall_back_on_card(mesh, monkeypatch):
    """A dtype the packed tables do not hold, and a failed build, raise on
    a CUDA tensor: the plain version is never run."""
    _need_card()
    from fesom2_tpu_torch.kernels import build
    called = []
    plain = ssh.block_schwarz_plain
    monkeypatch.setattr(ssh, "block_schwarz_plain",
                        lambda *a: called.append(a) or plain(*a))
    pc = _on_card(ssh.build_block_schwarz(mesh, soufflet_config(),
                                          block_size=32), torch.float64)
    x = torch.zeros(mesh.n_nodes, dtype=torch.float64, device="cuda")
    with pytest.raises(ValueError, match="dtype"):
        pc(x.float())
    monkeypatch.setattr(kernels, "_LIB", None)
    monkeypatch.setattr(build, "library_path",
                        lambda: build.BUILD_DIR / "absent" / "none.so")
    monkeypatch.setattr(build, "find_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc"):
        pc(x)
    assert not called


@pytest.mark.cuda
def test_probe_kernels_match_plain_on_card():
    """window_gather and onehot_gather equal their plain versions and each
    other bitwise, an index outside [0, W) giving a NaN row in all four."""
    _need_card()
    vals, idx = probe.probe_inputs(G=16, W=64, T=32, NL=8)
    idx[0, 0], idx[3, 7], idx[5, 31] = 64, 1000, -70
    vals = torch.as_tensor(vals, device="cuda")
    idx = torch.as_tensor(idx, device="cuda")
    outs = [probe.window_gather(vals, idx), probe.onehot_gather(vals, idx),
            probe.window_gather_plain(vals, idx),
            probe.onehot_gather_plain(vals, idx)]
    for o in outs:
        assert int(o.isnan().any(-1).sum()) == 3
        assert torch.equal(o.isnan(), outs[0].isnan())
        assert torch.equal(o.nan_to_num(), outs[0].nan_to_num())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [dict(G=3, W=200, T=300, NL=50),
                                   dict(G=2, W=128, T=16, NL=7),
                                   dict(G=2, W=1, T=5, NL=100)],
                         ids=["ragged", "narrow_unaligned", "one_row_window"])
def test_onehot_gather_ragged_shapes_on_card(shape):
    """Windows that are no multiple of a staged chunk, more outputs than a
    block's 256, columns beyond one block's 48 and rows that are no
    multiple of 16 bytes; huge and negative values."""
    _need_card()
    vals, idx = probe.probe_inputs(**shape)
    vals[0] *= np.float32(1e30)
    vals[-1] = -np.abs(vals[-1])
    idx[0, 0], idx[1, 3] = shape["W"], -1
    vals = torch.as_tensor(vals, device="cuda")
    idx = torch.as_tensor(idx, device="cuda")
    got = probe.onehot_gather(vals, idx)
    for want in (probe.window_gather_plain(vals, idx),
                 probe.onehot_gather_emulation(vals, idx)):
        assert int(want.isnan().any(-1).sum()) == 2
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [0, 1, 3], ids=["KE", "KE+1", "KE+3"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_node_edge_reduce_equals_slot_order_sum_on_card(mesh, rng, dtype,
                                                        extra):
    """Bit-equal to the table walk's emulation (slots summed in order) for
    KE held in registers (6, 7) and KE above that (9, read per row), with
    1, 3 and 2 x 10 rows (runs of 4 rows and a remainder)."""
    _need_card()
    m = mesh
    if extra:
        N = m.n_nodes
        m = dataclasses.replace(
            m, node_edges=torch.cat([m.node_edges, torch.full(
                (N, extra), -1, dtype=torch.int32)], 1),
            node_edge_sign=torch.cat([m.node_edge_sign, torch.zeros(
                (N, extra), dtype=m.node_edge_sign.dtype)], 1))
        m = dataclasses.replace(m, cluster=cluster.build_cluster_tables(m))
    m = _on_card(m, dtype)
    assert m.cluster.edge_slot.shape[0] == mesh.node_edges.shape[1] + extra
    for rows in ((), (3,), (2, NLAY)):
        f = torch.as_tensor(rng.uniform(-1, 1, rows + (m.n_edges,)),
                            device="cuda").to(dtype)
        assert torch.equal(ops.edge_divergence(f, m),
                           cluster.edge_reduce_emulation(f, m.cluster))
        for g, w in zip(ops.edge_signed_reduce2(f, m),
                        cluster.edge_reduce_emulation(f, m.cluster, True)):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_column_kernels_match_plain_on_card(tmp_path, rng, dtype, tol):
    """pressure_bv (JM, linear, soufflet EoS) and kpp_column (double
    diffusion off and on) on columns of varying depth."""
    _need_card()
    path = globe.write_globe(str(tmp_path), level=3, n_layers=20,
                             dz_bottom=600.0)
    m = build_mesh(path, force_rotation=True, use_partial_cell=True,
                   device="cuda", dtype=dtype)
    fx = globe.globe_fixtures(*(x.cpu().numpy() for x in (
        m.geo_coords[:, 1], m.elem_nodes, m.Z, m.nlevels_node, m.area[0])))
    put = lambda a: torch.as_tensor(a, device="cuda").to(dtype)
    wet = m.node_layer_mask
    st = init_thickness_linfs(allocate_state(m, 2, dtype), m)
    st = dataclasses.replace(
        st, tr=put(np.stack([fx["T"], fx["S"]])),
        unode=put(rng.uniform(-0.3, 0.3, wet.shape)) * wet,
        vnode=put(rng.uniform(-0.3, 0.3, wet.shape)) * wet)
    dref = eos.reference_density(m, initial_z3d(m, dtype)[1], 1)
    kernels.reset_launches()
    for se, toy in ((1, False), (0, False), (0, True)):
        cfg = soufflet_config() if toy else pi_config()
        cfg.dyn.state_equation = se
        got = eos.pressure_bv(st, m, cfg, dref)
        want = eos.pressure_bv_plain(st, m, cfg, dref)
        for name in ("density_m_rho0", "hpressure", "bvfreq", "dbsfc",
                     "mld2"):
            g, w = getattr(got, name), getattr(want, name)
            assert float((g - w).abs().max()) <= tol * float(w.abs().max())
    st = eos.pressure_bv_plain(st, m, pi_config(), dref)
    a, b = eos.sw_alpha_beta(st.tr[0], st.tr[1], st.Z_3d)
    Bo = -9.81 * (a[0] * put(fx["heat_flux"]) / 4.2e6
                  + b[0] * put(fx["water_flux"]) * st.tr[1, 0])
    ustar = put(rng.uniform(0.0, 0.02, m.n_nodes))
    for dd in (False, True):
        args = (st.unode, st.vnode, st.bvfreq, st.dbsfc, st.zbar_3d, st.Z_3d,
                st.hnode, ustar, Bo, m.coriolis_node, m.nlevels_node,
                pi_config(), dd, a, b, st.tr[0], st.tr[1])
        for g, w in zip(kpp.kpp_column(*args), kpp.kpp_column_plain(*args)):
            if w is not None:
                assert float((g - w).abs().max()) \
                    <= tol * float(w.abs().max())
    assert kernels.LAUNCHES["pressure_bv"] == 3
    assert kernels.LAUNCHES["kpp_column"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ice_kernels_equal_plain_on_card(tmp_path, rng, dtype):
    """elem_contrib_to_nodes in both layouts, on the mesh and on the ice
    subdomain's tables, and one launch of mevp_subcycles after 1, 8 and
    120 subcycles, each bit-equal to its plain version (the same slot order and order of operations); a CUDA tensor
    never takes the plain path."""
    _need_card()
    from fesom2_tpu_torch.ice import evp
    from fesom2_tpu_torch.ice.state import (OceanSurface, allocate_ice,
                                            zero_ice_forcing)
    from fesom2_tpu_torch.ice.subdomain import build_ice_subdomain
    path = globe.write_globe(str(tmp_path), level=3, n_layers=12,
                             dz_bottom=1000.0)
    m = build_mesh(path, force_rotation=True, use_partial_cell=True,
                   device="cuda", dtype=dtype)
    sub = build_ice_subdomain(m, lat_deg=40.0)
    put = lambda a: torch.as_tensor(a, device="cuda").to(dtype)
    kernels.reset_launches()
    for tables in (m, sub):
        for vertex_major, fn in ((False, ops.elem_contrib_to_nodes),
                                 (True, ops.elem_contrib_to_nodes_3e)):
            E = tables.n_elems
            x = put(rng.standard_normal((2, 3, E) if vertex_major
                                        else (2, E, 3)))
            assert torch.equal(fn(x, tables), ops.elem_contrib_to_nodes_plain(
                x, tables, vertex_major))
    assert kernels.LAUNCHES["elem_contrib_to_nodes"] == 4
    N, E = m.n_nodes, m.n_elems
    u = lambda lo, hi, n=N: put(rng.uniform(lo, hi, n))
    ice = dataclasses.replace(
        allocate_ice(m, dtype), u_ice=u(-0.1, 0.1), v_ice=u(-0.1, 0.1),
        m_ice=u(0.0, 2.0), a_ice=u(0.0, 1.0), m_snow=u(0.0, 0.3),
        sigma11=u(-100.0, 100.0, E), sigma12=u(-100.0, 100.0, E),
        sigma22=u(-100.0, 100.0, E))
    forcing = dataclasses.replace(zero_ice_forcing(m, dtype),
                                  stress_atmice_x=u(-0.2, 0.2),
                                  stress_atmice_y=u(-0.2, 0.2))
    surf = OceanSurface(T_oc=u(-1.0, 1.0), S_oc=u(33.0, 35.0),
                        u_w=u(-0.05, 0.05), v_w=u(-0.05, 0.05),
                        elevation=u(-0.3, 0.3))
    ice, forcing, surf = evp.subdomain_inputs(ice, sub, forcing, surf)
    tab = evp.mevp_setup(ice, sub, forcing, surf, pi_config())
    uv0 = torch.stack([ice.u_ice, ice.v_ice])
    sig0 = torch.stack([ice.sigma11, ice.sigma12, ice.sigma22])
    for n in (1, 8, 120):
        want = evp.mevp_subcycles_plain(uv0, sig0, tab, sub, n)
        got = evp.mevp_subcycles(uv0.clone(), sig0.clone(), tab, sub, n)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert float((want[0] - uv0).abs().max()) > 0.0
    assert kernels.LAUNCHES["mevp_subcycles"] == 3
    assert N > sub.n_nodes


def _recut_column_state(tmp_path, rng, dtype):
    """The level-3 globe with 20 layers on the card, its columns recut to
    one wet layer (nlevels - 1 == 1) and to the full depth (nlevels - 1 ==
    L, with the standard depths), T/S of the fixtures: the cases of
    tests/test_torch_column_kernels.py."""
    path = globe.write_globe(str(tmp_path), level=3, n_layers=20,
                             dz_bottom=600.0)
    m = build_mesh(path, force_rotation=True, use_partial_cell=True,
                   device="cuda", dtype=dtype)
    fx = globe.globe_fixtures(*(x.cpu().numpy() for x in (
        m.geo_coords[:, 1], m.elem_nodes, m.Z, m.nlevels_node, m.area[0])))
    put = lambda a: torch.as_tensor(a, device="cuda").to(dtype)
    st = init_thickness_linfs(allocate_state(m, 2, dtype), m)
    nlev, mask, cut = globe.recut_columns(
        m.nlevels_node.cpu().numpy(), m.nl, m.zbar.cpu().numpy(),
        m.Z.cpu().numpy(), {k: getattr(st, k).cpu().numpy()
                            for k in ("Z_3d", "zbar_3d", "hnode")})
    st = dataclasses.replace(st, tr=put(np.stack([fx["T"], fx["S"]])),
                             **{k: put(v) for k, v in cut.items()})
    m = dataclasses.replace(
        m, nlevels_node=torch.as_tensor(nlev, dtype=m.nlevels_node.dtype,
                                        device="cuda"),
        node_layer_mask=torch.as_tensor(mask, device="cuda"))
    dref = eos.reference_density(m, initial_z3d(m, dtype)[1], 1)
    return m, st, dref, nlev


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_column_kernel_cases_on_card(tmp_path, rng, dtype, tol):
    """pressure_bv (JM, linear, soufflet EoS) and tridiag_solve on columns
    of one wet layer, of the full depth and of the globe's own depths, 501
    nodes (a ragged last tile); tridiag_solve bitwise with 1, 2 and 3
    right-hand sides on nodes and elements, nl - 1 rows, nl (gm_redi) and
    60 (dp in shared memory), identity rows below each column's bottom;
    pressure_bv within tol of max|plain|, mld2 equal in float64."""
    _need_card()
    m, st, dref, nlev = _recut_column_state(tmp_path, rng, dtype)
    assert m.n_nodes % 32 and m.n_elems % 32
    kernels.reset_launches()
    for se, toy in ((1, False), (0, False), (0, True)):
        cfg = soufflet_config() if toy else pi_config()
        cfg.dyn.state_equation = se
        got = eos.pressure_bv(st, m, cfg, dref)
        want = eos.pressure_bv_plain(st, m, cfg, dref)
        for name in ("density_m_rho0", "hpressure", "bvfreq", "dbsfc",
                     "mld2"):
            g, w = getattr(got, name), getattr(want, name)
            assert bool(torch.isfinite(w).all()), name
            assert float((g - w).abs().max()) <= tol * float(w.abs().max())
        if dtype == torch.float64:
            assert torch.equal(got.mld2, want.mld2)
        one = torch.as_tensor(nlev - 1 == 1, device="cuda")
        assert torch.equal(got.bvfreq[0, one], got.bvfreq[1, one])
    assert kernels.LAUNCHES["pressure_bv"] == 3
    put = lambda a: torch.as_tensor(a, device="cuda").to(dtype)
    # 60 rows: above the 48 levels whose dp the kernel keeps in registers
    for rows, nl_x in ((m.nl - 1, m.nlevels_node), (m.nl - 1, m.nlevels_elem),
                       (m.nl, m.nlevels_node), (60, m.nlevels_node)):
        X = nl_x.shape[0]
        active = (torch.arange(rows, device="cuda")[:, None]
                  < (nl_x.long() - 1)[None, :])
        def draw(lo, hi, lead=(), off=0.0):
            return torch.where(active, put(rng.uniform(lo, hi, lead + (
                rows, X))), off)
        for B in (1, 2, 3):
            a, c = draw(-0.4, 0.0), draw(-0.4, 0.0)
            b, d = draw(1.0, 2.0, off=1.0), draw(-1.0, 1.0, (B,))
            assert torch.equal(ops.tridiag_solve(a, b, c, d),
                               ops.tridiag_solve_plain(a, b, c, d))
        x = ops.tridiag_solve(a, b, c, d[0])        # d [L, X]: one rhs
        assert torch.equal(x, ops.tridiag_solve_plain(a, b, c, d[0]))
    assert kernels.LAUNCHES["tridiag_solve"] == 16


# --------------------------------------------------------------------------
# ring_spmv's slot order and mevp_subcycles' refused launch (CPU)
# --------------------------------------------------------------------------
def random_ring(rng, kr, n, dtype):
    """A ring [kr, n]: random columns, a third of the slots padded (the
    node itself, value 0), as ``build_ssh_ring`` pads."""
    cols = rng.integers(0, n, (kr, n))
    vals = rng.uniform(-1.0, 1.0, (kr, n))
    pad = rng.uniform(size=(kr, n)) < 0.3
    cols = np.where(pad, np.arange(n), cols).astype(np.int32)
    vals = np.where(pad, 0.0, vals).astype(dtype)
    return cols, vals, rng.uniform(-1.0, 1.0, n).astype(dtype)


def emulate_ring_spmv(cols, vals, x):
    """The kernels' data flow, a numpy lane per thread: a templated width
    (8, 10) loads all its 2 Kr table words, then gathers all Kr values,
    then adds in the order k = 0..Kr-1 from 0; the generic kernel does the
    same eight slots at a time, then one at a time."""
    kr = cols.shape[0]
    chunks = [(0, kr)] if kr in ssh.RING_TEMPLATED else \
        [(k, k + 8) for k in range(0, kr - kr % 8, 8)] \
        + [(k, k + 1) for k in range(kr - kr % 8, kr)]
    acc = np.zeros_like(x)
    for k0, k1 in chunks:
        c, v = cols[k0:k1].copy(), vals[k0:k1].copy()
        g = x[c]
        for k in range(k1 - k0):
            acc = acc + v[k] * g[k]
    return acc


@pytest.mark.parametrize("kr", [8, 10, 13])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ring_spmv_slot_order_equals_plain(rng, kr, dtype):
    cols, vals, x = random_ring(rng, kr, 5000, dtype)
    want = ssh.ring_spmv_plain(torch.from_numpy(cols).long(),
                               torch.from_numpy(vals), torch.from_numpy(x))
    assert np.array_equal(emulate_ring_spmv(cols, vals, x), want.numpy())
    assert (kr in ssh.RING_TEMPLATED) == (kr != 13)


def test_refused_cooperative_launch_raises(monkeypatch):
    """A cooperative launch the card refuses (too many blocks) raises
    through ``kernels.launch``, counts no launch, and nothing falls back to
    the plain loop: traced on the CPU with tensors that are not on it and
    a library that refuses."""
    class Refusing:
        def fesom_mevp_subcycles(self, *args):
            return 82            # cudaErrorCooperativeLaunchTooLarge

        def fesom_error_string(self, err):
            return b"too many blocks in cooperative launch"

    from fesom2_tpu_torch.ice import evp
    monkeypatch.setattr(kernels, "_LIB", Refusing())
    monkeypatch.setattr(kernels, "cuda_only", lambda x, what: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(evp, "mevp_subcycles_plain", None)
    N, E, K = 40, 60, 6
    meta = lambda *shape, dtype=torch.float64: torch.empty(
        shape, dtype=dtype, device="meta")
    mesh = types.SimpleNamespace(n_nodes=N, n_elems=E,
                                 elem_slot=meta(K, N, dtype=torch.int32))
    tab = evp.MevpTables(
        node_c=meta(13, N), elem_c=meta(10, E),
        en=meta(3, E, dtype=torch.int32), fuv=meta(2, E, 3),
        det1=0.5, vale=0.25, delta_min=1e-11, rdt=1800.0, rdt_cd=9.9,
        beta=500.0)
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="cooperative launch"):
        evp.mevp_subcycles(meta(2, N), meta(3, E), tab, mesh, 120)
    assert kernels.LAUNCHES["mevp_subcycles"] == 0


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ring_spmv_every_width_bitwise_on_card(rng, dtype):
    """ring_spmv bit-equal to ring_spmv_plain at the templated widths (8,
    10) and at two the generic kernel takes (7, 13); a column outside [0,
    N) makes its node NaN and no other."""
    _need_card()
    npd = np.float64 if dtype == torch.float64 else np.float32
    kernels.reset_launches()
    for kr in (8, 10, 7, 13):
        cols, vals, x = (torch.as_tensor(a, device="cuda")
                         for a in random_ring(rng, kr, 46000, npd))
        assert torch.equal(ssh.ring_spmv(cols, vals, x),
                           ssh.ring_spmv_plain(cols, vals, x))
        bad = cols.clone()
        bad[kr - 1, 5] = 46000
        y = ssh.ring_spmv(bad, vals, x)
        assert bool(y[5].isnan()) and int(y.isnan().sum()) == 1
    assert kernels.LAUNCHES["ring_spmv"] == 8
    with pytest.raises(ValueError, match="Kr"):
        ssh.ring_spmv(torch.zeros((65, 10), dtype=torch.int32, device="cuda"),
                      torch.zeros((65, 10), dtype=dtype, device="cuda"),
                      torch.zeros(10, dtype=dtype, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_mevp_subcycles_whole_globe_on_card(tmp_path, rng, dtype):
    """mevp_subcycles on the whole level-7 globe (225,854 elements, more
    than the resident grid has threads: items walked grid-stride, or
    staged per block where they fit) after 1, 8 and 120 subcycles,
    bit-equal to the plain loop."""
    _need_card()
    from fesom2_tpu_torch.ice import evp
    from fesom2_tpu_torch.ice.state import (OceanSurface, allocate_ice,
                                            zero_ice_forcing)
    path = globe.write_globe(str(tmp_path), level=7)
    m = build_mesh(path, force_rotation=True, use_partial_cell=True,
                   device="cuda", dtype=dtype)
    N, E = m.n_nodes, m.n_elems
    assert E == 225854
    put = lambda a: torch.as_tensor(a, device="cuda").to(dtype)
    u = lambda lo, hi, n=N: put(rng.uniform(lo, hi, n))
    ice = dataclasses.replace(
        allocate_ice(m, dtype), u_ice=u(-0.1, 0.1), v_ice=u(-0.1, 0.1),
        m_ice=u(0.0, 2.0), a_ice=u(0.0, 1.0), m_snow=u(0.0, 0.3),
        sigma11=u(-100.0, 100.0, E), sigma12=u(-100.0, 100.0, E),
        sigma22=u(-100.0, 100.0, E))
    forcing = dataclasses.replace(zero_ice_forcing(m, dtype),
                                  stress_atmice_x=u(-0.2, 0.2),
                                  stress_atmice_y=u(-0.2, 0.2))
    surf = OceanSurface(T_oc=u(-1.0, 1.0), S_oc=u(33.0, 35.0),
                        u_w=u(-0.05, 0.05), v_w=u(-0.05, 0.05),
                        elevation=u(-0.3, 0.3))
    tab = evp.mevp_setup(ice, m, forcing, surf, pi_config())
    uv0 = torch.stack([ice.u_ice, ice.v_ice])
    sig0 = torch.stack([ice.sigma11, ice.sigma12, ice.sigma22])
    K = m.cluster.elem_slot.shape[0]
    plan = evp.mevp_subcycles_plan("cuda", dtype, N, E, K)
    print(f"whole globe {dtype}: {plan}")
    assert plan["grid"] * plan["block"] < E
    kernels.reset_launches()
    for n in (1, 8, 120):
        want = evp.mevp_subcycles_plain(uv0, sig0, tab, m, n)
        got = evp.mevp_subcycles(uv0.clone(), sig0.clone(), tab, m, n)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert kernels.LAUNCHES["mevp_subcycles"] == 3


def _random_ice(m, rng, dtype, alpha=False):
    """A seeded ice state, forcing and ocean surface on mesh ``m``, on the
    card in ``dtype``: ice on half the nodes, some just under 0.01."""
    from fesom2_tpu_torch.ice.state import (OceanSurface, allocate_ice,
                                            zero_ice_forcing)
    N, E = m.n_nodes, m.n_elems
    put = lambda a: torch.as_tensor(a, device="cuda").to(dtype)
    u = lambda lo, hi, n=N: put(rng.uniform(lo, hi, n))
    a_ice = np.where(rng.uniform(size=N) < 0.5, rng.uniform(0.2, 1.0, N), 0.0)
    a_ice[rng.uniform(size=N) < 0.05] = 0.009
    m_ice = np.where(a_ice > 0, rng.uniform(0.2, 2.5, N), 0.0)
    ice = dataclasses.replace(
        allocate_ice(m, dtype), u_ice=u(-0.1, 0.1), v_ice=u(-0.1, 0.1),
        m_ice=put(m_ice), a_ice=put(a_ice), m_snow=u(0.0, 0.3),
        sigma11=u(-100.0, 100.0, E), sigma12=u(-100.0, 100.0, E),
        sigma22=u(-100.0, 100.0, E))
    if alpha:
        ice = dataclasses.replace(ice, alpha_aevp=u(30.0, 400.0, E),
                                  beta_aevp=u(30.0, 400.0))
    forcing = dataclasses.replace(zero_ice_forcing(m, dtype),
                                  stress_atmice_x=u(-0.2, 0.2),
                                  stress_atmice_y=u(-0.2, 0.2))
    surf = OceanSurface(T_oc=u(-1.0, 1.0), S_oc=u(33.0, 35.0),
                        u_w=u(-0.05, 0.05), v_w=u(-0.05, 0.05),
                        elevation=u(-0.3, 0.3))
    return ice, forcing, surf


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("which", [0, 2])
def test_evp_and_aevp_subcycles_on_card(tmp_path, rng, dtype, which):
    """evp_subcycles (whichEVP = 0) and aevp_subcycles (2) on the level-3
    globe, its ice subdomain and the whole level-7 globe (more elements
    than the resident grid has threads) after 1, 8 and 120 subcycles,
    bit-equal to the plain loops; a build or launch that fails raises
    for a CUDA tensor, and the plain loop is never taken."""
    _need_card()
    from fesom2_tpu_torch.ice import evp
    from fesom2_tpu_torch.ice.subdomain import build_ice_subdomain
    setup, plain, kernel, name = {
        0: (evp.evp_setup, evp.evp_subcycles_plain, evp.evp_subcycles,
            "evp_subcycles"),
        2: (evp.aevp_setup, evp.aevp_subcycles_plain, evp.aevp_subcycles,
            "aevp_subcycles")}[which]
    cfg = pi_config()
    cfg.ice.whichEVP = which
    kernels.reset_launches()
    launched = 0
    for level in (3, 7):
        path = globe.write_globe(str(tmp_path / f"l{level}"), level=level)
        m = build_mesh(path, force_rotation=True, use_partial_cell=True,
                       device="cuda", dtype=dtype)
        tables = [m] if level == 7 else [m, build_ice_subdomain(m, 40.0)]
        for t in tables:
            ice, forcing, surf = _random_ice(m, rng, dtype, which == 2)
            if t is not m:
                ice, forcing, surf = evp.subdomain_inputs(
                    ice, t, forcing, surf, aevp=which == 2)
            tab = setup(ice, t, forcing, surf, cfg)
            uv0 = torch.stack([ice.u_ice, ice.v_ice])
            sig0 = torch.stack([ice.sigma11, ice.sigma12, ice.sigma22])
            K = evp.elem_slot_of(t).shape[0]
            print(f"{name} level {level} {dtype} N={t.n_nodes}: "
                  f"{evp.mevp_subcycles_plan('cuda', dtype, t.n_nodes, t.n_elems, K, ('evp', 'mevp', 'aevp')[which])}")
            for n in (1, 8, 120):
                want = plain(uv0, sig0, tab, t, n)
                got = kernel(uv0.clone(), sig0.clone(), tab, t, n)
                torch.cuda.synchronize()
                assert torch.equal(got[0], want[0]), (level, n)
                assert torch.equal(got[1], want[1]), (level, n)
                launched += 1
    assert kernels.LAUNCHES[name] == launched
    assert kernels.LAUNCHES["mevp_subcycles"] == 0

    def broken():
        raise RuntimeError("nvcc failed: the build broke")
    saved = kernels.library
    kernels.library = broken
    try:
        with pytest.raises(RuntimeError, match="build broke"):
            kernel(uv0.clone(), sig0.clone(), tab, t, 2)
    finally:
        kernels.library = saved
    with pytest.raises(ValueError, match="node_c"):
        bad = dataclasses.replace(tab, node_c=tab.node_c[:-1].contiguous(),
                                  checked=False)
        kernel(uv0.clone(), sig0.clone(), bad, t, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_kernels_on_the_shelf_on_card(tmp_path, rng, dtype, tol):
    """The coupled CI step's column and cluster kernels under ice-shelf
    cavities: the level-3 globe with the shelf of ``globe.shelf_draft``,
    its state after one coupled step on the card.  pressure_bv (columns
    whose top lies below the surface) within tol of max|plain|,
    kpp_column bitwise in float64, fct_bounds bitwise and
    elem_to_node_mean within tol, on the shelf's tables and on tables
    with split neighbour runs (``test_torch_cluster_tables.split_mesh``),
    each against its plain version on the card."""
    _need_card()
    from test_torch_cluster_tables import split_mesh
    from fesom2_tpu_torch.mesh import read_raw_mesh
    from fesom2_tpu_torch.model import (pi_coupled_step_fn, pi_initial_state,
                                        setup_pi_model)
    path = globe.write_globe(str(tmp_path), level=3)
    draft = globe.shelf_draft(read_raw_mesh(path))
    model, atm = setup_pi_model(path, device="cuda", dtype=dtype,
                                cavity_depth=draft)
    m, cfg = model.mesh, model.cfg
    assert int((m.ulevels_node > 1).sum()) > 30
    st, ice = pi_initial_state(model)
    st, ice, forcing = pi_coupled_step_fn(model, atm)(st, ice, 0)

    def check(got, want, exact=False):
        for g, w in zip(got, want):
            assert torch.isfinite(w).all()
            if exact:
                assert torch.equal(g, w)
            else:
                assert float((g - w).abs().max()) <= tol * float(
                    w.abs().max())

    fields = ("density_m_rho0", "hpressure", "bvfreq", "dbsfc", "mld2")
    kernels.reset_launches()
    got = eos.pressure_bv(st, m, cfg, model.density_ref)
    assert kernels.LAUNCHES["pressure_bv"] == 1
    want = eos.pressure_bv_plain(st, m, cfg, model.density_ref)
    check([getattr(got, k) for k in fields], [getattr(want, k) for k in fields])
    if dtype == torch.float64:
        args = kpp.column_inputs(got, m, cfg, forcing)
        check([x for x in kpp.kpp_column(*args) if x is not None],
              [x for x in kpp.kpp_column_plain(*args) if x is not None],
              exact=True)
    split = _on_card(split_mesh(model.mesh.__class__(**{
        f.name: (getattr(m, f.name).cpu() if isinstance(
            getattr(m, f.name), torch.Tensor) else getattr(m, f.name))
        for f in dataclasses.fields(m) if f.name != "cluster"})), dtype)
    for mesh in (m, split):
        L, N, E = mesh.nl - 1, mesh.n_nodes, mesh.n_elems
        ttf, lo = (torch.as_tensor(rng.uniform(0, 30, (2, L, N)),
                                   device="cuda").to(dtype) for _ in range(2))
        check(tracers.fct_bounds(ttf, lo, mesh),
              tracers.fct_bounds_plain(ttf, lo, mesh), exact=True)
        x = torch.as_tensor(rng.uniform(-1, 1, (2, L, E)),
                            device="cuda").to(dtype)
        for respect in (True, False):
            check([ops.elem_to_node_mean(x, mesh, respect)],
                  [ops.elem_to_node_mean_plain(x, mesh, respect)])


def _icepack_step_inputs(path, dtype, opts=None):
    """The Icepack CI model on the globe at ``path`` on the card, with
    ``IcepackConfig(**opts)``, and the arguments its first coupled step
    hands ``temperature_solve`` and ``itd_remap`` (twice)."""
    from fesom2_tpu_torch.ice.icepack import (IcepackConfig, driver,
                                              init_icepack_state)
    from fesom2_tpu_torch.model import (pi_coupled_step_fn, pi_initial_state,
                                        setup_pi_model)
    cfg = pi_config()
    cfg.run.use_icepack = True
    cfg.icepack = IcepackConfig(**(opts or {}))
    model, atm = setup_pi_model(path, device="cuda", dtype=dtype, cfg=cfg)
    st, ice = pi_initial_state(model)
    ipk = init_icepack_state(cfg.icepack, ice.a_ice, ice.m_ice, ice.m_snow,
                             ice.t_skin, dtype=dtype)
    with driver.recording_kernel_inputs() as rec:
        pi_coupled_step_fn(model, atm)(st, ice, 0, ipk)
    return model, rec


def _check_icepack_kernels(rec, tol):
    """bl99_temperature_solve against its plain version (within tol of
    max|plain| per output, the same sweep count, the same melting flags)
    and itd_remap bitwise (both calls) on the recorded inputs; returns the
    solve's arguments."""
    from fesom2_tpu_torch.ice.icepack import itd
    from fesom2_tpu_torch.ice.icepack import thermo_vertical as tv
    assert len(rec["temperature_solve"]) == 1 and len(rec["itd_remap"]) == 2
    args, kw = rec["temperature_solve"][0]
    kernels.reset_launches()
    got = tv.temperature_solve(*args, **kw)
    assert kernels.LAUNCHES["bl99_temperature_solve"] == 1
    want = tv.temperature_solve_plain(*args, **kw)
    assert int(got["niter"]) == int(want["niter"]) > 1
    assert torch.equal(got["melting"], want["melting"])
    for k in ("Tsf", "Tsn", "Tin", "fsurf", "fcondtop", "fcondbot", "fsens",
              "flat", "flwout"):
        w = want[k]
        assert float((got[k] - w).abs().max()) <= tol * float(
            w.abs().max()), k
    for rargs, _ in rec["itd_remap"]:
        _check_itd_remap(rargs)
    return args, kw


def _check_itd_remap(args):
    """itd_remap on ``args`` (the eight category tensors, aicen_init,
    vicen_init, hin_max, linear): one launch, bitwise the plain version
    (NaN where it has NaN) and the plain version run on the first design's
    packed layout, the inputs untouched; returns the kernel's pack."""
    from fesom2_tpu_torch.ice.icepack import itd
    from fesom2_tpu_torch.scripts.timing import same_bits as _same_bits
    cats, rest = args[:8], args[8:]
    kept = [x.clone() for x in cats]
    kernels.reset_launches()
    got = itd.itd_remap(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["itd_remap"] == (1 if cats[0].shape[1] else 0)
    assert _same_bits(got, itd.itd_remap_plain(*args))
    old = itd.unpack_itd(itd.pack_itd(*cats), cats[4].shape[1],
                         cats[5].shape[1], cats[6].shape[1])
    assert _same_bits(got, itd.itd_remap_plain(*old, *rest))
    assert all(_same_bits(x, k) for x, k in zip(cats, kept))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("level", [3, 7])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_icepack_kernels_match_plain_on_card(tmp_path, level, dtype, tol):
    """bl99_temperature_solve (within tol of max|plain| per output, the
    same sweep count, the same melting flags) and itd_remap (bitwise, both
    calls) on the inputs of the first Icepack coupled step on the level-3
    globe and at full width (level 7); a wrong table raises."""
    _need_card()
    from fesom2_tpu_torch.ice.icepack import itd
    from fesom2_tpu_torch.ice.icepack import thermo_vertical as tv
    _, rec = _icepack_step_inputs(globe.write_globe(str(tmp_path),
                                                    level=level), dtype)
    args, kw = _check_icepack_kernels(rec, tol)
    rargs = rec["itd_remap"][0][0]
    with pytest.raises(ValueError):
        itd.itd_remap(rargs[0], rargs[1][:, :-1], *rargs[2:])
    with pytest.raises(ValueError):
        itd.itd_remap(*rargs[:10], list(rargs[10]) + [1e3], rargs[11])
    with pytest.raises(ValueError):
        tv.temperature_solve(*args[:2], args[2][:, :-1], *args[3:], **kw)


ICEPACK_VARIANTS = {
    # the MU71 conductivity instance
    "MU71": dict(conduct="MU71"),
    # the similarity transfer coefficients handed in as rows
    "similarity": dict(atmbndy="similarity"),
    # the generic-layer instance (nilyr, nslyr other than 4, 4)
    "layers_7_1": dict(nilyr=7, nslyr=1),
    # no column: the sweep count alone
    "empty": {},
    # no minimum of sweeps, and a fallback chunk length under which the
    # stop falls inside a chunk: the final pass's rerun
    "rerun": dict(niter_therm=1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ICEPACK_VARIANTS))
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_icepack_kernel_variants_match_plain_on_card(tmp_path, monkeypatch,
                                                     case, dtype, tol):
    """The instances and branches of bl99_temperature_solve (and the
    itd_remap rows) that the default IcepackConfig does not reach, on the
    inputs of the first Icepack coupled step on the level-3 globe, held as
    the default case is; with no column, the plain version's sweep count
    and empty outputs; under a fallback chunk length (found from the
    sweeps' maxima the default launch leaves in its slots) whose schedule
    puts the stop inside a chunk, the default's outputs bit for bit."""
    _need_card()
    from fesom2_tpu_torch.ice.icepack import thermo_vertical as tv
    opts = ICEPACK_VARIANTS[case]
    _, rec = _icepack_step_inputs(globe.write_globe(str(tmp_path), level=3),
                                  dtype, opts)
    if case == "empty":
        args, kw = rec["temperature_solve"][0]
        cut = lambda t: t[..., :0].contiguous() \
            if isinstance(t, torch.Tensor) else t
        args = [cut(a) for a in args]
        kw = {k: cut(v) for k, v in kw.items()}
        got = tv.temperature_solve(*args, **kw)
        want = tv.temperature_solve_plain(*args, **kw)
        assert int(got["niter"]) == int(want["niter"]) == args[0].niter_therm
        for k in tv.BL99_OUTPUTS[:-1]:
            assert got[k].shape == want[k].shape and got[k].numel() == 0, k
        return
    if case == "rerun":
        from fesom2_tpu_torch.scripts.bl99_dmoc_kernel_times import \
            bl99_entry
        args, kw = rec["temperature_solve"][0]
        bound = inspect.signature(tv.temperature_solve).bind(*args, **kw)
        bound.apply_defaults()
        call, _, slots = bl99_entry(kernels.library(), dict(bound.arguments))
        default = call()
        bits = slots.cpu().numpy()
        errs = bits.view(np.float64) if dtype == torch.float64 \
            else bits.astype(np.uint32).view(np.float32)
        n = int(default["niter"])
        inside = [c for c in range(1, 17)
                  if sum(tv.bl99_chunks(errs, 1, c)) != n]
        assert inside, "every fallback length ends a chunk at the stop"
        monkeypatch.setattr(tv, "BL99_CHUNK", inside[0])
    args, kw = _check_icepack_kernels(rec, tol)
    if case == "rerun":
        got = tv.temperature_solve(*args, **kw)
        for k in tv.BL99_OUTPUTS:
            assert torch.equal(got[k], default[k]), k
        return
    assert (kw.get("shcoef") is not None) == (case == "similarity")
    assert (args[0].conduct, args[0].nilyr, args[0].nslyr) == (
        opts.get("conduct", "bubbly"), opts.get("nilyr", 4),
        opts.get("nslyr", 4))


@pytest.mark.cuda
def test_icepack_kernels_raise_when_the_build_fails_on_card(monkeypatch):
    """No nvcc: a CUDA tensor does not fall back to the plain version."""
    _need_card()
    from fesom2_tpu_torch.ice.icepack import itd
    from fesom2_tpu_torch.kernels import build
    monkeypatch.setattr(kernels, "_LIB", None)
    monkeypatch.setattr(build, "library_path",
                        lambda: build.BUILD_DIR / "absent" / "none.so")
    monkeypatch.setattr(build, "find_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    z = lambda *k: torch.zeros((5, *k, 10), dtype=torch.float64,
                               device="cuda")
    with pytest.raises(RuntimeError, match="nvcc"):
        itd.itd_remap(z(), z(), z(), z(), z(4), z(4), z(0), z(0), None, None,
                      itd.category_bounds(5), False)


def _itd_inputs(rng, dtype, ncat=5, n=1000, ka=0, kv=0, nilyr=4, nslyr=4):
    """Seeded category state on the card for itd_remap: about a quarter of
    the categories empty, 15 % of the thicknesses pushed out of their
    bounds, growth since the init arrays; (the eight tensors, aicen_init,
    vicen_init, hin_max)."""
    from fesom2_tpu_torch.ice.icepack import itd
    hb = itd.category_bounds(ncat)
    a = rng.uniform(0.0, 1.0, (ncat, n)) * (rng.random((ncat, n)) > 0.25)
    a *= rng.uniform(0.2, 1.0, n) / np.maximum(a.sum(0), 1e-3)
    h = np.stack([rng.uniform(hb[k] + 0.01, min(hb[k + 1], hb[k] + 2.0), n)
                  for k in range(ncat)])
    grown = h * np.where(rng.random((ncat, n)) < 0.15,
                         rng.uniform(0.4, 1.6, (ncat, n)), 1.0)
    has = a > 0
    rows = lambda k, lo, hi: np.where(
        has[:, None], rng.uniform(lo, hi, (ncat, k, n)), 0.0)
    a_init = a * rng.uniform(0.8, 1.0, (ncat, n))
    cats = (a, a * grown, a * rng.uniform(0.0, 0.4, (ncat, n)),
            np.where(has, rng.uniform(-30.0, 0.0, (ncat, n)), 0.0),
            rows(nilyr, -3.3e8, -1e8), rows(nslyr, -1.5e8, -1e8),
            rows(ka, 0.0, 1.0), rows(kv, 0.0, 2.0), a_init, a_init * h)
    card = lambda x: torch.as_tensor(x, device="cuda").to(dtype)
    return tuple(card(x) for x in cats) + (hb,)


ITD_CASES = {
    "ncat 1": dict(ncat=1),
    "ncat 8": dict(ncat=8),
    # the tracers of every option (ponds, age, FY, lvl, fsd, bgc)
    "ALL tracers": dict(ka=19, kv=2),
    "ragged N": dict(n=32 * 37 + 13),
    "N = 0": dict(n=0),
    "NaN in a row": {},
    "transfers of 0": {},
    "7 ice, 1 snow layer": dict(nilyr=7, nslyr=1),
    # whole warps (32 nodes) without ice, as most of the globe's
    "warps without ice": {},
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ITD_CASES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_itd_remap_edge_cases_on_card(rng, case, dtype):
    """itd_remap at the shapes and states the Icepack step does not give
    it, both calls (the remap with the rebin, the rebin alone), bitwise the
    plain version as ``_check_itd_remap`` holds it."""
    _need_card()
    x = list(_itd_inputs(rng, dtype, **ITD_CASES[case]))
    if case == "NaN in a row":
        x[4][2, 1, 100:103] = float("nan")
    if case == "transfers of 0":
        # no growth and every thickness inside its bounds: every transfer
        # moves 0, and each mix is still made
        hb = torch.as_tensor(x[10], device="cuda").to(dtype)
        mid = (hb[:-1] + torch.clamp_max(hb[1:], hb[:-1] + 2.0)) / 2
        x[1] = x[0] * mid[:, None]
        x[8], x[9] = x[0].clone(), x[1].clone()
    if case == "warps without ice":
        # 32-63 empty; 64-95 areas of 0, -0 or under puny beside volumes,
        # snow and tracers; 96-127 -0 areas with surface temperatures;
        # 128-159 empty but a NaN area; 160-191 thin ice (areas < 0.04)
        for t in x[:8]:
            t[..., 32:64] = 0.0
            t[..., 96:160] = 0.0
        x[0][:, 64:96] = torch.tensor([0.0, -0.0, 1e-12, 5e-12],
                                      dtype=dtype)[torch.arange(32) % 4].to(
                                          x[0].device)
        x[0][:, 96:128] = -0.0
        x[3][:, 96:128] = -5.0
        x[0][3, 140] = float("nan")
        for t in x[:3]:
            t[:, 160:192] *= 0.04
    for linear in (True, False):
        got = _check_itd_remap((*x, linear))
        if case == "NaN in a row":
            assert bool(got.isnan().any())
        if case == "transfers of 0":
            assert torch.equal(got[:, 0], x[0])


@pytest.mark.cuda
def test_itd_remap_refuses_without_the_plain_version_on_card(rng):
    """A shape or dtype the kernel does not take raises on a CUDA tensor:
    the plain version, which would take it, is never run."""
    _need_card()
    from fesom2_tpu_torch.ice.icepack import itd
    called = []
    plain = itd.itd_remap_plain
    try:
        itd.itd_remap_plain = lambda *a: called.append(a) or plain(*a)
        x = _itd_inputs(rng, torch.float64, ncat=9)
        with pytest.raises(ValueError, match="at most 8"):
            itd.itd_remap(*x, True)
        x = _itd_inputs(rng, torch.float64)
        with pytest.raises(ValueError, match="float32 or float64"):
            itd.itd_remap(*(t.half() for t in x[:10]), x[10], True)
    finally:
        itd.itd_remap_plain = plain
    assert not called


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_mevp_subcycles_with_strength_whole_globe_on_card(tmp_path, rng,
                                                          dtype):
    """mevp_subcycles with the Icepack strength field on the whole level-7
    globe (the Icepack step's dynamics) after 1, 8 and 120 subcycles,
    bit-equal to the plain loop."""
    _need_card()
    from fesom2_tpu_torch.ice import evp
    path = globe.write_globe(str(tmp_path), level=7)
    m = build_mesh(path, force_rotation=True, use_partial_cell=True,
                   device="cuda", dtype=dtype)
    ice, forcing, surf = _random_ice(m, rng, dtype)
    strength = torch.as_tensor(rng.uniform(0.0, 3e4, m.n_nodes),
                               device="cuda").to(dtype) * (ice.a_ice > 0)
    tab = evp.mevp_setup(ice, m, forcing, surf, pi_config(),
                         strength_node=strength)
    uv0 = torch.stack([ice.u_ice, ice.v_ice])
    sig0 = torch.stack([ice.sigma11, ice.sigma12, ice.sigma22])
    kernels.reset_launches()
    for n in (1, 8, 120):
        want = evp.mevp_subcycles_plain(uv0, sig0, tab, m, n)
        got = evp.mevp_subcycles(uv0.clone(), sig0.clone(), tab, m, n)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert kernels.LAUNCHES["mevp_subcycles"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_dens_moc_bin_matches_plain_on_card(tmp_path, dtype, tol):
    """dens_moc_bin on the level-3 globe's state after two coupled CI
    steps on the card (8 subcycles), without and with the bolus
    velocities, and with a layer of no density spread, a NaN interval, an
    element whose span crosses the edge between two chunks of classes and
    spreads about the kernel's thresholds (1e-10, 1e-9): each of the five
    outputs within the tolerance of its max|plain|, one launch a call."""
    _need_card()
    from fesom2_tpu_torch.core import diagnostics as dg
    from fesom2_tpu_torch.model import (pi_coupled_step_fn, pi_initial_state,
                                        setup_pi_model)
    path = globe.write_globe(str(tmp_path), level=3, n_layers=12,
                             dz_bottom=1000.0)
    cfg = pi_config()
    cfg.ice.evp_rheol_steps = 8
    m, atm = setup_pi_model(path, device="cuda", dtype=dtype, cfg=cfg)
    s, ice = pi_initial_state(m)
    step = pi_coupled_step_fn(m, atm)
    for k in range(2):
        s, ice, _ = step(s, ice, k)
    dens = dg.interface_density(s, m.mesh, cfg)
    bins = torch.as_tensor(dg.STD_DENS, device="cuda").to(dtype)
    odd = dens.clone()
    odd[2] = odd[1]
    odd[6, 7] = float("nan")
    # element 9's span across the edge between the chunks of classes 0-7
    # and 8-15
    odd[:, 9] = torch.linspace(31.2, 33.5, odd.shape[0]).to(dtype)
    # spreads about the thresholds of the weight sum (1e-10) and of the
    # sure run (1e-9): elements 10-14, layers 2 and 3
    for e, gap in zip(range(10, 15), (5e-11, 1e-10, 2e-10, 9e-10, 2e-9)):
        odd[3, e] = odd[2, e] + gap
        odd[4, e] = odd[3, e] - gap / 2
    rest = (s.helem, s.u, s.v, m.mesh.elem_area, m.mesh.ulevels_elem,
            m.mesh.nlevels_elem, bins)
    for d, fer in ((dens, (None, None)), (dens, (s.fer_u, s.fer_v)),
                   (odd, (None, None)), (odd, (s.fer_u, s.fer_v))):
        n0 = kernels.LAUNCHES["dens_moc_bin"]
        got = dg.dens_moc_bin(d, *rest, *fer)
        want = dg.dens_moc_bin_plain(d, *rest, *fer)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["dens_moc_bin"] == n0 + 1
        ok = torch.isfinite(want).all(0).all(0)
        assert int((~ok).sum()) <= 1
        for k, name in enumerate(dg.DMOC_BINNED):
            g, w = got[k][:, ok], want[k][:, ok]
            assert float((g - w).abs().max()) <= tol * float(
                w.abs().max()), name
    assert float(got[4, :8, 9].sum()) > 0 and float(got[4, 8:16, 9].sum()) > 0


@pytest.mark.cuda
def test_dens_moc_bin_raises_when_the_build_fails_on_card(monkeypatch):
    """No nvcc: a CUDA tensor does not fall back to the plain version."""
    _need_card()
    from fesom2_tpu_torch.core import diagnostics as dg
    from fesom2_tpu_torch.kernels import build
    monkeypatch.setattr(kernels, "_LIB", None)
    monkeypatch.setattr(build, "library_path",
                        lambda: build.BUILD_DIR / "absent" / "none.so")
    monkeypatch.setattr(build, "find_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    E, nl = 10, 5
    z = lambda *shape: torch.zeros(shape, dtype=torch.float64, device="cuda")
    lev = lambda v: torch.full((E,), v, dtype=torch.int32, device="cuda")
    bins = torch.as_tensor(dg.STD_DENS, device="cuda")
    with pytest.raises(RuntimeError, match="nvcc"):
        dg.dens_moc_bin(z(nl, E), z(nl - 1, E), z(nl - 1, E), z(nl - 1, E),
                        z(E), lev(1), lev(nl), bins)
