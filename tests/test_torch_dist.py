"""The coupled CI step across ranks (``fesom2_tpu_torch/parallel/dist.py``)
against the JAX package's ``parallel/dist.py`` and against the port's own
one-device step, on the level-3 globe with 12 layers (CPU, float64).

S = 4 ranks of a gloo group, started with spawn: a rank imports neither
jax nor this module (``dist._rank_entry`` asserts it).  The layout is held
table for table and exactly against JAX's ``build_layout`` on the same
mesh, each package cutting the node graph by its own default partition
(the bisection with Kernighan-Lin sweeps: JAX's native library, the
port's copy of it), also with the two-level partition (``n_part``).  One
run of the ranks then checks the runtime's pieces (the halo exchange of an
owner-consistent field is the identity, the reverse accumulation sums
each node's local copies, two assemblies and an ocean step equal the
global ones) and takes 2 coupled steps (8 mEVP subcycles) from the same
initial state: gathered, they hold against the port's one-device step
under ``prepare_dist_model`` and against JAX's ``dist_pi_coupled_step_fn``
on the same layout under ``shard_map`` over the conftest's virtual CPU
devices, within the tolerances of
``tests/test_dist.py:152-186`` (eta, tr, w 1e-7, u 1e-6, hnode 1e-9; the
ice 1e-7 of max|ref|); every rank takes the same CG iterations, and every
halo slot of the final state holds its owner's value exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

from fesom2_tpu.parallel import dist as jdist
from fesom2_tpu.parallel import partition as jpart

from fesom2_tpu_torch.core import ops
from fesom2_tpu_torch.core.state import zero_forcing
from fesom2_tpu_torch.model import pi_coupled_step_fn
from fesom2_tpu_torch.parallel import dist

from test_torch_coupled import ICE_FIELDS, coupled_pair, short_config

S = 4


@pytest.fixture(scope="module")
def pair(path):
    p = coupled_pair(path, short_config())
    dist.prepare_dist_model(p.tm)
    jdist.prepare_dist_model(p.jm)
    return p


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    from fesom2_tpu_torch.mesh import globe
    torch.set_num_threads(1)
    return globe.write_globe(str(tmp_path_factory.mktemp("globe")), level=3,
                             n_layers=12, dz_bottom=1000.0)


@pytest.fixture(scope="module")
def layouts(pair):
    lay = dist.dist_layout_for_model(pair.tm, S)
    assert jpart._load_native() is not None
    jlay = jdist.build_layout(pair.jm.mesh, S, st=pair.jm.tracer_statics,
                              cfg=pair.jm.cfg)
    return lay, jlay


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b), what


def assert_layout_equal(lay, jlay):
    assert (lay.S, lay.n_own, lay.n_loc, lay.e_own, lay.e_loc, lay.ed_loc,
            lay.sizes) == (jlay.S, jlay.n_own, jlay.n_loc, jlay.e_own,
                           jlay.e_loc, jlay.ed_loc, jlay.sizes)
    for name in ("part", "node_l2g", "elem_l2g", "edge_l2g", "node_from",
                 "elem_from"):
        _eq(getattr(lay, name), getattr(jlay, name), name)
    s, js = lay.sched, jlay.sched
    for f in dataclasses.fields(js):
        a, b = getattr(s, f.name), getattr(js, f.name)
        if isinstance(b, tuple):
            assert len(a) == len(b), f.name
            for x, y in zip(a, b):
                if isinstance(y, tuple):
                    assert tuple(x) == y, f.name
                else:
                    _eq(x, y, f.name)
        elif b is None:
            assert a is None, f.name
        elif isinstance(b, int):
            assert a == b, f.name
        else:
            _eq(a, b, f.name)
    ml = jlay.mesh_local
    for name, arr in lay.mesh_local.items():
        _eq(arr, getattr(ml, name), f"mesh_local.{name}")
    for name, v in lay.mesh_meta.items():
        assert v == getattr(ml, name), name
    for name, arr in lay.st_local.items():
        _eq(arr, getattr(jlay.st_local, name), f"st_local.{name}")
    _eq(lay.diag_inv_local, jlay.diag_inv_local, "diag_inv_local")
    for name, arr in lay.block_pc_local.items():
        _eq(arr, getattr(jlay.block_pc_local, name), f"block_pc.{name}")
    for name, v in lay.ice_sub_local.items():
        _eq(v, getattr(jlay.ice_sub_local, name), f"ice_sub.{name}")


def test_layout_equals_jax(layouts):
    lay, jlay = layouts
    assert_layout_equal(lay, jlay)
    # every node owned once; the sub sizes apart from the local ones
    own = lay.node_l2g[:, :lay.n_own]
    assert np.array_equal(np.sort(own[own >= 0]), np.arange(lay.sizes[0]))
    assert lay.ice_sub_local["n_nodes"] not in (lay.n_loc, lay.e_loc,
                                                lay.ed_loc)


def test_hierarchical_layout_equals_jax(pair):
    assert jpart._load_native() is not None
    lay = dist.dist_layout_for_model(pair.tm, S, n_part=(2, 2))
    jlay = jdist.build_layout(pair.jm.mesh, S, st=pair.jm.tracer_statics,
                              cfg=pair.jm.cfg, n_part=(2, 2))
    assert_layout_equal(lay, jlay)
    assert len(np.unique(lay.part)) == S


def test_localize_gather_identity(pair, layouts):
    lay, _ = layouts
    mesh = pair.tm.mesh
    rng = np.random.default_rng(0)
    tree = {"n": torch.as_tensor(rng.normal(size=(mesh.nl - 1,
                                                  mesh.n_nodes))),
            "e": torch.as_tensor(rng.normal(size=(mesh.n_elems,))),
            "i": torch.arange(mesh.n_nodes, dtype=torch.int32),
            "scalar": torch.tensor(3.25)}
    d = dist.localize_tree(tree, lay)
    assert d["n"].shape == (S, mesh.nl - 1, lay.n_loc)
    back = dist.gather_tree(d, lay)
    for k in ("n", "e", "i"):
        assert torch.equal(back[k], tree[k]), k
    assert float(back["scalar"]) == 3.25
    assert dist.check_halo_consistency(d, lay) == []
    bad = d["n"].clone()
    h = int(np.nonzero(lay.node_l2g[1, lay.n_own:] >= 0)[0][0])
    bad[1, 0, lay.n_own + h] += 1.0
    found = dist.check_halo_consistency({"n": bad}, lay)
    assert found and found[0][1] == "node" and found[0][2] == 1.0


@pytest.fixture(scope="module")
def checks_in(pair, layouts):
    lay, _ = layouts
    mesh = pair.tm.mesh
    rng = np.random.default_rng(2)
    glob = dict(xn=torch.as_tensor(rng.normal(size=(3, mesh.n_nodes))),
                flux=torch.as_tensor(rng.normal(size=(mesh.nl - 1,
                                                      mesh.n_edges))),
                contrib=torch.as_tensor(rng.normal(size=(3, mesh.n_elems))))
    loc = dist.localize_tree(glob, lay)
    x_loc = torch.as_tensor(rng.normal(size=(S, lay.n_loc)))
    x_loc[torch.as_tensor(lay.node_l2g < 0)] = 0.0
    loc["x_loc"] = x_loc
    return glob, loc


@pytest.fixture(scope="module")
def ranks(pair, layouts, checks_in):
    lay, _ = layouts
    p = pair
    case = dict(model=p.tm, atm=p.tatm, state=p.ts0, ice=p.tice0,
                n_steps=2, checks=checks_in[1])
    return dist.run_coupled_steps([case], lay, backend="gloo",
                                  device="cpu")[0]


@pytest.fixture(scope="module")
def one_device(pair):
    p = pair
    step = pi_coupled_step_fn(p.tm, p.tatm)
    s, i, iters = p.ts0, p.tice0, []
    for k in range(2):
        s, i, _ = step(s, i, k)
        iters.append(p.tm.ssh_iters)
    return s, i, iters


def test_halo_exchange_and_accumulate(pair, layouts, checks_in, ranks):
    lay, _ = layouts
    glob, loc = checks_in
    out = ranks["checks"]
    # the exchange of an owner-consistent field is the identity
    assert torch.equal(out["exchanged"], loc["xn"])
    # the reverse accumulation: each node, the sum of its local copies
    x_loc = loc["x_loc"].numpy()
    expect = np.zeros(lay.sizes[0])
    for s in range(S):
        v = lay.node_l2g[s] >= 0
        np.add.at(expect, lay.node_l2g[s][v], x_loc[s][v])
    got = dist.gather_tree(out["accumulated"], lay).numpy()
    np.testing.assert_allclose(got, expect, rtol=1e-13, atol=1e-15)
    assert dist.check_halo_consistency({"a": out["accumulated"]}, lay) == []


def test_dist_assembly_matches_global(pair, layouts, checks_in, ranks):
    lay, _ = layouts
    glob, _ = checks_in
    mesh = pair.tm.mesh
    out = ranks["checks"]
    div = dist.gather_tree(out["div"], lay)
    ctn = dist.gather_tree(out["ctn"], lay)
    assert torch.equal(div, ops.edge_divergence(glob["flux"], mesh))
    assert torch.equal(ctn, ops.elem_contrib_to_nodes(
        glob["contrib"].T.contiguous(), mesh))


def test_dist_ocean_step_matches_one_device(pair, layouts, ranks):
    """``dist_step_fn``: one ocean step without forcing across the ranks
    against the one-device step (``tests/test_dist.py:138-150``: 5e-8)."""
    lay, _ = layouts
    p = pair
    with torch.no_grad():
        ref = p.tm(p.ts0, zero_forcing(p.tm.mesh, p.tm.dtype))
    out = dist.gather_tree(ranks["checks"]["ocean"], lay)
    for name in ("eta", "tr", "u", "w", "hbar"):
        a, b = getattr(ref, name), getattr(out, name)
        scale = max(float(a.abs().max()), 1e-12)
        assert float((a - b).abs().max()) / scale < 5e-8, name


def test_every_rank_takes_the_same_cg_iterations(ranks):
    iters = [r["iters"] for r in ranks["ranks"]]
    assert all(it == iters[0] for it in iters), iters
    assert all(i > 0 for i in iters[0])
    assert all(f == [0, 0] for f in (r["flags"] for r in ranks["ranks"]))


def test_halo_consistent_after_the_steps(layouts, ranks):
    lay, _ = layouts
    bad = dist.check_halo_consistency(
        dict(state=ranks["state_d"], ice=ranks["ice_d"]), lay)
    assert bad == [], bad[:4]


def test_mevp_exchanges_every_subcycle(pair, ranks):
    n_sub = pair.cfg.ice.evp_rheol_steps
    for r in ranks["ranks"]:
        for ex in r["exchanges"]:
            # the subcycles, and the assembly of the elevation rhs
            assert ex["calls"]["sub"] == n_sub + 1, ex["calls"]


def test_two_coupled_steps_match_one_device(ranks, one_device):
    s_ref, i_ref, iters = one_device
    errs = dist.relative_errors(s_ref, i_ref, ranks["state"], ranks["ice"])
    for name, tol in dist.OCEAN_TOL + dist.ICE_TOL:
        assert errs[name] < tol, (name, errs[name])
    assert float(i_ref.a_ice.max()) > 0.5
    assert float(i_ref.u_ice.abs().max()) > 1e-4


def test_two_coupled_steps_match_jax_dist(pair, layouts, ranks):
    _, jlay = layouts
    p = pair
    jstep = jdist.dist_pi_coupled_step_fn(p.jm, p.jatm, jlay)
    sd = jdist.localize_tree(p.js0, jlay)
    idd = jdist.localize_tree(p.jice0, jlay)
    for k in range(2):
        sd, idd, _ = jstep(sd, idd, k)
    js = jdist.gather_tree(sd, jlay)
    ji = jdist.gather_tree(idd, jlay)
    errs = dist.relative_errors(js, ji, ranks["state"], ranks["ice"])
    for name, tol in dist.OCEAN_TOL + dist.ICE_TOL:
        assert errs[name] < tol, (name, errs[name])
    for name in ICE_FIELDS:
        a = np.asarray(getattr(ji, name))
        assert np.all(np.isfinite(a)), name
