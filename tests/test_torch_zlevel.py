"""zlevel in the port against the JAX package, on the code-built channel
(8 x 24 nodes, 10 layers of 400 m; CPU, float64).

``ale.vert_vel_ale`` is held to 1e-12 of each output's largest JAX
magnitude on crafted states that reach each of its three cases, as JAX's
``tests/test_zstar.py`` crafts them: (A) a drop that would thin the
surface layer below ``min_hnode`` spreads down the first ``lzstar_lev``
layers (with a layer at ``cfl_z >= 0.95`` left out), (B) a rise with
subsurface deficits refills them bottom up, (C) the surface layer takes
it all; then one state with all three cases at once.  The thickness update
follows to 1e-12, and three whole zlevel steps (dense SSH solve, and CG
forced on the ALE ring) to 1e-9; so do three steps of the CI ocean under
zlevel on the level-3 globe (partial cells, KPP, GM/Redi).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fesom2_tpu.model as jmodel
from fesom2_tpu.core import ale as jale
from fesom2_tpu.core.state import zero_forcing as jax_zero_forcing

import fesom2_tpu_torch.model as tmodel
from fesom2_tpu_torch.core import ale
from fesom2_tpu_torch.core.state import zero_forcing
from fesom2_tpu_torch.mesh import globe
from fesom2_tpu_torch.mesh.channel import channel_raw_mesh, write_mesh
from fesom2_tpu_torch.model import setup_pi_model, setup_soufflet_model
from fesom2_tpu_torch.run import (globe_ocean_inputs, run_pi_ocean,
                                  run_soufflet)

from test_torch_ci_ocean import (FIELDS as CI_FIELDS, ci_config, jax_ci_model,
                                 jax_inputs, jax_run)
from test_torch_zstar import FIELDS, Pair, _to_port, assert_close

ALE_OUT = ("w", "w_e", "w_i", "cfl_z", "hnode_new")


def zlevel_pair(path, dense_limit=None):
    saved = (jmodel.DENSE_SSH_MAX_NODES, tmodel.DENSE_SSH_MAX_NODES)
    if dense_limit is not None:
        jmodel.DENSE_SSH_MAX_NODES = tmodel.DENSE_SSH_MAX_NODES = dense_limit
    try:
        p = Pair()
        p.jm = jmodel.setup_soufflet_model(mesh_path=path, which_ale="zlevel")
        p.tm = setup_soufflet_model(path, device="cpu", which_ale="zlevel")
    finally:
        jmodel.DENSE_SSH_MAX_NODES, tmodel.DENSE_SSH_MAX_NODES = saved
    return p


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    torch.set_num_threads(1)
    return write_mesh(channel_raw_mesh(8, 24, 10, dz=400.0),
                      str(tmp_path_factory.mktemp("channel")))


@pytest.fixture(scope="module")
def pair(path):
    p = zlevel_pair(path)
    p.jf = jax_zero_forcing(p.jm.mesh)
    p.js = p.jm.step_fn()(p.jm.initial_state(), p.jf)
    p.tf = zero_forcing(p.tm.mesh)
    p.jmesh, p.tmesh, p.cfg = p.jm.mesh, p.tm.mesh, p.tm.cfg
    p.nom = np.asarray(p.jmesh.zbar[:-1] - p.jmesh.zbar[1:])
    return p


def crafted(p, hbar, hbar_old, hnode=None, cfl_top=None):
    """The JAX state after one step with hbar, hbar_old [N] (and hnode,
    cfl_z's first layer) set."""
    js = dataclasses.replace(p.js, hbar=jnp.asarray(hbar),
                             hbar_old=jnp.asarray(hbar_old))
    if hnode is not None:
        js = dataclasses.replace(js, hnode=jnp.asarray(hnode))
    if cfl_top is not None:
        js = dataclasses.replace(js, cfl_z=js.cfl_z.at[1].set(cfl_top))
    return js


def both_ale(p, js):
    jo = jax.jit(lambda s: jale.vert_vel_ale(s, p.jmesh, p.jm.cfg, p.jf))(js)
    to = ale.vert_vel_ale(_to_port(js), p.tmesh, p.cfg, p.tf)
    for name in ALE_OUT:
        assert_close(getattr(to, name), getattr(jo, name), name, tol=1e-12)
    return np.asarray(jo.hnode_new), to


def test_case_a_spreads_a_drop_down_the_column(pair):
    p = pair
    N = p.jmesh.n_nodes
    h0 = p.nom[0]
    dh = -0.75 * h0
    cfl_top = np.where(np.arange(N) % 5 == 0, 0.97, 0.1)
    js = crafted(p, np.full(N, dh), np.zeros(N), cfl_top=cfl_top)
    hn, _ = both_ale(p, js)
    h_in = np.asarray(js.hnode)
    min_h = p.cfg.ale.min_hnode
    assert np.allclose(hn[0], p.nom[0] * min_h, rtol=1e-12)
    K = p.cfg.ale.lzstar_lev
    assert np.allclose((hn - h_in)[:K].sum(0), dh, atol=1e-9)
    # layer 1 gives unless its CFL number excludes it
    assert (hn[1][cfl_top < 0.95] < h_in[1][cfl_top < 0.95]).all()
    assert np.array_equal(hn[1][cfl_top >= 0.95], h_in[1][cfl_top >= 0.95])


def test_case_b_refills_deficits_bottom_up(pair):
    p = pair
    N = p.jmesh.n_nodes
    h0 = p.nom[0]
    dh = -0.75 * h0
    hn_a, _ = both_ale(p, crafted(p, np.full(N, dh), np.zeros(N)))
    js = crafted(p, np.full(N, dh + 0.3 * h0), np.full(N, dh), hnode=hn_a)
    hn, _ = both_ale(p, js)
    assert (hn[1:] - hn_a[1:] > -1e-12).all()
    assert (hn[1] > hn_a[1]).all()
    assert np.allclose((hn - hn_a).sum(0), 0.3 * h0, atol=1e-9)


def test_case_c_puts_it_all_in_the_surface_layer(pair):
    p = pair
    N = p.jmesh.n_nodes
    rng = np.random.default_rng(11)
    dh = rng.uniform(-0.1, 0.1, N) * p.nom[0]
    js = crafted(p, dh, np.zeros(N))
    hn, _ = both_ale(p, js)
    h_in = np.asarray(js.hnode)
    assert np.array_equal(hn[1:], h_in[1:])
    assert np.allclose(hn[0] - h_in[0], dh, atol=1e-12)


def test_all_three_cases_at_once_and_the_thickness_update(pair):
    p = pair
    N = p.jmesh.n_nodes
    h0 = p.nom[0]
    rng = np.random.default_rng(12)
    # a column in deficit below the surface, so a rise refills it
    h_in = np.asarray(p.js.hnode).copy()
    h_in[1] -= rng.uniform(0.0, 0.2, N) * p.nom[1] * (np.arange(N) % 3 == 1)
    dh = np.select([np.arange(N) % 3 == 0, np.arange(N) % 3 == 1],
                   [-rng.uniform(0.6, 0.9, N) * h0,
                    rng.uniform(0.01, 0.3, N) * h0],
                   rng.uniform(-0.1, 0.1, N) * h0)
    js = crafted(p, dh, np.zeros(N), hnode=h_in)
    _, to = both_ale(p, js)
    jo = jale.vert_vel_ale(js, p.jmesh, p.jm.cfg, p.jf)
    ju = jale.update_thickness(jo, p.jmesh, p.jm.cfg)
    tu = ale.update_thickness(to, p.tmesh, p.cfg)
    for name in ("hnode", "helem", "zbar_3d", "Z_3d"):
        assert_close(getattr(tu, name), getattr(ju, name), name, tol=1e-12)


@pytest.mark.parametrize("dense_limit", [None, 0], ids=["dense", "cg"])
def test_three_zlevel_steps_match_jax(path, dense_limit):
    p = zlevel_pair(path, dense_limit)
    if dense_limit == 0:
        assert p.tm.ssh_dense_inv is None
        assert isinstance(p.tm.ssh_ring, tmodel.ssh.RingALE)
    js = p.jm.initial_state()
    jstep, jf = p.jm.step_fn(), jax_zero_forcing(p.jm.mesh)
    for _ in range(3):
        js = jstep(js, jf)
    _, ts, _ = run_soufflet(3, model=p.tm, verbose=False)
    for name in FIELDS:
        assert_close(getattr(ts, name), getattr(js, name), name, tol=1e-9)
    hn0 = np.asarray(p.jm.initial_state().hnode)
    # the surface layer moved (case C)
    assert float(np.abs(np.asarray(js.hnode)[0] - hn0[0]).max()) > 0.0


def test_three_zlevel_ci_ocean_steps_on_the_globe_match_jax(tmp_path_factory):
    path = globe.write_globe(str(tmp_path_factory.mktemp("globe")), level=3,
                             n_layers=12, dz_bottom=1000.0)
    cfg = ci_config()
    cfg.ale.which_ALE = "zlevel"
    tm, _ = setup_pi_model(path, device="cpu", cfg=cfg)
    jm = jax_ci_model(path, cfg)
    ts0, tf, tsw = globe_ocean_inputs(tm, seed=0)
    js = jax_run(jm, jm.step_fn(), *jax_inputs(jm, ts0, tf, tsw), 3)
    ts = run_pi_ocean(tm, ts0, tf, tsw, 3)
    for name in CI_FIELDS:
        assert_close(getattr(ts, name), getattr(js, name), name, tol=1e-9)
    # the surface layers move, the deep ones keep their thickness
    dh = (ts.hnode - ts0.hnode).abs()
    assert float(dh[0].max()) > 0.0 and float(dh[-1].max()) == 0.0
