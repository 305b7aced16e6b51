"""The float32 CG solve of the CI ocean step against the JAX package's, on
the level-3 globe with 12 layers: both packages in float32, CG forced
(``DENSE_SSH_MAX_NODES = 0``, block-Schwarz preconditioner, ALE ring),
three steps from the same numpy inputs (``run.globe_ocean_inputs``).

Each step's CG iteration count must be the same in both.  eta must agree
to 2e-3 of its largest JAX magnitude after each step, and the two float32
solutions must lie closer to each other than JAX's lies to the float64 one
(the port's float64 steps, which agree with JAX's to 1e-8:
``test_torch_ci_ocean.py``).  Measured on this mesh: both packages stop CG
after 3 iterations a step in float32 (6 to 7 in float64), at the float32
tolerance of 2e-5 of the right-hand side's norm; either float32 eta lies
1.2e-3 to 1.6e-3 of max|eta| from the float64 one, and the two float32
runs 7e-4 to 9e-4 from each other (the packages round some float32
operations otherwise).  The tolerance stands above float32's own error
here, not below it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fesom2_tpu.model as jmodel
from fesom2_tpu.core import eos as jeos, ssh as jssh
from fesom2_tpu.core.state import initial_z3d as jz3d, \
    zero_forcing as jzero_forcing
from fesom2_tpu.core.tracer_setup import build_tracer_statics as jtst
from fesom2_tpu.mesh import build_mesh as jax_build_mesh

import fesom2_tpu_torch.model as tmodel
from fesom2_tpu_torch.convert import to_numpy
from fesom2_tpu_torch.mesh import globe
from fesom2_tpu_torch.model import setup_pi_model
from fesom2_tpu_torch.run import globe_ocean_inputs, run_pi_ocean

from test_torch_ci_ocean import FORCED, ci_config, jax_run
from test_torch_kpp import assert_close

STEPS = 3
TOL_ETA = 2e-3


def jax_cg_model_f32(path, cfg):
    """The JAX model of ``_finish_pi_setup`` in float32, CG (the block
    preconditioner and the ALE ring), without forcing and ice."""
    f32 = jnp.float32
    m = jax_build_mesh(path, force_rotation=True, cyclic_length_deg=360.0,
                       use_partial_cell=cfg.ale.use_partial_cell,
                       partial_cell_thresh=cfg.ale.partial_cell_thresh,
                       dtype=f32)
    _, Z3 = jz3d(m, f32)
    return jmodel.Model(
        mesh=m, cfg=cfg, tracer_statics=jtst(m, K_hor=cfg.tra.K_hor,
                                             dtype=f32),
        ssh_diag_inv=None,
        density_ref=jeos.reference_density(m, Z3, cfg.dyn.state_equation),
        ssh_block_pc=jssh.build_block_schwarz(m, cfg, dtype=f32),
        ssh_ring=jssh.build_ssh_ring_ale(m, cfg, dtype=f32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Three float32 CG steps in each package: (JAX states and CG
    iterations, port states and CG iterations, the port's float64 eta
    after each step)."""
    torch.set_num_threads(1)
    path = globe.write_globe(str(tmp_path_factory.mktemp("globe")), level=3,
                             n_layers=12, dz_bottom=1000.0)
    cfg = ci_config()
    dense = (jmodel.DENSE_SSH_MAX_NODES, tmodel.DENSE_SSH_MAX_NODES)
    jmodel.DENSE_SSH_MAX_NODES = tmodel.DENSE_SSH_MAX_NODES = 0
    try:
        tm, _ = setup_pi_model(path, device="cpu", cfg=cfg,
                               dtype=torch.float32)
    finally:
        jmodel.DENSE_SSH_MAX_NODES, tmodel.DENSE_SSH_MAX_NODES = dense
    jm = jax_cg_model_f32(path, cfg)
    assert tm.ssh_dense_inv is None and tm.ssh_block_pc is not None

    ts, tf, tsw = globe_ocean_inputs(tm, seed=0)
    js = jm.initial_state(jnp.float32)
    js = dataclasses.replace(js, tr=jnp.asarray(to_numpy(ts.tr)),
                             tr_old=jnp.asarray(to_numpy(ts.tr_old)))
    jf = dataclasses.replace(jzero_forcing(jm.mesh, jnp.float32), **{
        k: jnp.asarray(to_numpy(getattr(tf, k))) for k in FORCED})
    jsw = jnp.asarray(to_numpy(tsw))

    # the JAX step drops solve_ssh's iteration count: a host callback
    # inside the traced step records it
    j_iters = []
    solve = jssh.solve_ssh

    def counted(*a, **kw):
        d_eta, iters, res = solve(*a, **kw)
        jax.debug.callback(lambda i: j_iters.append(int(i)), iters)
        return d_eta, iters, res
    jssh.solve_ssh = counted
    try:
        jstep = jm.step_fn()
        j_states = []
        for _ in range(STEPS):
            js = jax_run(jm, jstep, js, jf, jsw, 1)
            jax.effects_barrier()
            j_states.append(js)
    finally:
        jssh.solve_ssh = solve

    t_iters, t_states = [], []
    for _ in range(STEPS):
        ts = run_pi_ocean(tm, ts, tf, tsw, 1)
        t_iters.append(int(tm.ssh_iters))
        t_states.append(ts)

    # the float64 solution the float32 ones approximate
    jmodel.DENSE_SSH_MAX_NODES = tmodel.DENSE_SSH_MAX_NODES = 0
    try:
        tm64, _ = setup_pi_model(path, device="cpu", cfg=cfg)
    finally:
        jmodel.DENSE_SSH_MAX_NODES, tmodel.DENSE_SSH_MAX_NODES = dense
    s64, f64, sw64 = globe_ocean_inputs(tm64, seed=0)
    eta64 = []
    for _ in range(STEPS):
        s64 = run_pi_ocean(tm64, s64, f64, sw64, 1)
        eta64.append(s64.eta.numpy())
    return j_states, j_iters, t_states, t_iters, eta64


def test_f32_cg_iterations_match_jax(runs):
    j_states, j_iters, t_states, t_iters, _ = runs
    assert all(s.eta.dtype == jnp.float32 for s in j_states)
    assert all(s.eta.dtype == torch.float32 for s in t_states)
    assert len(j_iters) == STEPS and min(t_iters) > 0
    assert t_iters == j_iters


def test_f32_cg_eta_matches_jax(runs):
    j_states, _, t_states, _, eta64 = runs
    for js, ts, ref in zip(j_states, t_states, eta64):
        jeta, teta = np.asarray(js.eta), ts.eta.numpy()
        assert float(np.abs(jeta).max()) > 0.0 and np.isfinite(teta).all()
        assert_close(ts.eta, jeta, "eta", tol=TOL_ETA)
        assert np.abs(teta - jeta).max() < np.abs(jeta - ref).max()
