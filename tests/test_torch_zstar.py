"""The port's zstar modules and step against the JAX package's.

The module tests start from the JAX state after one zstar step on the
code-built channel (8 x 24 nodes, 10 layers), so that hbar is not zero,
carried into the port with ``convert.state_from_numpy``; every output
must agree to 1e-10 of its largest JAX magnitude (float64, CPU).  The
whole step (dense SSH solve, as the channel is below the dense limit)
must agree after 3 steps to 1e-9.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from fesom2_tpu.model import setup_soufflet_model as jax_setup, \
    replace_coriolis
from fesom2_tpu.core import ale as jale, dynamics as jdyn, ssh as jssh
from fesom2_tpu.core.state import zero_forcing as jax_zero_forcing

from fesom2_tpu_torch.convert import state_from_numpy, to_numpy
from fesom2_tpu_torch.core import ale, dynamics, ssh
from fesom2_tpu_torch.core.state import zero_forcing
from fesom2_tpu_torch.mesh.channel import channel_raw_mesh, write_mesh
from fesom2_tpu_torch.model import (replace_coriolis as port_replace_coriolis,
                                    setup_soufflet_model)
from fesom2_tpu_torch.run import run_soufflet

TOL = 1e-10
FIELDS = ("u", "v", "eta", "hbar", "d_eta", "tr", "tr_old", "w", "Kv", "Av",
          "hnode", "helem", "zbar_3d", "Z_3d")


class Pair:
    """The JAX and the port side of one test setup."""


def _to_port(js):
    return state_from_numpy({f.name: np.asarray(getattr(js, f.name))
                             for f in dataclasses.fields(js)}, "cpu")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    torch.set_num_threads(1)
    path = write_mesh(channel_raw_mesh(8, 24, 10, dz=400.0),
                      str(tmp_path_factory.mktemp("channel")))
    p = Pair()
    p.path = path
    p.jm = jax_setup(mesh_path=path, which_ale="zstar")
    p.tm = setup_soufflet_model(path, device="cpu", which_ale="zstar")
    p.jf = jax_zero_forcing(p.jm.mesh)
    p.tf = zero_forcing(p.tm.mesh)
    p.js = p.jm.step_fn()(p.jm.initial_state(), p.jf)
    p.ts = _to_port(p.js)
    p.jmesh = replace_coriolis(p.jm.mesh, p.jm.soufflet_statics.coriolis)
    p.tmesh = port_replace_coriolis(p.tm.mesh,
                                    p.tm.soufflet_statics.coriolis)
    p.cfg, p.tcfg = p.jm.cfg, p.tm.cfg
    assert float(np.abs(np.asarray(p.js.hbar)).max()) > 1e-6
    return p


def jit(fn, state, mesh, *rest):
    """fn(state, mesh, *rest) compiled as one JAX program."""
    return jax.jit(lambda s: fn(s, mesh, *rest))(state)


def assert_close(port, ref, name="", tol=TOL):
    ref = np.asarray(ref)
    got = to_numpy(port)
    assert got.shape == ref.shape, name
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{name}: {err:.3e} of scale {scale:.3e}"


def assert_states_close(ts, js, names, tol=TOL):
    for n in names:
        assert_close(getattr(ts, n), getattr(js, n), n, tol)


def test_nlevels_node_min(pair):
    p = pair
    assert np.array_equal(to_numpy(ale._nlevels_node_min(p.tmesh)),
                          np.asarray(jale._nlevels_node_min(p.jmesh)))


def test_pressure_force_shchepetkin(pair):
    p = pair
    assert_states_close(dynamics.pressure_force(p.ts, p.tmesh, p.tcfg),
                        jit(jdyn.pressure_force, p.js, p.jmesh, p.cfg),
                        ("pgf_x", "pgf_y"))
    got = dynamics.pressure_force_zxxxx_shchepetkin(p.ts, p.tmesh)
    assert float(got.pgf_x.abs().max()) > 0.0


def test_vert_vel_ale_zstar(pair):
    p = pair
    ts = ale.vert_vel_ale(p.ts, p.tmesh, p.tcfg, p.tf)
    js = jit(jale.vert_vel_ale, p.js, p.jmesh, p.cfg, p.jf)
    assert_states_close(ts, js, ("w", "w_e", "w_i", "cfl_z", "hnode_new"))
    # the layers move
    assert float((ts.hnode_new - p.ts.hnode).abs().max()) > 1e-8


def test_update_thickness_zstar(pair):
    p = pair
    js = jit(jale.vert_vel_ale, p.js, p.jmesh, p.cfg, p.jf)
    ts = ale.update_thickness(_to_port(js), p.tmesh, p.tcfg)
    js = jit(jale.update_thickness, js, p.jmesh, p.cfg)
    assert_states_close(ts, js, ("hnode", "helem", "zbar_3d", "Z_3d"))


def test_ssh_zstar_rhs_dense_solve_and_hbar(pair):
    p = pair
    _, ju, jv = jit(jdyn.compute_vel_rhs, p.js, p.jmesh, p.jf, p.cfg)
    tu, tv = (torch.tensor(np.asarray(z)) for z in (ju, jv))
    rhs = ssh.compute_ssh_rhs(p.ts, p.tmesh, p.tcfg, p.tf, tu, tv)
    jrhs = jit(jssh.compute_ssh_rhs, p.js, p.jmesh, p.cfg, p.jf, ju, jv)
    assert_close(rhs, jrhs, "ssh_rhs")
    d_eta, _ = ssh.solve_ssh_dense(p.ts, p.tmesh, p.tcfg,
                                   p.tm.ssh_dense_inv, rhs)
    jd_eta, _, jres = jit(jssh.solve_ssh_dense, p.js, p.jmesh, p.cfg,
                          p.jm.ssh_dense_inv, jrhs)
    assert_close(d_eta, jd_eta, "d_eta")
    # one refinement sweep against the hbar-corrected operator leaves the
    # residual JAX reports
    res = float(ssh.ssh_relative_residual(p.tmesh, p.tcfg, d_eta, rhs,
                                          ssh.ale_hbar_e(p.ts, p.tmesh)))
    assert res < 1e-8 and abs(res - float(jres)) <= 1e-3 * float(jres)
    assert_states_close(ssh.compute_hbar(p.ts, p.tmesh, p.tcfg, p.tf),
                        jit(jssh.compute_hbar, p.js, p.jmesh, p.cfg, p.jf),
                        ("hbar", "hbar_old", "ssh_rhs_old"))


def test_three_zstar_steps_match_jax(pair):
    """The whole zstar step with the dense SSH solve, from the JAX initial
    state."""
    p = pair
    js = p.jm.initial_state()
    ts = _to_port(js)
    jstep, tstep = p.jm.step_fn(), p.tm.step_fn()
    for _ in range(3):
        js = jstep(js, p.jf)
        ts = tstep(ts, p.tf)
    assert_states_close(ts, js, FIELDS, tol=1e-9)
    assert int(ts.step) == 3


def test_zstar_run_conserves_volume(pair):
    """Zero freshwater flux: the ocean volume stays put and each column's
    thickness is its depth plus hbar (the bounds of tests/test_zstar.py)."""
    p = pair
    m = p.tm.mesh
    s0 = p.tm.initial_state()
    _, s, _ = run_soufflet(4, model=p.tm, state=s0, verbose=False)
    mask = m.node_layer_mask
    area = m.areasvol[:-1]

    def vol(st):
        return float((torch.where(mask, st.hnode, 0.0) * area).sum())
    assert abs(vol(s) - vol(s0)) / vol(s0) < 1e-9
    H = torch.where(mask, s.hnode, 0.0).sum(0)
    depth = -m.zbar[(m.nlevels_node - 1).long()]
    assert float((H - depth - s.hbar).abs().max()) < 1e-8
    assert float((s.hnode - s0.hnode).abs().max()) > 1e-8
