"""Each module of the port's soufflet step against its JAX function.

Both packages start from the same arrays: the JAX state after one step
of the JAX model on a code-built channel (8 x 24 nodes, 10 layers),
carried into the port with ``convert.state_from_numpy``.  Every output
must agree to 1e-10 of its largest JAX magnitude (float64, CPU).
"""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from fesom2_tpu.model import (setup_soufflet_model as jax_setup,
                              replace_coriolis, solve_tracers as jax_tracers)
from fesom2_tpu.core.state import zero_forcing as jax_zero_forcing
from fesom2_tpu.core import (dynamics as jdyn, eos as jeos, ssh as jssh,
                             ale as jale)
from fesom2_tpu.core.mixing import pp as jpp

from fesom2_tpu_torch.convert import state_from_numpy, to_numpy
from fesom2_tpu_torch.core import dynamics, eos, ssh, ale
from fesom2_tpu_torch.core.mixing import pp
from fesom2_tpu_torch.core.state import zero_forcing
from fesom2_tpu_torch.mesh.channel import channel_raw_mesh, write_mesh
from fesom2_tpu_torch.model import (replace_coriolis as port_replace_coriolis,
                                    setup_soufflet_model, solve_tracers)

TOL = 1e-10


class Pair:
    """The JAX and the port side of one test setup."""


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    torch.set_num_threads(1)
    path = write_mesh(channel_raw_mesh(8, 24, 10, dz=400.0),
                      str(tmp_path_factory.mktemp("channel")))
    p = Pair()
    p.jm = jax_setup(mesh_path=path)
    p.tm = setup_soufflet_model(path, device="cpu")
    p.jf = jax_zero_forcing(p.jm.mesh)
    p.tf = zero_forcing(p.tm.mesh)
    js = p.jm.step_fn()(p.jm.initial_state(), p.jf)
    p.js = js
    p.ts = state_from_numpy({f.name: np.asarray(getattr(js, f.name))
                             for f in dataclasses.fields(js)}, "cpu")
    p.jmesh = replace_coriolis(p.jm.mesh, p.jm.soufflet_statics.coriolis)
    p.tmesh = port_replace_coriolis(p.tm.mesh,
                                    p.tm.soufflet_statics.coriolis)
    p.cfg = p.jm.cfg
    p.tcfg = p.tm.cfg
    # the momentum rhs both packages feed to the later modules
    _, ju, jv = jit(jdyn.compute_vel_rhs, js, p.jmesh, p.jf, p.cfg)
    p.ju, p.jv = ju, jv
    p.tu, p.tv = (torch.tensor(np.asarray(z)) for z in (ju, jv))
    return p


def jit(fn, state, mesh, *rest):
    """fn(state, mesh, *rest) compiled as one JAX program (much faster on
    the CPU than dispatching its operations one by one)."""
    return jax.jit(lambda s: fn(s, mesh, *rest))(state)


def assert_close(port, ref, name=""):
    ref = np.asarray(ref)
    got = to_numpy(port)
    assert got.shape == ref.shape, name
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max())
    assert err <= TOL * scale, f"{name}: {err:.3e} of scale {scale:.3e}"


def assert_states_close(ts, js, names):
    for n in names:
        assert_close(getattr(ts, n), getattr(js, n), n)


def test_compute_vel_nodes(pair):
    p = pair
    assert_states_close(dynamics.compute_vel_nodes(p.ts, p.tmesh),
                        jit(jdyn.compute_vel_nodes, p.js, p.jmesh),
                        ("unode", "vnode"))


def test_pressure_bv(pair):
    p = pair
    assert_states_close(
        eos.pressure_bv(p.ts, p.tmesh, p.tcfg, p.tm.density_ref),
        jit(jeos.pressure_bv, p.js, p.jmesh, p.cfg, p.jm.density_ref),
        ("density_m_rho0", "hpressure", "bvfreq", "dbsfc", "mld2"))


def test_pressure_bv_jm(pair):
    """The Jackett-McDougall EoS (state_equation=1) on the same state."""
    p = pair
    tcfg, cfg = copy.deepcopy(p.tcfg), copy.deepcopy(p.cfg)
    tcfg.dyn.state_equation = cfg.dyn.state_equation = 1
    assert_states_close(
        eos.pressure_bv(p.ts, p.tmesh, tcfg, p.tm.density_ref),
        jit(jeos.pressure_bv, p.js, p.jmesh, cfg, p.jm.density_ref),
        ("density_m_rho0", "hpressure", "bvfreq", "dbsfc", "mld2"))


def test_pressure_force_linfs(pair):
    p = pair
    assert_states_close(dynamics.pressure_force(p.ts, p.tmesh, p.tcfg),
                        jit(jdyn.pressure_force, p.js, p.jmesh, p.cfg),
                        ("pgf_x", "pgf_y"))


def test_pp_mixing_and_convection(pair):
    p = pair
    ts = pp.mo_convect(pp.oce_mixing_pp(p.ts, p.tmesh, p.tcfg), p.tmesh,
                       p.tcfg, p.tf)
    js = jit(lambda s, m: jpp.mo_convect(jpp.oce_mixing_pp(s, m, p.cfg), m,
                                         p.cfg, p.jf), p.js, p.jmesh)
    assert_states_close(ts, js, ("Av", "Kv"))


def test_compute_vel_rhs(pair):
    p = pair
    ts, tu, tv = dynamics.compute_vel_rhs(p.ts, p.tmesh, p.tf, p.tcfg)
    js, ju, jv = jit(jdyn.compute_vel_rhs, p.js, p.jmesh, p.jf, p.cfg)
    assert_states_close(ts, js, ("u_rhsAB", "v_rhsAB"))
    assert_close(tu, ju, "u_rhs")
    assert_close(tv, jv, "v_rhs")


def test_visc_filt_bcksct(pair):
    p = pair
    got = dynamics.visc_filt_bcksct(p.ts, p.tmesh, p.tcfg, p.tu, p.tv)
    ref = jit(jdyn.visc_filt_bcksct, p.js, p.jmesh, p.cfg, p.ju, p.jv)
    for g, r, n in zip(got, ref, ("u_rhs", "v_rhs")):
        assert_close(g, r, n)


def test_impl_vert_visc(pair):
    p = pair
    got = dynamics.impl_vert_visc(p.ts, p.tmesh, p.tcfg, p.tf, p.tu, p.tv)
    ref = jit(jdyn.impl_vert_visc, p.js, p.jmesh, p.cfg, p.jf, p.ju, p.jv)
    for g, r, n in zip(got, ref, ("du", "dv")):
        assert_close(g, r, n)


def test_ssh_rhs_and_dense_solve(pair):
    p = pair
    rhs = ssh.compute_ssh_rhs(p.ts, p.tmesh, p.tcfg, p.tf, p.tu, p.tv)
    jrhs = jit(jssh.compute_ssh_rhs, p.js, p.jmesh, p.cfg, p.jf, p.ju, p.jv)
    assert_close(rhs, jrhs, "ssh_rhs")
    d_eta, _ = ssh.solve_ssh_dense(p.ts, p.tmesh, p.tcfg,
                                   p.tm.ssh_dense_inv, rhs)
    jd_eta, _, _ = jit(jssh.solve_ssh_dense, p.js, p.jmesh, p.cfg,
                       p.jm.ssh_dense_inv, jrhs)
    assert_close(d_eta, jd_eta, "d_eta")
    res = ssh.ssh_relative_residual(p.tmesh, p.tcfg, d_eta, rhs)
    assert float(res) < 1e-12


def test_compute_hbar(pair):
    p = pair
    assert_states_close(ssh.compute_hbar(p.ts, p.tmesh, p.tcfg, p.tf),
                        jit(jssh.compute_hbar, p.js, p.jmesh, p.cfg, p.jf),
                        ("hbar", "hbar_old", "ssh_rhs_old"))


def test_vert_vel_ale(pair):
    p = pair
    assert_states_close(ale.vert_vel_ale(p.ts, p.tmesh, p.tcfg, p.tf),
                        jit(jale.vert_vel_ale, p.js, p.jmesh, p.cfg, p.jf),
                        ("w", "w_e", "w_i", "cfl_z", "hnode_new"))


def test_solve_tracers(pair):
    p = pair
    ts = solve_tracers(p.ts, p.tmesh, p.tcfg, p.tm.tracer_statics, p.tf, 0.0,
                       p.tm.soufflet_statics)
    js = jit(jax_tracers, p.js, p.jmesh, p.cfg, p.jm.tracer_statics, p.jf,
             0.0, p.jm.soufflet_statics)
    assert_states_close(ts, js, ("tr", "tr_old"))
