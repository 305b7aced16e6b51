"""The ocean step of the benched CI configuration in the port against the
JAX package, on the level-3 globe with 12 layers (zstar, partial cells,
JM, KPP, GM + Redi, ``w_split``, MFCT/QR4C/FCT, shortwave penetration).

The JAX reference is built by the calls of ``_finish_pi_setup``
(``fesom2_tpu/model.py:849-886``) on the same mesh files, since
``setup_pi_model`` itself reads the forcing files, which are not in the
repository; both run the same initial state and forcing
(``run.globe_ocean_inputs``).  The module tests start from the JAX state
after one step; every output agrees to 1e-10 of its largest JAX
magnitude (float64, CPU).  Three whole steps agree to 1e-9 with the dense
SSH solve and to 1e-8 with CG forced (``DENSE_SSH_MAX_NODES = 0``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fesom2_tpu.model as jmodel
from fesom2_tpu.core import (ale as jale, eos as jeos, gm_redi as jgm,
                             ssh as jssh, tracers as jtr)
from fesom2_tpu.core.state import initial_z3d as jz3d, \
    zero_forcing as jzero_forcing
from fesom2_tpu.core.tracer_setup import build_tracer_statics as jtst
from fesom2_tpu.mesh import build_mesh as jax_build_mesh

import fesom2_tpu_torch.model as tmodel
from fesom2_tpu_torch import kernels
from fesom2_tpu_torch.convert import state_from_numpy, to_numpy
from fesom2_tpu_torch.core import ale, eos, tracers
from fesom2_tpu_torch.mesh import globe
from fesom2_tpu_torch.model import pi_config, setup_pi_model, solve_tracers
from fesom2_tpu_torch.run import globe_ocean_inputs, run_pi_ocean

from test_torch_kpp import assert_close

FIELDS = ("u", "v", "eta", "hbar", "d_eta", "tr", "tr_old", "w", "w_e",
          "Kv", "Av", "hnode", "helem", "zbar_3d", "Z_3d", "bvfreq",
          "fer_u", "fer_v", "fer_w", "mixlength")
FORCED = ("stress_x", "stress_y", "stress_atm_x", "stress_atm_y",
          "heat_flux", "water_flux")


def ci_config(**dyn):
    cfg = pi_config()
    cfg.run.use_ice = False
    for k, v in dyn.items():
        setattr(cfg.dyn, k, v)
    return cfg


def jax_ci_model(path, cfg):
    """The JAX model of ``_finish_pi_setup`` without forcing and ice."""
    m = jax_build_mesh(path, force_rotation=True, cyclic_length_deg=360.0,
                       use_partial_cell=cfg.ale.use_partial_cell,
                       partial_cell_thresh=cfg.ale.partial_cell_thresh)
    _, Z3 = jz3d(m, jnp.float64)
    kw = dict(ssh_diag_inv=None,
              density_ref=jeos.reference_density(m, Z3,
                                                 cfg.dyn.state_equation))
    if m.n_nodes <= jmodel.DENSE_SSH_MAX_NODES:
        kw["ssh_dense_inv"] = jssh.ssh_dense_inverse(m, cfg)
    else:
        kw["ssh_block_pc"] = jssh.build_block_schwarz(m, cfg)
        kw["ssh_ring"] = jssh.build_ssh_ring_ale(m, cfg)
    return jmodel.Model(mesh=m, cfg=cfg, tracer_statics=jtst(
        m, K_hor=cfg.tra.K_hor), **kw)


def jax_inputs(jm, ts, tf, tsw):
    js = jm.initial_state()
    js = dataclasses.replace(js, tr=jnp.asarray(to_numpy(ts.tr)),
                             tr_old=jnp.asarray(to_numpy(ts.tr_old)))
    jf = dataclasses.replace(jzero_forcing(jm.mesh), **{
        k: jnp.asarray(to_numpy(getattr(tf, k))) for k in FORCED})
    return js, jf, jnp.asarray(to_numpy(tsw))


def jax_run(jm, jstep, js, jf, jsw, n):
    """``run.run_pi_ocean`` on the JAX side (model.py:396-407, no ice)."""
    for _ in range(n):
        sw3, dheat = jtr.shortwave_penetration(
            jsw, jnp.zeros_like(jsw), js.zbar_3d, jm.mesh, jm.cfg.ice.albw)
        js = jstep(js, dataclasses.replace(jf, heat_flux=jf.heat_flux
                                           + dheat), sw3)
    return js


def to_port(js):
    return state_from_numpy({f.name: np.asarray(getattr(js, f.name))
                             for f in dataclasses.fields(js)}, "cpu")


class Pair:
    """The JAX and the port side of the CI setup."""


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    torch.set_num_threads(1)
    p = Pair()
    p.path = globe.write_globe(str(tmp_path_factory.mktemp("globe")),
                               level=3, n_layers=12, dz_bottom=1000.0)
    p.cfg = ci_config()
    p.tm, _ = setup_pi_model(p.path, device="cpu", cfg=p.cfg)
    p.jm = jax_ci_model(p.path, p.cfg)
    p.ts0, p.tf, p.tsw = globe_ocean_inputs(p.tm, seed=0)
    p.js0, p.jf, p.jsw = jax_inputs(p.jm, p.ts0, p.tf, p.tsw)
    p.jstep = p.jm.step_fn()
    p.js = jax_run(p.jm, p.jstep, p.js0, p.jf, p.jsw, 1)
    p.ts = to_port(p.js)
    p.jmesh, p.tmesh = p.jm.mesh, p.tm.mesh
    assert float(np.abs(np.asarray(p.js.hbar)).max()) > 1e-6
    return p


def jit(fn, *args):
    return jax.jit(fn)(*args)


def test_setup_needs_the_ice_off(pair):
    """The ocean-only model of this file has the ice off and no ice
    subdomain; with the ice on (``pi_config()`` as it stands) the setup
    builds the subdomain, under any of the three EVP rheologies."""
    assert not pair.cfg.run.use_ice and pair.tm.ice_sub is None
    cfg = pi_config()
    assert cfg.run.use_ice
    coupled, atm = setup_pi_model(pair.path, device="cpu", cfg=cfg)
    assert coupled.ice_sub is not None
    assert atm.tair.shape[1] == coupled.mesh.n_nodes
    cfg.ice.whichEVP = 2
    adaptive, _ = setup_pi_model(pair.path, device="cpu", cfg=cfg)
    assert adaptive.ice_sub is not None
    with pytest.raises(ValueError, match="parity"):
        pi_config(parity="bogus")


def test_initial_state_and_config(pair):
    p = pair
    assert p.cfg.ale.use_partial_cell and p.cfg.dyn.w_split
    assert p.tm.ssh_dense_inv is not None
    for f in dataclasses.fields(p.js0):
        a = np.asarray(getattr(p.js0, f.name))
        if a.size:
            assert_close(getattr(p.ts0, f.name), a, f.name, tol=1e-13)
    assert p.ts0.fer_u.shape == (p.tmesh.nl - 1, p.tmesh.n_elems)


def test_pressure_bv_jm_partial_cells(pair):
    p = pair
    js = jit(lambda s: jeos.pressure_bv(s, p.jmesh, p.cfg,
                                        p.jm.density_ref), p.js)
    kernels.reset_launches()
    ts = eos.pressure_bv(p.ts, p.tmesh, p.cfg, p.tm.density_ref)
    assert kernels.LAUNCHES["pressure_bv"] == 0
    for name in ("density_m_rho0", "hpressure", "bvfreq", "dbsfc", "mld2"):
        assert_close(getattr(ts, name), getattr(js, name), name)
    a, b = eos.sw_alpha_beta(p.ts.tr[0], p.ts.tr[1], p.ts.Z_3d)
    ja, jb = jeos.sw_alpha_beta(p.js.tr[0], p.js.tr[1], p.js.Z_3d)
    assert_close(a, ja, "alpha")
    assert_close(b, jb, "beta")


@pytest.fixture(scope="module")
def split(pair):
    """vert_vel_ale with a w_max_cfl low enough that w_i is live."""
    p = pair
    cfg = ci_config(w_max_cfl=1e-5)
    js = jit(lambda s, f: jale.vert_vel_ale(s, p.jmesh, cfg, f), p.js, p.jf)
    assert float(np.abs(np.asarray(js.w_i)).max()) > 0.0
    return cfg, js


def test_vert_vel_ale_w_split(pair, split):
    p = pair
    cfg, js = split
    ts = ale.vert_vel_ale(p.ts, p.tmesh, cfg, p.tf)
    for name in ("w", "w_e", "w_i", "cfl_z", "hnode_new"):
        assert_close(getattr(ts, name), getattr(js, name), name)
    # the CI limit (w_max_cfl = 1) leaves the split idle on this mesh
    ts = ale.vert_vel_ale(p.ts, p.tmesh, p.cfg, p.tf)
    assert torch.equal(ts.w_e, ts.w)


def test_adv_vert_impl(pair, split):
    p = pair
    _, js = split
    impl = lambda t: jtr.adv_vert_impl(t, js.w_i, js.hnode_new, p.jmesh,
                                       p.cfg.dt)
    want = jit(jax.vmap(impl), js.tr)
    ts = to_port(js)
    got = tracers.adv_vert_impl(ts.tr, ts.w_i, ts.hnode_new, p.tmesh,
                                p.cfg.dt)
    assert_close(got, want, "adv_vert_impl")
    assert float((got - ts.tr).abs().max()) > 0.0


@pytest.fixture(scope="module")
def grads(pair):
    """The JAX stage-1 inputs: element gradients, MUSCL reconstructions,
    edge transports, the tapered slope and layered Ki of the GM chain."""
    p = pair
    js, m, st = p.js, p.jmesh, p.jm.tracer_statics
    g = Pair()
    g.gx, g.gy = jit(lambda t: jtr.tracer_gradient_elements(t, m), js.tr)
    g.rec = jit(lambda a, b: jtr.fill_up_dn_grad_r(a, b, m, st), g.gx, g.gy)
    g.vflux = jit(lambda s: jtr._edge_vflux(s.u, s.v, s.helem, m), js)
    sig = jgm.compute_sigma_xy(js, m)
    ns, g.taper = jgm.compute_neutral_slope(sig, js.bvfreq, m)
    _, _, g.Ki = jgm.init_redi_gm(js, m, p.cfg, ns)
    g.tr_z = jit(lambda t: jtr.tracer_gradient_z(t, js.Z_3d, m), js.tr)
    return g


def t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("scheme", ["MFCT", "MUSCL"])
def test_adv_hor_lo_ho(pair, grads, scheme):
    p, g = pair, grads
    m, st = p.jmesh, p.jm.tracer_statics
    tAB = 1.6 * p.js.tr - 0.6 * p.js.tr_old
    want = jit(lambda t_, a, v: jtr.adv_hor_lo_ho(
        t_, a, v, m, st, g.rec, 1.0, scheme=scheme), p.js.tr, tAB, g.vflux)
    got = tracers.adv_hor_lo_ho(p.ts.tr, t(tAB), t(g.vflux), p.tmesh,
                                p.tm.tracer_statics, tuple(map(t, g.rec)),
                                1.0, scheme=scheme)
    for name, a, b in zip(("flux_lo", "flux_adf"), got, want):
        assert_close(a, b, f"{scheme} {name}")


def test_mfct_keeps_the_boundary_correction(pair, grads):
    p, g = pair, grads
    tAB = t(1.6 * p.js.tr - 0.6 * p.js.tr_old)
    args = (p.ts.tr, tAB, t(g.vflux), p.tmesh, p.tm.tracer_statics,
            tuple(map(t, g.rec)), 1.0)
    mfct = tracers.adv_hor_lo_ho(*args, scheme="MFCT")[1]
    muscl = tracers.adv_hor_lo_ho(*args, scheme="MUSCL")[1]
    assert float((mfct - muscl).abs().max()) > 0.0


def test_tracer_gradient_z_and_diff_hor_redi(pair, grads):
    p, g = pair, grads
    assert_close(tracers.tracer_gradient_z(p.ts.tr, p.ts.Z_3d, p.tmesh),
                 g.tr_z, "tr_z")
    m = p.jmesh
    want = jit(lambda a, b: jtr.diff_hor(a, b, p.js.helem, g.Ki, m, p.cfg.dt,
                                         tr_z=g.tr_z, slope_tapered=g.taper),
               g.gx, g.gy)
    got = tracers.diff_hor(t(g.gx), t(g.gy), p.ts.helem, t(g.Ki), p.tmesh,
                           p.cfg.dt, tr_z=t(g.tr_z), slope_tapered=t(g.taper))
    assert_close(got, want, "diff_hor redi")


def test_diff_ver_redi_expl(pair, grads):
    p, g = pair, grads
    want = jit(lambda a, b: jtr.diff_ver_redi_expl(
        a, b, g.taper, g.Ki, p.js.hnode_new, p.jmesh, p.cfg.dt), g.gx, g.gy)
    got = tracers.diff_ver_redi_expl(t(g.gx), t(g.gy), t(g.taper), t(g.Ki),
                                     p.ts.hnode_new, p.tmesh, p.cfg.dt)
    assert_close(got, want, "diff_ver_redi_expl")
    assert float(got.abs().max()) > 0.0


def test_shortwave(pair):
    p = pair
    sw, dheat = jtr.shortwave_penetration(p.jsw, jnp.zeros_like(p.jsw),
                                          p.js.zbar_3d, p.jmesh,
                                          p.cfg.ice.albw)
    tsw, tdheat = tracers.shortwave_penetration(
        p.tsw, torch.zeros_like(p.tsw), p.ts.zbar_3d, p.tmesh, p.cfg.ice.albw)
    assert_close(tsw, sw, "sw_3d")
    assert_close(tdheat, dheat, "dheat")
    assert_close(tracers.sw_3d_source(tsw, p.tmesh, p.cfg.dt),
                 jtr.sw_3d_source(sw, p.jmesh, p.cfg.dt), "sw_source")


def test_diff_ver_impl_wi_sw_k33(pair, grads, split):
    p, g = pair, grads
    _, jsv = split
    m, dt = p.jmesh, p.cfg.dt
    sw, _ = jtr.shortwave_penetration(p.jsw, jnp.zeros_like(p.jsw),
                                      p.js.zbar_3d, m, p.cfg.ice.albw)
    src = jtr.sw_3d_source(sw, m, dt)
    surf = -dt * p.jf.heat_flux / 4.2e6
    want = jit(lambda tt: jtr.diff_ver_impl(
        tt, p.js.Kv, jsv.hnode_new, m.zbar_n_bot, m, dt, surf, w_i=jsv.w_i,
        sw_source=src, Ki_layered=g.Ki, slope3=g.taper[2]), p.js.tr[0])
    got = tracers.diff_ver_impl(
        p.ts.tr[:1], p.ts.Kv, t(jsv.hnode_new), p.tmesh.zbar_n_bot, p.tmesh,
        dt, t(surf)[None], w_i=t(jsv.w_i), sw_source=t(src)[None],
        Ki_layered=t(g.Ki), slope3=t(g.taper[2]))
    assert_close(got[0], want, "diff_ver_impl")


def test_solve_tracers_ci_path(pair):
    """solve_tracers with the GM bolus velocities, the Redi fields, the
    w split's FCT branch and the shortwave source, after the GM chain and
    vert_vel_ale of the step."""
    p = pair
    m, cfg = p.jmesh, p.cfg

    def prep(s, f):
        sig = jgm.compute_sigma_xy(s, m)
        ns, taper = jgm.compute_neutral_slope(sig, s.bvfreq, m)
        fer_c, fer_K, Ki = jgm.init_redi_gm(s, m, cfg, ns)
        gam = jgm.fer_solve_gamma(s, m, sig, fer_c, fer_K)
        fu, fv = jgm.fer_gamma2vel(gam, s, m)
        fer = (fu, fv, jale.bolus_wvel(fu, fv, s, m))
        return jale.vert_vel_ale(s, m, cfg, f), fer, (taper, Ki)
    js, fer, redi = jit(prep, p.js, p.jf)
    sw, dheat = jtr.shortwave_penetration(p.jsw, jnp.zeros_like(p.jsw),
                                          p.js.zbar_3d, m, cfg.ice.albw)
    jf = dataclasses.replace(p.jf, heat_flux=p.jf.heat_flux + dheat)
    want = jit(lambda s, f: jmodel.solve_tracers(
        s, m, cfg, p.jm.tracer_statics, f, 1.0, None, fer=fer, redi=redi,
        sw_3d=sw), js, jf)
    tf = dataclasses.replace(p.tf, heat_flux=t(jf.heat_flux))
    got = solve_tracers(to_port(js), p.tmesh, cfg, p.tm.tracer_statics, tf,
                        1.0, None, fer=tuple(map(t, fer)),
                        redi=(t(redi[0]), t(redi[1])), sw_3d=t(sw))
    assert_close(got.tr, want.tr, "tr")
    assert_close(got.tr_old, want.tr_old, "tr_old")


def test_three_steps_match_jax_dense(pair):
    p = pair
    js = jax_run(p.jm, p.jstep, p.js0, p.jf, p.jsw, 3)
    kernels.reset_launches()
    ts = run_pi_ocean(p.tm, p.ts0, p.tf, p.tsw, 3)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    for name in FIELDS:
        assert_close(getattr(ts, name), getattr(js, name), name, tol=1e-9)
    assert int(ts.step) == 3


def test_three_steps_match_jax_cg_forced(pair):
    p = pair
    dense = (jmodel.DENSE_SSH_MAX_NODES, tmodel.DENSE_SSH_MAX_NODES)
    jmodel.DENSE_SSH_MAX_NODES = tmodel.DENSE_SSH_MAX_NODES = 0
    try:
        tm, _ = setup_pi_model(p.path, device="cpu", cfg=p.cfg)
        jm = jax_ci_model(p.path, p.cfg)
    finally:
        jmodel.DENSE_SSH_MAX_NODES, tmodel.DENSE_SSH_MAX_NODES = dense
    assert tm.ssh_dense_inv is None and tm.ssh_block_pc is not None
    js = jax_run(jm, jm.step_fn(), p.js0, p.jf, p.jsw, 3)
    ts = run_pi_ocean(tm, p.ts0, p.tf, p.tsw, 3)
    assert tm.ssh_iters > 0
    for name in FIELDS:
        assert_close(getattr(ts, name), getattr(js, name), name, tol=1e-8)


def test_run_pi_ocean_sane(pair):
    p = pair
    s = run_pi_ocean(p.tm, p.ts0, p.tf, p.tsw, 4)
    m = p.tmesh
    for name in ("u", "v", "eta", "hbar", "tr", "w", "Kv", "Av"):
        assert torch.isfinite(getattr(s, name)).all(), name
    T = s.tr[0][m.node_layer_mask]
    assert float(s.u.abs().max()) < 3.0
    assert -3.0 < float(T.min()) and float(T.max()) < 35.0
    a = m.area[0]
    assert abs(float((s.hbar * a).sum() / a.sum())) < 1e-6
