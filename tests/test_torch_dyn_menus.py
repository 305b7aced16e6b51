"""The ocean dynamics menus in the port against the JAX package (CPU,
float64): every PGF form but the cavity one (``test_torch_cavity.py``),
floating-ice loading, the
vector-invariant momentum (``mom_adv=3``) and ``visc_option`` 0-8.

Module level, each output within 1e-12 of its largest JAX magnitude:
the PGF forms on the zstar channel after one step (Shchepetkin, cubic
spline, easypgf), on the linfs channel with full cells (nemo, cubic
spline) and on the level-3 globe under linfs with partial cells (nemo,
Shchepetkin, cubic spline, easypgf; the state of the port's
``pressure_bv`` on the globe's T/S); ``relative_vorticity``,
``compute_vel_rhs_vinv``, the ice loading of ``compute_vel_rhs`` and
``viscosity_filter`` for options 0-8 on the zstar channel's state, with a
seeded UKE reservoir for option 8.  Then three whole steps of the channel
for each form, ``mom_adv=3`` and the loading, within 1e-9
(``test_torch_visc_steps.py``: each viscosity option).  The JAX side of
the module checks runs eagerly: compiled, XLA rounds the vector-invariant
rhs up to 1.5e-12 of max|rhs| away from its own eager result.  The
channel is the code-built one (8 x 24 nodes, 10 layers of 400 m); the
viscosity runs with the CI coefficients, since the channel's own
gamma0 = 0 leaves the harmonic filters nothing to do.
"""
import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fesom2_tpu.config as jconfig
import fesom2_tpu.model as jmodel
from fesom2_tpu.core import dynamics as jdyn
from fesom2_tpu.core.state import OceanState as JOceanState, \
    zero_forcing as jax_zero_forcing
from fesom2_tpu.mesh import build_mesh as jax_build_mesh

from fesom2_tpu_torch.convert import to_numpy
from fesom2_tpu_torch.core import dynamics, eos
from fesom2_tpu_torch.core.state import zero_forcing
from fesom2_tpu_torch.mesh import globe
from fesom2_tpu_torch.mesh.channel import channel_raw_mesh, write_mesh
from fesom2_tpu_torch.model import (pi_config, setup_pi_model,
                                    replace_coriolis as port_replace_coriolis,
                                    setup_soufflet_model, soufflet_config)
from fesom2_tpu_torch.run import globe_ocean_inputs

from test_torch_zstar import FIELDS, Pair, _to_port, assert_close

CI_VISC = dict(gamma0=0.003, gamma1=0.1, gamma2=0.285, Div_c=0.5,
               Leith_c=0.05)


def jax_config(tcfg):
    """JAX's ModelConfig with the values of the port's ``tcfg``."""
    def conv(obj):
        cls = getattr(jconfig, type(obj).__name__)
        return cls(**{f.name: conv(getattr(obj, f.name))
                      if dataclasses.is_dataclass(getattr(obj, f.name))
                      else copy.deepcopy(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    return conv(tcfg)


def channel_cfg(which_ale, **dyn):
    cfg = soufflet_config(which_ale=which_ale)
    for k, v in dict(CI_VISC, **dyn).items():
        setattr(cfg.dyn, k, v)
    return cfg


def channel_pair(path, tcfg):
    p = Pair()
    p.tcfg, p.cfg = tcfg, jax_config(tcfg)
    p.jm = jmodel.setup_soufflet_model(mesh_path=path, cfg=p.cfg)
    p.tm = setup_soufflet_model(path, device="cpu", cfg=tcfg)
    p.jmesh = jmodel.replace_coriolis(p.jm.mesh,
                                      p.jm.soufflet_statics.coriolis)
    p.tmesh = port_replace_coriolis(p.tm.mesh,
                                    p.tm.soufflet_statics.coriolis)
    return p


def spun_up(p, jf=None):
    """The pair with the JAX state after one step, in both packages."""
    p.jf = jf if jf is not None else jax_zero_forcing(p.jm.mesh)
    p.js = p.jm.step_fn()(p.jm.initial_state(), p.jf)
    p.ts = _to_port(p.js)
    return p


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    torch.set_num_threads(1)
    return write_mesh(channel_raw_mesh(8, 24, 10, dz=400.0),
                      str(tmp_path_factory.mktemp("channel")))


@pytest.fixture(scope="module")
def zstar(path):
    p = spun_up(channel_pair(path, channel_cfg("zstar")))
    assert float(np.abs(np.asarray(p.js.hbar)).max()) > 1e-6
    return p


@pytest.fixture(scope="module")
def linfs(path):
    return spun_up(channel_pair(path, channel_cfg("linfs")))


@pytest.fixture(scope="module")
def globe_pc(tmp_path_factory):
    """The level-3 globe under linfs with partial cells: the port's state
    with T/S of the globe fixtures after ``pressure_bv``, and the same
    state as JAX's."""
    path = globe.write_globe(str(tmp_path_factory.mktemp("globe")), level=3,
                             n_layers=12, dz_bottom=1000.0)
    tcfg = pi_config("fast")
    tcfg.run.use_ice = False
    tcfg.ale.use_partial_cell = True
    p = Pair()
    p.tcfg, p.cfg = tcfg, jax_config(tcfg)
    p.tm, _ = setup_pi_model(path, device="cpu", cfg=tcfg)
    p.tmesh = p.tm.mesh
    p.jmesh = jax_build_mesh(path, force_rotation=True,
                             cyclic_length_deg=360.0, use_partial_cell=True,
                             partial_cell_thresh=tcfg.ale.partial_cell_thresh)
    ts = globe_ocean_inputs(p.tm, seed=0)[0]
    p.ts = eos.pressure_bv(ts, p.tmesh, tcfg, p.tm.density_ref)
    p.js = JOceanState(**{k: jnp.asarray(v)
                          for k, v in to_numpy(p.ts).items()})
    lay = np.asarray(p.jmesh.nlevels_elem)
    assert len(set(lay.tolist())) > 3       # columns of many depths
    return p


def pgf_both(p, which):
    tcfg = copy.deepcopy(p.tcfg)
    tcfg.dyn.which_pgf = which
    js = jdyn.pressure_force(p.js, p.jmesh, jax_config(tcfg))
    ts = dynamics.pressure_force(p.ts, p.tmesh, tcfg)
    for name in ("pgf_x", "pgf_y"):
        assert_close(getattr(ts, name), getattr(js, name), name, tol=1e-12)
    assert float(ts.pgf_x.abs().max()) > 0.0
    return ts


@pytest.mark.parametrize("which", ["shchepetkin", "cubicspline", "easypgf"])
def test_pgf_forms_on_the_zstar_channel(zstar, which):
    pgf_both(zstar, which)


@pytest.mark.parametrize("which", ["nemo", "cubicspline"])
def test_pgf_forms_on_the_linfs_channel_with_full_cells(linfs, which):
    ts = pgf_both(linfs, which)
    # each departs from the full-cell form in the bottom layer; nemo there
    # only
    ref = dynamics.pressure_force_linfs(linfs.ts, linfs.tmesh)
    nle = linfs.tmesh.nlevels_elem.long() - 2
    bot = torch.arange(linfs.tmesh.nl - 1)[:, None] == nle[None, :]
    assert not torch.equal(ts.pgf_x[bot], ref.pgf_x[bot])
    if which == "nemo":
        assert torch.equal(ts.pgf_x[~bot], ref.pgf_x[~bot])


@pytest.mark.parametrize("which",
                         ["nemo", "shchepetkin", "cubicspline", "easypgf"])
def test_pgf_forms_on_the_globe_with_partial_cells(globe_pc, which):
    pgf_both(globe_pc, which)


def test_pgf_dispatch_raises_where_jax_does(globe_pc, zstar):
    cfg = copy.deepcopy(globe_pc.tcfg)
    cfg.dyn.which_pgf = "sergey"
    with pytest.raises(ValueError, match="partial"):
        dynamics.pressure_force(globe_pc.ts, globe_pc.tmesh, cfg)
    cfg = copy.deepcopy(zstar.tcfg)
    cfg.dyn.which_pgf = "nemo"
    with pytest.raises(ValueError, match="zlevel/zstar"):
        dynamics.pressure_force(zstar.ts, zstar.tmesh, cfg)
    # cavity partial cells change the menu under linfs only, as in JAX
    cfg.run.use_cavity_partial_cell = True
    with pytest.raises(ValueError, match="zlevel/zstar"):
        dynamics.pressure_force(zstar.ts, zstar.tmesh, cfg)
    cfg = copy.deepcopy(globe_pc.tcfg)
    cfg.run.use_cavity_partial_cell = True
    cfg.dyn.which_pgf = "nemo"
    with pytest.raises(ValueError, match="cavity partial cells"):
        dynamics.pressure_force(globe_pc.ts, globe_pc.tmesh, cfg)


def test_relative_vorticity_and_vector_invariant_rhs(zstar):
    p = zstar
    assert_close(dynamics.relative_vorticity(p.ts, p.tmesh),
                 jdyn.relative_vorticity(p.js, p.jmesh), "vort", tol=1e-12)
    tcfg = copy.deepcopy(p.tcfg)
    tcfg.dyn.mom_adv = 3
    jcfg = jax_config(tcfg)
    js, ju, jv = jdyn.compute_vel_rhs_vinv(p.js, p.jmesh, p.jf, jcfg)
    ts, tu, tv = dynamics.compute_vel_rhs_vinv(p.ts, p.tmesh,
                                               zero_forcing(p.tmesh), tcfg)
    for name, got, ref in (("u_rhs", tu, ju), ("v_rhs", tv, jv),
                           ("u_rhsAB", ts.u_rhsAB, js.u_rhsAB),
                           ("v_rhsAB", ts.v_rhsAB, js.v_rhsAB)):
        assert_close(got, ref, name, tol=1e-12)


def ice_forcing(mesh, seed):
    """Zero forcing with seeded ice and snow masses, up to a loading above
    ``max_ice_loading`` (5 m)."""
    rng = np.random.default_rng(seed)
    N = int(mesh.n_nodes)
    return dict(m_ice=rng.uniform(0.0, 8.0, N), m_snow=rng.uniform(0.0, 1.0, N))


def test_floating_ice_loading(zstar):
    p = zstar
    fx = ice_forcing(p.tmesh, 5)
    tf = dataclasses.replace(zero_forcing(p.tmesh), **{
        k: torch.tensor(v) for k, v in fx.items()})
    jf = dataclasses.replace(p.jf, **{k: jnp.asarray(v)
                                      for k, v in fx.items()})
    outs = {}
    for ale, floatice in (("zstar", True), ("zstar", False), ("linfs", True)):
        tcfg = copy.deepcopy(p.tcfg)
        tcfg.ale.which_ALE, tcfg.run.use_floatice = ale, floatice
        jcfg = jax_config(tcfg)
        _, ju, jv = jdyn.compute_vel_rhs(p.js, p.jmesh, jf, jcfg)
        _, tu, tv = dynamics.compute_vel_rhs(p.ts, p.tmesh, tf, tcfg)
        assert_close(tu, ju, "u_rhs", tol=1e-12)
        assert_close(tv, jv, "v_rhs", tol=1e-12)
        outs[(ale, floatice)] = tu
    # the load acts off linfs only
    assert not torch.equal(outs[("zstar", True)], outs[("zstar", False)])
    assert torch.equal(outs[("linfs", True)], outs[("zstar", False)])


def seeded_uke(p, seed=7):
    """The pair's states with a seeded UKE reservoir and its last rhs."""
    rng = np.random.default_rng(seed)
    lmask = np.asarray(p.jmesh.elem_layer_mask)
    uke = np.where(lmask, rng.uniform(0.0, 1e-3, lmask.shape), 0.0)
    rhs = np.where(lmask, rng.uniform(-1e-8, 1e-8, lmask.shape), 0.0)
    js = dataclasses.replace(p.js, uke=jnp.asarray(uke),
                             uke_rhs=jnp.asarray(rhs))
    return js, _to_port(js)


@pytest.mark.parametrize("option", range(9))
def test_viscosity_filter(zstar, option):
    p = zstar
    tcfg = copy.deepcopy(p.tcfg)
    tcfg.dyn.visc_option = option
    jcfg = jax_config(tcfg)
    js, ts = seeded_uke(p)
    rng = np.random.default_rng(100 + option)
    lmask = np.asarray(p.jmesh.elem_layer_mask)
    u0, v0 = (np.where(lmask, rng.uniform(-1e-3, 1e-3, lmask.shape), 0.0)
              for _ in range(2))
    jo = jdyn.viscosity_filter(js, p.jmesh, jcfg, jnp.asarray(u0),
                               jnp.asarray(v0))
    to = dynamics.viscosity_filter(ts, p.tmesh, tcfg, torch.tensor(u0),
                                   torch.tensor(v0))
    assert_close(to[1], jo[1], "u_rhs", tol=1e-12)
    assert_close(to[2], jo[2], "v_rhs", tol=1e-12)
    assert float((to[1] - torch.tensor(u0)).abs().max()) > 0.0
    if option == 8:
        for name in ("uke", "uke_rhs"):
            assert_close(getattr(to[0], name), getattr(jo[0], name), name,
                         tol=1e-12)


STEP_CASES = [("zstar", dict(mom_adv=3)), ("zstar", dict(use_floatice=True)),
              ("zstar", dict(which_pgf="cubicspline")),
              ("zstar", dict(which_pgf="easypgf")),
              ("linfs", dict(which_pgf="nemo")),
              ("linfs", dict(which_pgf="cubicspline"))]


def case_id(ale, knobs):
    return f"{ale}-{'-'.join(f'{k}={v}' for k, v in knobs.items())}"


def three_steps_match_jax(path, ale, knobs):
    """Three whole channel steps with ``knobs`` set, from the same initial
    state, within 1e-9 of JAX's (dense SSH solve)."""
    tcfg = channel_cfg(ale)
    for k, v in knobs.items():
        setattr(tcfg.run if k == "use_floatice" else tcfg.dyn, k, v)
    p = channel_pair(path, tcfg)
    jf, tf = jax_zero_forcing(p.jm.mesh), zero_forcing(p.tm.mesh)
    if "use_floatice" in knobs:
        fx = ice_forcing(p.tm.mesh, 6)
        jf = dataclasses.replace(jf, **{k: jnp.asarray(v)
                                        for k, v in fx.items()})
        tf = dataclasses.replace(tf, **{k: torch.tensor(v)
                                        for k, v in fx.items()})
    js, tstate = p.jm.initial_state(), p.tm.initial_state()
    ts = _to_port(js)
    assert torch.equal(ts.u, tstate.u) and torch.equal(ts.tr, tstate.tr)
    jstep, tstep = p.jm.step_fn(), p.tm.step_fn()
    for _ in range(3):
        js = jstep(js, jf)
        ts = tstep(ts, tf)
    for name in FIELDS + ("uke", "uke_rhs"):
        assert_close(getattr(ts, name), getattr(js, name), name, tol=1e-9)
    return ts


@pytest.mark.parametrize("ale,knobs", STEP_CASES,
                         ids=[case_id(*c) for c in STEP_CASES])
def test_three_channel_steps_match_jax(path, ale, knobs):
    three_steps_match_jax(path, ale, knobs)
