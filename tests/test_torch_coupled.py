"""The coupled ocean + ice step of the benched CI configuration in the port
against the JAX package, on the level-3 globe with 12 layers (CPU,
float64): forcing update -> ocean2ice -> mEVP on the polar-cap subdomain
-> ice FCT advection -> ice thermodynamics -> fluxes -> the ocean step.

The JAX reference is built from its parts, since its ``setup_pi_model``
reads forcing files that are not in the repository: the model of
``test_torch_ci_ocean.jax_ci_model`` with the ice on, ``ice_submesh`` from
``build_ice_subdomain`` and an ``AtmData`` filled with the arrays of
``mesh.globe.globe_atm_fixtures``; then its own jitted
``pi_coupled_step_fn``.  Both sides start from the port's
``pi_initial_state`` (T/S of the globe fixtures, ice where the surface is
colder than 0 C).

Tolerances, of each field's largest JAX magnitude after three steps:
1e-9 with the dense SSH solve and 120 mEVP subcycles (ocean, ice and the
fluxes handed to the ocean), 1e-8 with CG forced
(``DENSE_SSH_MAX_NODES = 0``; 8 subcycles), and 1e-9 with
``ice_ave_steps = 2``, where the ice is held on even steps and stepped
with twice the time step on odd ones (8 subcycles; four steps, so the ice
is stepped twice).  Every run asserts ice that is there (a_ice > 0.5
somewhere), moves and is under stress, or it would prove nothing.
"""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fesom2_tpu.model as jmodel
from fesom2_tpu.forcing.atmos import AtmData as JAtmData
from fesom2_tpu.ice.state import IceState as JIceState
from fesom2_tpu.ice.subdomain import build_ice_subdomain as jbuild_sub

import fesom2_tpu_torch.model as tmodel
from fesom2_tpu_torch import kernels
from fesom2_tpu_torch.convert import to_numpy
from fesom2_tpu_torch.mesh import globe
from fesom2_tpu_torch.model import (check_slice, coupled_step_fn, pi_config,
                                    pi_coupled_step_fn, pi_initial_state,
                                    setup_pi_model, soufflet_config)
from fesom2_tpu_torch.forcing.atmos import update_atm_forcing
from fesom2_tpu_torch.ice.coupling import ocean2ice
from fesom2_tpu_torch.ice.state import zero_ice_forcing
from fesom2_tpu_torch.run import (ice_outside_subdomain, run_pi, step_info)

from test_torch_ci_ocean import FIELDS, jax_ci_model
from test_torch_kpp import assert_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ICE_FIELDS = [f.name for f in dataclasses.fields(JIceState)]
FLUXES = ("stress_x", "stress_y", "heat_flux", "water_flux", "relax_salt",
          "real_salt_flux", "stress_atm_x", "a_ice", "prec_rain")


class Pair:
    """The JAX and the port side of one coupled setup."""


def coupled_pair(path, cfg, dense_limit=None):
    """Both models, atmospheres and initial states for ``cfg``; with
    ``dense_limit`` the dense SSH limit of both packages during setup."""
    p = Pair()
    p.path, p.cfg = path, cfg
    saved = (jmodel.DENSE_SSH_MAX_NODES, tmodel.DENSE_SSH_MAX_NODES)
    if dense_limit is not None:
        jmodel.DENSE_SSH_MAX_NODES = tmodel.DENSE_SSH_MAX_NODES = dense_limit
    try:
        p.tm, p.tatm = setup_pi_model(path, device="cpu", cfg=cfg, atm_seed=4)
        p.jm = jax_ci_model(path, cfg)
    finally:
        jmodel.DENSE_SSH_MAX_NODES, tmodel.DENSE_SSH_MAX_NODES = saved
    p.jm.ice_submesh = jbuild_sub(p.jm.mesh, lat_deg=cfg.ice.evp_subdomain_lat)
    fx = globe.globe_atm_fixtures(np.asarray(p.jm.mesh.geo_coords[:, 1]),
                                  seed=4, n_records=4)
    p.jatm = JAtmData(**{k: jnp.asarray(v) for k, v in fx.items()})
    p.ts0, p.tice0 = pi_initial_state(p.tm, seed=0)
    js = p.jm.initial_state()
    p.js0 = dataclasses.replace(js, tr=jnp.asarray(to_numpy(p.ts0.tr)),
                                tr_old=jnp.asarray(to_numpy(p.ts0.tr_old)))
    p.jm.Ssurf = p.js0.tr[1, 0]
    p.jice0 = JIceState(**{k: jnp.asarray(v)
                           for k, v in to_numpy(p.tice0).items()})
    return p


def run_both(p, n_steps):
    jstep = jmodel.pi_coupled_step_fn(p.jm, p.jatm)
    tstep = pi_coupled_step_fn(p.tm, p.tatm)
    js, jice, ts, tice = p.js0, p.jice0, p.ts0, p.tice0
    for k in range(n_steps):
        js, jice, jof = jstep(js, jice, jnp.asarray(k))
        ts, tice, tof = tstep(ts, tice, k)
    return (js, jice, jof), (ts, tice, tof)


def assert_coupled_close(jax_out, port_out, tol):
    (js, jice, jof), (ts, tice, tof) = jax_out, port_out
    for name in FIELDS:
        assert_close(getattr(ts, name), getattr(js, name), name, tol=tol)
    for name in ICE_FIELDS:
        assert_close(getattr(tice, name), getattr(jice, name), name, tol=tol)
    for name in FLUXES:
        assert_close(getattr(tof, name), getattr(jof, name), name, tol=tol)


def assert_ice_alive(tice, tice0):
    assert float(tice.a_ice.max()) > 0.5
    assert float(tice.u_ice.abs().max()) > 1e-4
    assert float(tice.sigma11.abs().max()) > 0.0
    assert float((tice.m_ice - tice0.m_ice).abs().max()) > 0.0
    assert bool((tice.a_ice >= 0).all()) and float(tice.a_ice.max()) <= 1.0


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    torch.set_num_threads(1)
    return globe.write_globe(str(tmp_path_factory.mktemp("globe")), level=3,
                             n_layers=12, dz_bottom=1000.0)


@pytest.fixture(scope="module")
def pair(path):
    return coupled_pair(path, pi_config())


def short_config(**ice):
    cfg = pi_config()
    cfg.ice.evp_rheol_steps = 8
    for k, v in ice.items():
        setattr(cfg.ice, k, v)
    return cfg


def test_setup_returns_model_atmosphere_and_subdomain(pair):
    p = pair
    assert p.cfg.run.use_ice and p.cfg.ice.evp_rheol_steps == 120
    sub = p.tm.ice_sub
    assert sub is not None and 0 < sub.n_nodes < p.tm.mesh.n_nodes
    assert np.array_equal(sub.sub_nodes.numpy(),
                          np.asarray(p.jm.ice_submesh.sub_nodes))
    assert p.tatm.u_wind.shape == (4, p.tm.mesh.n_nodes)
    assert p.tatm.u_wind.dtype == torch.float64
    assert_close(p.tatm.tair, p.jatm.tair, "tair", tol=0.0)
    # the ocean alone: no subdomain is built
    cfg = pi_config()
    cfg.run.use_ice = False
    ocean_only, _ = setup_pi_model(p.path, device="cpu", cfg=cfg)
    assert ocean_only.ice_sub is None


def test_pi_initial_state_has_ice_at_the_cold_surface(pair):
    p = pair
    cold = p.ts0.tr[0, 0] < 0.0
    assert 0 < int(cold.sum()) < p.tm.mesh.n_nodes
    assert torch.equal(p.tice0.a_ice > 0, cold)
    assert set(p.tice0.m_ice[cold].tolist()) <= {1.0, 2.0}
    assert set(p.tice0.m_snow[cold].tolist()) <= {0.1, 0.5}
    assert torch.equal(p.tm.Ssurf, p.ts0.tr[1, 0])
    assert ice_outside_subdomain(p.tice0, p.tm) == 0


def test_three_coupled_steps_match_jax_dense(pair):
    p = pair
    assert p.tm.ssh_dense_inv is not None
    kernels.reset_launches()
    jax_out, port_out = run_both(p, 3)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    assert_coupled_close(jax_out, port_out, tol=1e-9)
    assert_ice_alive(port_out[1], p.tice0)
    assert int(port_out[0].step) == 3


def test_three_coupled_steps_match_jax_cg_forced(path):
    p = coupled_pair(path, short_config(), dense_limit=0)
    assert p.tm.ssh_dense_inv is None and p.tm.ssh_block_pc is not None
    jax_out, port_out = run_both(p, 3)
    assert p.tm.ssh_iters > 0
    assert_coupled_close(jax_out, port_out, tol=1e-8)
    assert_ice_alive(port_out[1], p.tice0)


def test_coupled_steps_with_held_ice_match_jax(path):
    """``ice_ave_steps = 2``: steps 0 and 2 hold the ice, 1 and 3 step it
    with an ice time step of two ocean steps."""
    p = coupled_pair(path, short_config(ice_ave_steps=2))
    tstep = pi_coupled_step_fn(p.tm, p.tatm)
    _, held, _ = tstep(p.ts0, p.tice0, 0)
    for name in ICE_FIELDS:
        assert torch.equal(getattr(held, name), getattr(p.tice0, name)), name
    jax_out, port_out = run_both(p, 4)
    assert_coupled_close(jax_out, port_out, tol=1e-9)
    assert_ice_alive(port_out[1], p.tice0)


def test_coupled_step_fn_takes_given_forcings(pair):
    """``coupled_step_fn`` with the ice forcing of ``update_atm_forcing``
    is ``pi_coupled_step_fn``'s step."""
    p = pair
    tm = p.tm
    surf = ocean2ice(p.ts0, tm.mesh)
    iforc = update_atm_forcing(p.tatm, 0.0, p.tice0.u_ice, p.tice0.v_ice,
                               surf.u_w, surf.v_w, surf.T_oc,
                               zero_ice_forcing(tm.mesh))
    from fesom2_tpu_torch.core.state import zero_forcing
    a = coupled_step_fn(tm)(p.ts0, p.tice0, zero_forcing(tm.mesh), iforc)
    b = pi_coupled_step_fn(tm, p.tatm)(p.ts0, p.tice0, 0)
    assert torch.equal(a[0].tr, b[0].tr) and torch.equal(a[1].u_ice,
                                                         b[1].u_ice)
    assert torch.equal(a[2].heat_flux, b[2].heat_flux)


def test_run_pi_reports_ice_and_flags_it_outside_the_subdomain(pair, capsys):
    p = pair
    cfg = short_config()
    tm, tatm = setup_pi_model(p.path, device="cpu", cfg=cfg, atm_seed=4)
    ts, tice = pi_initial_state(tm)
    ts, tice = run_pi(tm, tatm, ts, tice, 2, verbose=True, logfile_outfreq=1)
    out = capsys.readouterr().out
    assert "ice_area=" in out and "uice_max=" in out and "step       2" in out
    info = step_info(ts, tm.mesh, tice)
    assert info["ice_area"] > 0.0 and info["ice_volume"] > 0.0
    assert 0.0 < info["uice_max"] < 3.0 and -3.0 < info["T_min"]
    # ice at the equator: outside the cap, where the dynamics are frozen
    lat = tm.mesh.geo_coords[:, 1].abs()
    stray = dataclasses.replace(
        tice, a_ice=torch.where(lat < 0.1, torch.full_like(tice.a_ice, 0.5),
                                tice.a_ice),
        m_ice=torch.where(lat < 0.1, torch.full_like(tice.a_ice, 3.0),
                          tice.m_ice))
    assert ice_outside_subdomain(stray, tm) > 0
    with pytest.raises(RuntimeError, match="outside the EVP subdomain"):
        run_pi(tm, tatm, ts, stray, 1)


@pytest.mark.parametrize("knob,value,item", [
    (("run", "use_icepack"), True, "item 18"),
    (("run", "use_global_tides"), True, "item 19"),
    (("ice", "whichEVP"), 0, "item 17"),
    (("ice", "whichEVP"), 2, "item 17"),
    (("dyn", "SPP"), True, "item 15"),
    (("run", "l_mslp"), True, "item 19"),
    (("dyn", "i_vert_visc"), False, "item 15"),
    (("tra", "tra_adv_hor"), "UPW1", "item 15")])
def test_check_slice_raises_for_what_is_not_ported(path, knob, value, item):
    """Item 15's knobs (the salt plume, explicit vertical viscosity, the
    upwind horizontal scheme) are ported and pass; items 17, 18 and 19
    (standard and adaptive EVP, Icepack, the tidal potential, the
    sea-level pressure) are ported: the configuration sets up and takes a
    coupled step (``test_torch_evp_steps.py`` and
    ``test_torch_icepack_steps.py`` hold three steps against JAX)."""
    cfg = pi_config()
    check_slice(cfg)                       # the CI configuration passes
    setattr(getattr(cfg, knob[0]), knob[1], value)
    if item == "item 15":
        check_slice(cfg)
        return
    check_slice(cfg)
    cfg.ice.evp_rheol_steps = 8
    if item == "item 18":
        from fesom2_tpu_torch.ice.icepack import (IcepackConfig,
                                                  init_icepack_state)
        cfg.icepack = IcepackConfig()
    tm, tatm = setup_pi_model(path, device="cpu", cfg=cfg)
    ts, tice = pi_initial_state(tm)
    step = pi_coupled_step_fn(tm, tatm)
    if item == "item 18":
        ipk = init_icepack_state(cfg.icepack, tice.a_ice, tice.m_ice,
                                 tice.m_snow, tice.t_skin)
        ts, tice, ipk, tof = step(ts, tice, 0, ipk)
        assert bool(torch.isfinite(ipk.qin).all())
        assert float(ipk.aicen.sum(0).max()) > 0.5
    else:
        ts, tice, tof = step(ts, tice, 0)
    assert bool(torch.isfinite(ts.tr).all()) and int(ts.step) == 1
    assert bool(torch.isfinite(tice.u_ice).all())
    if knob[1] == "use_global_tides":
        assert float(tof.ssh_gp.abs().max()) > 0.0


@pytest.mark.parametrize("knob,value,item", [
    (("diag", "ldiag_DVD"), True, "item 20"),
    (("tra", "clim_relax"), 1e-6, "item 19"),
    (("ice", "whichEVP"), 2, "item 17"),
    (("run", "use_icepack"), True, "item 18")])
def test_check_slice_still_raises_for_items_17_to_21(path, knob, value,
                                                      item):
    """On the column-physics menus' configuration every item passes
    ``check_slice``: nothing it lists raises any more.  The relaxation to
    climatology, adaptive EVP and Icepack (items 19, 17 and 18) are held
    against JAX in their own files; the DVD diagnostic (item 20) is held
    here: 2 coupled CI steps (8 subcycles) with ``ldiag_DVD`` on, the
    port against the JAX package's jitted step, ``dvd_h`` and ``dvd_v``
    within 1e-10 of their largest JAX magnitude."""
    cfg = pi_config()
    cfg.dyn.mix_scheme = "cvmix_TKE+cvmix_IDEMIX"
    cfg.dyn.SPP = True
    cfg.tra.num_tracers = 6
    cfg.tra.tracer_ID = [0, 1, 101, 301, 302, 303]
    check_slice(cfg)
    setattr(getattr(cfg, knob[0]), knob[1], value)
    check_slice(cfg)
    if item != "item 20":
        return
    cfg = short_config()
    cfg.diag.ldiag_DVD = True
    p = coupled_pair(path, cfg)
    assert p.ts0.dvd_h.shape == (2, p.tm.mesh.nl - 1, p.tm.mesh.n_nodes)
    (js, _, _), (ts, _, _) = run_both(p, 2)
    for name in ("dvd_h", "dvd_v"):
        assert float(getattr(ts, name).abs().max()) > 0.0
        assert_close(getattr(ts, name), getattr(js, name), name, tol=1e-10)
    assert_close(ts.tr, js.tr, "tr", tol=1e-9)


@pytest.mark.parametrize("knob,value", [
    (("dyn", "mix_scheme"), "cvmix_TKE+cvmix_IDEMIX"),
    (("dyn", "mix_scheme"), "cvmix_IDEMIX"),
    (("dyn", "mix_scheme"), "cvmix_KPP"),
    (("dyn", "mix_scheme"), "KPP+cvmix_TIDAL"),
    (("dyn", "mix_scheme"), "PP+cvmix_DDIFF+cvmix_CONV"),
    (("tra", "tra_adv_ver"), "PPM"),
    (("tra", "tra_adv_ver"), "CDIFF"),
    (("tra", "tra_adv_lim"), "NONE"),
    (("tra", "i_vert_diff"), False),
    (("tra", "num_tracers"), 4),
    (("run", "use_cavity"), True)])
def test_check_slice_passes_items_15_and_16(knob, value):
    """CVMix (with cavities too, where the port matches the JAX package:
    its columns start at interface 1 whatever their top), the vertical
    schemes, the unlimited branch, explicit vertical diffusion, passive
    tracers."""
    cfg = pi_config()
    setattr(getattr(cfg, knob[0]), knob[1], value)
    if knob[1] == "use_cavity":
        cfg.dyn.mix_scheme = "cvmix_TKE"
    check_slice(cfg)


@pytest.mark.parametrize("knob,value", [
    (("run", "use_cavity"), True),
    (("run", "use_cavity_partial_cell"), True),
    (("dyn", "which_pgf"), "sergey")])
def test_check_slice_passes_the_cavity_configuration(knob, value):
    """Ice-shelf cavities, cavity partial cells and the 'sergey' PGF are
    ported (``core/cavity.py``, ``dynamics.pressure_force_linfs_cavity``)."""
    cfg = pi_config("fast")
    setattr(getattr(cfg, knob[0]), knob[1], value)
    check_slice(cfg)


def test_check_slice_keeps_the_ice_off_the_toy_channel():
    """Sea ice on the toy channel is what the JAX package does with it:
    the channel's ocean step leaves the ice off (it ignores ``use_ice``),
    and ``coupled_step_fn`` runs the ice on the whole channel
    (``test_torch_menu_steps.py``), so check_slice lets it through, with
    the channel's whichEVP=0 (standard EVP) as with mEVP."""
    cfg = soufflet_config()
    cfg.run.use_ice = True
    assert cfg.ice.whichEVP == 0
    check_slice(cfg)
    cfg.ice.whichEVP = 1
    check_slice(cfg)
    cfg.run.which_toy = "channel"
    check_slice(cfg)


def test_pi_subcommand_runs_on_the_cpu(path):
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "fesom2_tpu_torch.run", "pi", "--device",
         "cpu", "--steps", "2", "--mesh", path],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    assert "BENCHMARK RUNTIME" in res.stdout and "ice_area=" in res.stdout
