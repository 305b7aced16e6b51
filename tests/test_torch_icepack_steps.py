"""Three coupled CI steps with Icepack (``cfg.run.use_icepack``) of the
port against the JAX package, on the level-3 globe with 12 layers (CPU,
float64, dense SSH): forcing update -> ocean2ice -> the Icepack step
(BL99 thermodynamics, frazil, lateral melt, the linear ITD remap, the
strength-coupled mEVP on the whole mesh, the FCT of the category-tracer
stack, ridging, cleanup, aggregation) -> fluxes -> the ocean step.

Both packages start from the same IcepackState: JAX's
``init_icepack_state`` of the initial ice (the port's own is held equal
to it), carried to the port by ``convert.icepack_state_from_numpy``.
Every field of the ocean state, the ice state, the IcepackState and the
fluxes handed to the ocean within 1e-9 of max|JAX|, in the default
IcepackConfig, with the aux tracers (CESM ponds, age, first-year area,
level ice) and with ``ice_ave_steps = 2``
(``test_torch_icepack_menu_steps.py`` holds the delta-Eddington
shortwave, the floe-size distribution and the skeletal-layer
biogeochemistry the same way).  No kernel is launched on the CPU path.
``run_pi(use_icepack=True)`` takes the same steps; ``check_slice`` lets
Icepack through.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fesom2_tpu.model as jmodel
from fesom2_tpu.ice.icepack import IcepackConfig as JIcepackConfig
from fesom2_tpu.ice.icepack import IcepackState as JIcepackState
from fesom2_tpu.ice.icepack import init_icepack_state as jinit_icepack

from fesom2_tpu_torch import kernels
from fesom2_tpu_torch.convert import (icepack_config_from,
                                      icepack_state_from_numpy, to_numpy)
from fesom2_tpu_torch.ice.icepack import IcepackConfig, init_icepack_state
from fesom2_tpu_torch.mesh import globe
from fesom2_tpu_torch.model import (check_slice, pi_config,
                                    pi_coupled_step_fn, pi_initial_state,
                                    setup_pi_model)
from fesom2_tpu_torch.run import run_pi

from test_torch_coupled import ICE_FIELDS, FLUXES, coupled_pair
from test_torch_ci_ocean import FIELDS
from test_torch_kpp import assert_close

IPK_FIELDS = [f.name for f in dataclasses.fields(JIcepackState)]

CASES = {
    "default": ({}, {}),
    "ponds_age_fy_lvl": (dict(tr_pond_cesm=True, tr_iage=True, tr_FY=True,
                              tr_lvl=True), {}),
    "ice_ave_steps_2": ({}, dict(ice_ave_steps=2)),
}


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    torch.set_num_threads(1)
    return globe.write_globe(str(tmp_path_factory.mktemp("globe")), level=3,
                             n_layers=12, dz_bottom=1000.0)


def icepack_cfg(opts, ice):
    cfg = pi_config()
    cfg.ice.evp_rheol_steps = 8
    for k, v in ice.items():
        setattr(cfg.ice, k, v)
    cfg.run.use_icepack = True
    cfg.icepack = IcepackConfig(**opts)
    return cfg


def icepack_pair(path, opts, ice):
    """``coupled_pair`` with Icepack on both sides: the JAX model gets its
    own config with the JAX package's IcepackConfig; both start from JAX's
    ``init_icepack_state`` of the initial ice, carried to the port by
    ``convert.icepack_state_from_numpy``."""
    cfg = icepack_cfg(opts, ice)
    p = coupled_pair(path, cfg)
    jcfg = copy.deepcopy(cfg)
    jcfg.icepack = JIcepackConfig(**opts)
    p.jm = dataclasses.replace(p.jm, cfg=jcfg)
    ji = p.jice0
    p.jipk0 = jinit_icepack(jcfg.icepack, ji.a_ice, ji.m_ice, ji.m_snow,
                            ji.t_skin)
    p.tipk0 = icepack_state_from_numpy(
        {f.name: None if getattr(p.jipk0, f.name) is None
         else np.asarray(getattr(p.jipk0, f.name))
         for f in dataclasses.fields(JIcepackState)}, "cpu")
    return p


def run_icepack_both(p, n_steps):
    jstep = jmodel.pi_coupled_step_fn(p.jm, p.jatm)
    tstep = pi_coupled_step_fn(p.tm, p.tatm)
    # committed to the device as the step's outputs are, so that the
    # second step reuses the first step's compile (uncommitted inputs key
    # a second one)
    dev = jax.devices()[0]
    js, jice, jipk = jax.device_put((p.js0, p.jice0, p.jipk0), dev)
    ts, tice, tipk = p.ts0, p.tice0, p.tipk0
    for k in range(n_steps):
        js, jice, jipk, jof = jstep(js, jice,
                                    jax.device_put(jnp.asarray(k), dev), jipk)
        ts, tice, tipk, tof = tstep(ts, tice, k, tipk)
    return (js, jice, jipk, jof), (ts, tice, tipk, tof)


def assert_icepack_close(jax_out, port_out, tol):
    (js, jice, jipk, jof), (ts, tice, tipk, tof) = jax_out, port_out
    for name in FIELDS:
        assert_close(getattr(ts, name), getattr(js, name), name, tol=tol)
    for name in ICE_FIELDS:
        assert_close(getattr(tice, name), getattr(jice, name), name, tol=tol)
    for name in IPK_FIELDS:
        want = getattr(jipk, name)
        if want is None:
            assert getattr(tipk, name) is None, name
            continue
        got = getattr(tipk, name)
        if want.size == 0:
            assert tuple(got.shape) == want.shape, name
            continue
        assert_close(got, want, f"ipk.{name}", tol=tol)
    for name in FLUXES:
        assert_close(getattr(tof, name), getattr(jof, name), name, tol=tol)


def test_init_icepack_state_matches_jax(path):
    opts = dict(tr_pond_cesm=True, tr_iage=True, tr_FY=True, tr_lvl=True,
                tr_fsd=True, tr_bgc=True)
    cfg = icepack_cfg(opts, {})
    tm, _ = setup_pi_model(path, device="cpu", cfg=cfg, atm_seed=4)
    _, ti = pi_initial_state(tm, seed=0)
    args = (ti.a_ice, ti.m_ice, ti.m_snow, ti.t_skin)
    for o in ({}, opts):
        got = init_icepack_state(IcepackConfig(**o), *args)
        want = jinit_icepack(JIcepackConfig(**o),
                             *(jnp.asarray(to_numpy(a)) for a in args))
        for name in IPK_FIELDS:
            w = getattr(want, name)
            if w is None:
                assert getattr(got, name) is None
            else:
                assert np.array_equal(to_numpy(getattr(got, name)),
                                      np.asarray(w)), name
    assert float(got.aicen.sum(0).max()) > 0.5


def check_three_steps(path, opts, ice):
    p = icepack_pair(path, opts, ice)
    kernels.reset_launches()
    n = 4 if ice.get("ice_ave_steps", 1) > 1 else 3
    jax_out, port_out = run_icepack_both(p, n)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    assert_icepack_close(jax_out, port_out, tol=1e-9)
    ts, tice, tipk, _ = port_out
    assert int(ts.step) == n
    # ice that is there, moves and changed
    assert float(tice.a_ice.max()) > 0.5
    assert float(tice.u_ice.abs().max()) > 1e-5
    assert float((tipk.vicen - p.tipk0.vicen).abs().max()) > 0.0
    assert bool((tipk.aicen >= 0).all()) and float(tipk.aicen.sum(0).max()) \
        <= 1.0 + 1e-12
    if IcepackConfig(**opts).has_aux:
        assert tipk.ta is not None and bool(torch.isfinite(tipk.ta).all())


@pytest.mark.parametrize("case", list(CASES))
def test_three_icepack_steps_match_jax(path, case):
    check_three_steps(path, *CASES[case])


def test_run_pi_with_icepack_takes_the_steps(path):
    cfg = icepack_cfg({}, {})
    tm, tatm = setup_pi_model(path, device="cpu", cfg=copy.deepcopy(cfg),
                              atm_seed=4)
    ts0, ti0 = pi_initial_state(tm, seed=0)
    ipk0 = init_icepack_state(cfg.icepack, ti0.a_ice, ti0.m_ice, ti0.m_snow,
                              ti0.t_skin)
    step = pi_coupled_step_fn(tm, tatm)
    ts, ti, ipk = ts0, ti0, ipk0
    for k in range(2):
        ts, ti, ipk, _ = step(ts, ti, k, ipk)
    # run_pi on a model without Icepack switches it on and starts from the
    # initial ice
    cfg2 = pi_config()
    cfg2.ice.evp_rheol_steps = 8
    tm2, tatm2 = setup_pi_model(path, device="cpu", cfg=cfg2, atm_seed=4)
    got = run_pi(tm2, tatm2, *pi_initial_state(tm2, seed=0), 2,
                 use_icepack=True)
    assert tm2.cfg.run.use_icepack and isinstance(tm2.cfg.icepack,
                                                 IcepackConfig)
    assert len(got) == 3
    for a, b in ((got[0].tr, ts.tr), (got[1].m_ice, ti.m_ice),
                 (got[2].vicen, ipk.vicen), (got[2].qin, ipk.qin)):
        assert torch.equal(a, b)
    # continuing from the returned ipk equals two more steps by hand
    more = run_pi(tm2, tatm2, got[0], got[1], 1, first_step=2,
                  use_icepack=True, ipk=got[2])
    ts, ti, ipk, _ = step(ts, ti, 2, ipk)
    assert torch.equal(more[2].aicen, ipk.aicen)


def test_check_slice_lets_icepack_through():
    for opts in ({}, dict(shortwave="dEdd", tr_pond_cesm=True, tr_fsd=True,
                          tr_bgc=True, conduct="MU71")):
        cfg = icepack_cfg(opts, {})
        check_slice(cfg)
    cfg = pi_config()
    cfg.run.use_icepack = True
    with pytest.raises(ValueError, match="IcepackConfig"):
        from fesom2_tpu_torch.model import coupled_step_impl

        class Stub:
            pass
        stub = Stub()
        stub.cfg = cfg
        coupled_step_impl(stub)


def test_icepack_config_from_the_jax_config():
    j = JIcepackConfig(tr_pond_cesm=True, tr_fsd=True, nfsd=8, ncat=4)
    t = icepack_config_from(j)
    assert t == IcepackConfig(tr_pond_cesm=True, tr_fsd=True, nfsd=8, ncat=4)
    assert np.array_equal(t.hin_max, j.hin_max)
    assert t.area_tracers == j.area_tracers
