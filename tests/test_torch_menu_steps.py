"""Three whole steps of the code-built zstar channel (8 x 24 nodes, 10
layers of 400 m, 0 to 18 degrees north) in the port against the JAX
package's jitted step, for each menu that this slice ports (CPU,
float64, dense SSH solve, within 1e-9 of each field's largest JAX
magnitude):

* the tracer schemes: UPW1 horizontal, CDIFF, PPM and UPW1 vertical under
  FCT; no limiter with MUSCL/QR4C, with the w split (its w_i then joins
  the implicit vertical diffusion) and with UPW1/UPW1;
* explicit vertical viscosity and diffusion (``i_vert_visc`` and
  ``i_vert_diff`` off: the JAX step skips the implicit solves);
* the salt plume with six tracers (T, S, the rain tracer 101 and the
  strait tracers 301-303) under a forcing with growing ice and rain;
* a toy channel of another name than soufflet: the JAX package runs it
  without the soufflet relaxation and beta-plane Coriolis, from a state
  at rest with zero tracers, and so does the port;
* sea ice on the toy channel: the JAX package's ocean step ignores
  ``use_ice``, and its ``coupled_step_fn`` runs the ice on any model (on
  the whole mesh, with no subdomain); two coupled steps with given
  forcings, against ``fesom2_tpu.model.coupled_step_fn``.

The forcing has wind stress (TKE and KPP need it), heat and water fluxes,
growing ice (``thdgr > 0``) and rain.  ``test_torch_cvmix_steps.py`` runs
the mixing schemes the same way.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fesom2_tpu.model as jmodel
from fesom2_tpu.core.state import zero_forcing as jax_zero_forcing
from fesom2_tpu.ice.state import IceState as JIceState, \
    IceForcing as JIceForcing

from fesom2_tpu_torch.convert import to_numpy
from fesom2_tpu_torch.core.state import zero_forcing
from fesom2_tpu_torch.ice.state import allocate_ice, zero_ice_forcing
from fesom2_tpu_torch.mesh.channel import channel_raw_mesh, write_mesh
from fesom2_tpu_torch.model import coupled_step_fn

from test_torch_dyn_menus import channel_cfg, channel_pair
from test_torch_zstar import FIELDS, _to_port, assert_close

TOL = 1e-9
STEP_FIELDS = FIELDS + ("Kv_s", "tke", "iwe", "iwe_diss", "kpp_nonloc")


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    torch.set_num_threads(1)
    return write_mesh(channel_raw_mesh(8, 24, 10, dz=400.0),
                      str(tmp_path_factory.mktemp("channel")))


def forcing_arrays(mesh, seed=3):
    """Seeded surface forcing as numpy: stress on elements, fluxes on
    nodes, growing ice and rain."""
    rng = np.random.default_rng(seed)
    N, E = mesh.n_nodes, mesh.n_elems
    sx = 0.1 + 0.02 * rng.standard_normal(E)
    return dict(stress_x=sx, stress_y=0.02 * rng.standard_normal(E),
                stress_atm_x=np.full(N, 0.1), stress_atm_y=np.zeros(N),
                heat_flux=50.0 + 10.0 * rng.standard_normal(N),
                water_flux=1e-8 * rng.standard_normal(N),
                thdgr=np.abs(2e-7 * rng.standard_normal(N)),
                prec_rain=np.full(N, 3e-8))


def steps_match_jax(path, tcfg, n_steps=3, names=STEP_FIELDS):
    p = channel_pair(path, tcfg)
    fx = forcing_arrays(p.tm.mesh)
    jf = dataclasses.replace(jax_zero_forcing(p.jm.mesh),
                             **{k: jnp.asarray(v) for k, v in fx.items()})
    tf = dataclasses.replace(zero_forcing(p.tm.mesh),
                             **{k: torch.tensor(v) for k, v in fx.items()})
    js, tstate = p.jm.initial_state(), p.tm.initial_state()
    ts = _to_port(js)
    assert torch.equal(ts.tr, tstate.tr) and torch.equal(ts.u, tstate.u)
    jstep, tstep = p.jm.step_fn(), p.tm.step_fn()
    for _ in range(n_steps):
        js = jstep(js, jf)
        ts = tstep(ts, tf)
    for name in names:
        assert_close(getattr(ts, name), getattr(js, name), name, tol=TOL)
    assert bool(torch.isfinite(ts.tr).all())
    return p, ts


def menu_cfg(**knobs):
    tcfg = channel_cfg("zstar")
    for k, v in knobs.items():
        for group in (tcfg.dyn, tcfg.tra, tcfg.run):
            if hasattr(group, k):
                setattr(group, k, v)
                break
        else:
            raise AttributeError(k)
    return tcfg


MENUS = {
    "upw1_fct": dict(tra_adv_hor="UPW1"),
    "cdiff_fct": dict(tra_adv_ver="CDIFF"),
    "ppm_fct": dict(tra_adv_ver="PPM"),
    "upw1_ver_fct": dict(tra_adv_ver="UPW1"),
    "no_limiter": dict(tra_adv_lim="NONE"),
    "no_limiter_w_split": dict(tra_adv_lim="NONE", w_split=True,
                               w_max_cfl=1e-5),
    "no_limiter_upw1_upw1": dict(tra_adv_lim="NONE", tra_adv_hor="UPW1",
                                 tra_adv_ver="UPW1"),
    "explicit_vertical": dict(i_vert_visc=False, i_vert_diff=False),
    "salt_plume_six_tracers": dict(SPP=True, num_tracers=6,
                                   tracer_ID=[0, 1, 101, 301, 302, 303]),
}


@pytest.mark.parametrize("menu", list(MENUS))
def test_three_channel_steps_match_jax(path, menu):
    knobs = MENUS[menu]
    p, ts = steps_match_jax(path, menu_cfg(**knobs))
    if menu == "no_limiter_w_split":
        assert float(ts.w_i.abs().max()) > 0.0
    if menu == "salt_plume_six_tracers":
        assert float(ts.tr[2].sum()) > 0.0        # rain water came in
        assert float(ts.tr[3:].abs().max()) == 0.0  # no region, no source


def test_a_toy_channel_of_another_name(path):
    """No soufflet physics: the state at rest with zero tracers (the
    salinity clamp lifts S to 3 psu), the mesh's own Coriolis."""
    tcfg = menu_cfg()
    tcfg.run.which_toy = "channel"
    p, ts = steps_match_jax(path, tcfg)
    assert not p.tm.is_soufflet
    nmask = p.tm.mesh.node_layer_mask
    assert float(ts.tr[1][nmask].min()) == 3.0


def test_sea_ice_on_the_toy_channel(path):
    tcfg = menu_cfg()
    tcfg.run.use_ice = True
    tcfg.ice.whichEVP = 1
    tcfg.ice.evp_rheol_steps = 8
    p = channel_pair(path, tcfg)
    assert p.tm.ice_sub is None
    mesh = p.tm.mesh
    N = mesh.n_nodes
    ice = allocate_ice(mesh, torch.float64)
    full = lambda v: torch.full((N,), v, dtype=torch.float64)
    ice = dataclasses.replace(ice, a_ice=full(0.8), m_ice=full(1.5),
                              m_snow=full(0.2))
    fx = forcing_arrays(mesh)
    iforc = dataclasses.replace(
        zero_ice_forcing(mesh), Tair=full(-5.0), shortwave=full(100.0),
        longwave=full(250.0), shum=full(2e-3), u_wind=full(8.0),
        stress_atmice_x=full(0.1), stress_atmoce_x=full(0.1))
    tf = dataclasses.replace(zero_forcing(mesh), **{
        k: torch.tensor(fx[k]) for k in ("stress_x", "stress_y")})
    jf = dataclasses.replace(jax_zero_forcing(p.jm.mesh), **{
        k: jnp.asarray(fx[k]) for k in ("stress_x", "stress_y")})
    jice = JIceState(**{k: jnp.asarray(v) for k, v in to_numpy(ice).items()})
    jiforc = JIceForcing(**{k: jnp.asarray(v)
                            for k, v in to_numpy(iforc).items()})
    js = p.jm.initial_state()
    ts = _to_port(js)
    jstep = jmodel.coupled_step_fn(p.jm)
    tstep = coupled_step_fn(p.tm)
    for _ in range(2):
        js, jice, jof = jstep(js, jice, jf, jiforc)
        ts, ice, tof = tstep(ts, ice, tf, iforc)
    for name in FIELDS:
        assert_close(getattr(ts, name), getattr(js, name), name, tol=TOL)
    for name in ("a_ice", "m_ice", "m_snow", "u_ice", "v_ice"):
        assert_close(getattr(ice, name), getattr(jice, name), name, tol=TOL)
    for name in ("heat_flux", "water_flux", "stress_x"):
        assert_close(getattr(tof, name), getattr(jof, name), name, tol=TOL)
    assert float(ice.u_ice.abs().max()) > 0.0
    assert float(ice.a_ice.max()) > 0.0
