"""Three coupled CI steps of the port against the JAX package with what
the host side of forcing brings: the forcing and the initial state read
from files (``setup_pi_model(forcing_path=...)``,
``pi_initial_state(forcing_path=...)``) with the tidal potential and the
sea-level pressure term on, and the relaxation to climatology in a sponge
poleward of 60 degrees; on the level-3 globe with 12 layers (CPU, float64,
dense SSH, 8 subcycles): every ocean and ice field and the fluxes handed
to the ocean within 1e-9 of max|JAX|; the tidal potential within 1e-12 of
JAX's function run eagerly (jitted, XLA's own rounding of the ephemeris
moves it by about 1.1e-9 of max|ssh_gp|, so the jitted step's is held to
1e-8).  The files are the NCEP test-set
and WOA18 layouts of ``forcing/synthetic.py``, written on a 48 x 24 grid."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fesom2_tpu.model as jmodel
from fesom2_tpu.forcing import tides as jtides

from fesom2_tpu_torch import kernels
from fesom2_tpu_torch.convert import to_numpy
from fesom2_tpu_torch.forcing import synthetic, tides
from fesom2_tpu_torch.mesh import globe
from fesom2_tpu_torch.model import (pi_config, pi_coupled_step_fn,
                                    pi_initial_state, setup_pi_model)

from test_torch_coupled import (Pair, assert_coupled_close, assert_ice_alive,
                                coupled_pair, run_both)
from test_torch_kpp import assert_close


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    torch.set_num_threads(1)
    return globe.write_globe(str(tmp_path_factory.mktemp("globe")), level=3,
                             n_layers=12, dz_bottom=1000.0)


def test_three_steps_from_files_with_tides_and_mslp(path, tmp_path):
    forcing = synthetic.write_ncep_test_set(str(tmp_path), seed=11, nlon=48,
                                            nlat=24)
    synthetic.write_woa18(forcing, seed=11)
    cfg = pi_config()
    cfg.ice.evp_rheol_steps = 8
    cfg.run.use_global_tides = True
    cfg.run.l_mslp = True
    p = Pair()
    p.jm, p.jatm = jmodel.setup_pi_model(mesh_path=path, forcing_path=forcing,
                                         cfg=dataclasses.replace(cfg))
    p.js0, p.jice0 = jmodel.pi_initial_state(p.jm, forcing_path=forcing)
    p.tm, p.tatm = setup_pi_model(path, device="cpu", cfg=cfg,
                                  forcing_path=forcing)
    p.ts0, p.tice0 = pi_initial_state(p.tm, forcing_path=forcing)
    assert_close(p.ts0.tr, p.js0.tr, "tr", tol=0.0)
    kernels.reset_launches()
    jax_out, port_out = run_both(p, 3)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    assert_coupled_close(jax_out, port_out, tol=1e-9)
    # the last step's tidal potential: within 1e-12 of JAX's function run
    # eagerly; jitted, XLA rounds the ephemeris about 1.1e-9 of max|ssh_gp|
    # away from it (the counter since 2000 cancels in the sidereal angle)
    off = tides.foreph_offset(cfg.clock.yearnew, 1, cfg.dt)
    eager = jtides.tidal_potential(off + jnp.asarray(2.0) + 1.0, cfg.dt,
                                   p.jm.mesh.geo_coords[:, 0],
                                   p.jm.mesh.geo_coords[:, 1])
    assert_close(port_out[2].ssh_gp, eager, "ssh_gp", tol=1e-12)
    assert_close(port_out[2].ssh_gp, jax_out[2].ssh_gp, "ssh_gp jit",
                 tol=1e-8)
    assert float(port_out[2].ssh_gp.abs().max()) > 0.1
    assert float(port_out[2].press_air.abs().max()) == 0.0
    assert_ice_alive(port_out[1], p.tice0)


def test_three_steps_with_the_relaxation_sponge(path):
    cfg = pi_config()
    cfg.ice.evp_rheol_steps = 8
    cfg.tra.clim_relax = 1.0 / (10.0 * 86400.0)
    p = coupled_pair(path, cfg)
    tm, jm = p.tm, p.jm
    lat = tm.mesh.geo_coords[:, 1].abs()
    sponge = torch.where(lat > np.radians(60.0), cfg.tra.clim_relax, 0.0)
    nmask = tm.mesh.node_layer_mask
    # a climatology a degree warmer and 0.2 fresher than the start
    tclim = torch.where(nmask, p.ts0.tr[0] + 1.0, 0.0)
    sclim = torch.where(nmask, p.ts0.tr[1] - 0.2, 0.0)
    tm.Tclim, tm.Sclim, tm.relax2clim = tclim, sclim, sponge
    jm.Tclim, jm.Sclim, jm.relax2clim = (jnp.asarray(to_numpy(a))
                                         for a in (tclim, sclim, sponge))
    assert tm.climatology() is not None
    jax_out, port_out = run_both(p, 3)
    assert_coupled_close(jax_out, port_out, tol=1e-9)
    # the sponge moved T towards the climatology there, and only there
    tm.relax2clim = torch.zeros_like(sponge)
    free = p.ts0, p.tice0
    step = pi_coupled_step_fn(tm, p.tatm)
    for k in range(3):
        free = step(*free[:2], k)[:2]
    dT = port_out[0].tr[0] - free[0].tr[0]
    inside = (lat > np.radians(60.0))[None, :] & nmask
    assert float(dT[inside].min()) > 0.0
    assert float(dT[~inside].abs().max()) < float(dT[inside].max())
