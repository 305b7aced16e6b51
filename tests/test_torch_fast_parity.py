"""The fast configuration of ``bench.py`` (``BENCH_PARITY=fast``: linfs +
PP on full cells, no GM/Redi, with the ice) in the port against the JAX
package, on the level-3 globe with 12 layers (CPU, float64).

``pi_config`` equals the configuration JAX's ``setup_pi_model`` builds,
field for field, for both parities: JAX's ``_finish_pi_setup`` (which
reads the mesh and forcing files) is replaced inside the test by one that
returns the configuration it is handed.  Three coupled steps agree with
JAX's ``pi_coupled_step_fn`` to 1e-9 of each field's largest JAX
magnitude with the dense SSH solve (120 mEVP subcycles) and to 1e-8 with
CG forced (``DENSE_SSH_MAX_NODES = 0``, the static linfs ring; 8
subcycles).  Under linfs the freshwater flux is a virtual salt flux, so
the area-mean hbar stays at rounding level.  On the same globe, three CI
coupled steps with floating-ice loading (``use_floatice``: under zstar
the ice and snow mass press on the surface) agree with JAX's to 1e-9.
"""
import dataclasses

import numpy as np
import pytest
import torch

import fesom2_tpu.model as jmodel
from fesom2_tpu.core import ssh as jssh

import fesom2_tpu_torch.model as tmodel
from fesom2_tpu_torch.mesh import globe
from fesom2_tpu_torch.model import (check_slice, pi_config,
                                    pi_coupled_step_fn)

from test_torch_config import _plain
from test_torch_coupled import (FLUXES, ICE_FIELDS, assert_coupled_close,
                                assert_ice_alive, coupled_pair, run_both,
                                short_config)
from test_torch_kpp import assert_close

FIELDS = ("u", "v", "eta", "hbar", "d_eta", "tr", "tr_old", "w", "w_e",
          "Kv", "Av", "hnode", "helem", "zbar_3d", "Z_3d", "bvfreq",
          "mixlength", "pgf_x", "hpressure")


def jax_pi_config(monkeypatch, parity):
    """The configuration of JAX's ``setup_pi_model(parity=...)``."""
    monkeypatch.setattr(jmodel, "_finish_pi_setup",
                        lambda cfg, *args: cfg)
    return jmodel.setup_pi_model(parity=parity)


@pytest.mark.parametrize("parity", ["ci", "fast"])
def test_pi_config_equals_jax_field_for_field(monkeypatch, parity):
    got, ref = pi_config(parity), jax_pi_config(monkeypatch, parity)
    assert _plain(got) == _plain(ref)
    check_slice(got)


def test_fast_parity_is_linfs_pp_with_defaults_elsewhere():
    cfg, ci = pi_config("fast"), pi_config("ci")
    assert (cfg.ale.which_ALE, cfg.dyn.mix_scheme) == ("linfs", "PP")
    assert not (cfg.ale.use_partial_cell or cfg.dyn.Fer_GM or cfg.dyn.Redi)
    assert cfg.tra.K_hor == type(cfg.tra)().K_hor != ci.tra.K_hor
    assert cfg.run.use_ice and cfg.ice.evp_rheol_steps == 120
    with pytest.raises(ValueError, match="parity"):
        pi_config("bogus")


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    torch.set_num_threads(1)
    return globe.write_globe(str(tmp_path_factory.mktemp("globe")), level=3,
                             n_layers=12, dz_bottom=1000.0)


def assert_fast_close(jax_out, port_out, tol):
    (js, jice, jof), (ts, tice, tof) = jax_out, port_out
    for name in FIELDS:
        assert_close(getattr(ts, name), getattr(js, name), name, tol=tol)
    for name in ICE_FIELDS:
        assert_close(getattr(tice, name), getattr(jice, name), name, tol=tol)
    for name in FLUXES:
        assert_close(getattr(tof, name), getattr(jof, name), name, tol=tol)
    assert_close(tof.virtual_salt, jof.virtual_salt, "virtual_salt", tol=tol)


def test_three_fast_coupled_steps_match_jax_dense(path):
    p = coupled_pair(path, pi_config("fast"))
    assert p.tm.ssh_dense_inv is not None and p.tm.ice_sub is not None
    jax_out, port_out = run_both(p, 3)
    assert_fast_close(jax_out, port_out, tol=1e-9)
    assert_ice_alive(port_out[1], p.tice0)
    ts, tof = port_out[0], port_out[2]
    # linfs: the water flux goes in as virtual salt, the volume stays
    assert float(tof.virtual_salt.abs().max()) > 0.0
    a = p.tm.mesh.area[0]
    assert abs(float((ts.hbar * a).sum() / a.sum())) < 1e-12
    assert int(ts.step) == 3 and ts.fer_u.shape[-1] == 0


def test_three_fast_coupled_steps_match_jax_cg_forced(path):
    cfg = pi_config("fast")
    cfg.ice.evp_rheol_steps = 8
    p = coupled_pair(path, cfg, dense_limit=0)
    # JAX's CG takes the static linfs ring, as its _finish_pi_setup builds
    p.jm = dataclasses.replace(p.jm, ssh_ring=jssh.build_ssh_ring(
        p.jm.mesh, cfg))
    assert isinstance(p.tm.ssh_ring, tmodel.ssh.RingOperator)
    assert np.array_equal(p.tm.ssh_ring.cols.numpy(),
                          np.asarray(p.jm.ssh_ring.cols))
    jax_out, port_out = run_both(p, 3)
    assert p.tm.ssh_iters > 0
    assert_fast_close(jax_out, port_out, tol=1e-8)
    assert_ice_alive(port_out[1], p.tice0)


def test_three_ci_coupled_steps_with_floating_ice_match_jax(path):
    cfg = short_config()
    cfg.run.use_floatice = True
    p = coupled_pair(path, cfg)
    jax_out, port_out = run_both(p, 3)
    assert_coupled_close(jax_out, port_out, tol=1e-9)
    assert_ice_alive(port_out[1], p.tice0)
    # the load moves the surface: the port's steps without it differ
    cfg.run.use_floatice = False
    ts, tice = p.ts0, p.tice0
    tstep = pi_coupled_step_fn(p.tm, p.tatm)
    for k in range(3):
        ts, tice, _ = tstep(ts, tice, k)
    assert float((port_out[0].eta - ts.eta).abs().max()) > 1e-6
