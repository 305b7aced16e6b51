"""The port's soufflet step, end to end, against the JAX package's.

Both models are set up from the same code-built channel files (8 x 24
nodes, 10 layers) and step from the same initial state; after 3 steps
every prognostic field must agree to 1e-9 of its largest JAX magnitude
(float64, CPU).  The CPU path launches no kernel.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fesom2_tpu.model import setup_soufflet_model as jax_setup
from fesom2_tpu.core.state import zero_forcing as jax_zero_forcing

from fesom2_tpu_torch import kernels
from fesom2_tpu_torch.convert import state_from_numpy, to_numpy
from fesom2_tpu_torch.core.state import zero_forcing
from fesom2_tpu_torch.mesh.channel import channel_raw_mesh, write_mesh
from fesom2_tpu_torch.model import setup_soufflet_model, soufflet_config
from fesom2_tpu_torch.run import run_soufflet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("u", "v", "eta", "hbar", "d_eta", "tr", "tr_old", "w", "Kv", "Av")


@pytest.fixture(scope="module")
def mesh_dir(tmp_path_factory):
    torch.set_num_threads(1)
    return write_mesh(channel_raw_mesh(8, 24, 10, dz=400.0),
                      str(tmp_path_factory.mktemp("channel")))


@pytest.fixture(scope="module")
def models(mesh_dir):
    return jax_setup(mesh_path=mesh_dir), setup_soufflet_model(mesh_dir,
                                                               device="cpu")


def rel_err(port, ref):
    ref = np.asarray(ref)
    return float(np.abs(to_numpy(port) - ref).max()) \
        / max(float(np.abs(ref).max()), 1e-300)


def test_initial_state_matches_jax(models):
    jm, tm = models
    js, ts = jm.initial_state(), tm.initial_state()
    for f in dataclasses.fields(js):
        a = np.asarray(getattr(js, f.name))
        if a.size:
            assert rel_err(getattr(ts, f.name), a) <= 1e-13, f.name


def test_three_steps_match_jax(models):
    """Both steps start from the JAX initial state, carried over by
    ``convert.state_from_numpy``."""
    jm, tm = models
    js = jm.initial_state()
    ts = state_from_numpy({f.name: np.asarray(getattr(js, f.name))
                           for f in dataclasses.fields(js)}, "cpu")
    jstep, jf = jm.step_fn(), jax_zero_forcing(jm.mesh)
    tstep, tf = tm.step_fn(), zero_forcing(tm.mesh)
    kernels.reset_launches()
    for _ in range(3):
        js = jstep(js, jf)
        ts = tstep(ts, tf)
    for name in FIELDS:
        assert rel_err(getattr(ts, name), getattr(js, name)) <= 1e-9, name
    assert int(ts.step) == 3
    # the CPU path runs the plain versions only
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES


def test_run_soufflet_sane_and_conserving(models):
    """The driver's loop: finite, bounded fields and linfs volume
    conservation (the bounds of tests/test_soufflet.py)."""
    _, tm = models
    _, s, timers = run_soufflet(4, model=tm, verbose=False)
    assert timers.n_steps == 4
    for name in ("u", "v", "eta", "tr", "w", "hbar"):
        assert torch.isfinite(getattr(s, name)).all(), name
    assert float(s.u.abs().max()) < 3.0 and float(s.eta.abs().max()) < 2.0
    T = s.tr[0][tm.mesh.node_layer_mask]
    assert float(T.min()) > 0.0 and float(T.max()) < 26.0
    a = tm.mesh.area[0]
    assert abs(float((s.hbar * a).sum() / a.sum())) < 1e-6


def test_run_cli_on_cpu(mesh_dir):
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "fesom2_tpu_torch.run", "soufflet",
         "--device", "cpu", "--steps", "2", "--mesh", mesh_dir],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "BENCHMARK RUNTIME" in res.stdout


def test_cuda_requested_without_card_raises(mesh_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        setup_soufflet_model(mesh_dir, device="cuda")


@pytest.mark.parametrize("knob,value", [
    (("dyn", "mix_scheme"), "CVMIX_TKE"), (("tra", "tra_adv_hor"), "UPW1"),
    (("dyn", "i_vert_visc"), False), (("run", "use_global_tides"), True),
    (("tra", "tra_adv_ver"), "PPM"), (("run", "use_ice"), True),
    (("diag", "ldiag_DVD"), True), (("dyn", "SPP"), True)])
def test_out_of_slice_config_raises(mesh_dir, knob, value):
    """No knob is outside the port any more.  The knobs of queue 1 items
    15, 16, 17 and 19 (CVMix, the tracer schemes, explicit vertical
    viscosity, the salt plume, the tidal potential; sea ice on the channel
    with the channel's ``whichEVP=0``, standard EVP, which the channel's
    ocean step leaves off as the JAX package does) set up and step
    (``test_torch_menu_steps.py`` holds the menus against JAX).  The DVD
    diagnostic (item 20) is held against JAX here: 2 channel steps from
    the same state, the JAX step run without jit (its jitted XLA rounds
    the DVD's cancellation 1.6e-10 of max|dvd_h| away from itself);
    ``dvd_h`` and ``dvd_v`` within 1e-10 of their largest JAX magnitude,
    the prognostic fields within 1e-9."""
    cfg = soufflet_config()
    setattr(getattr(cfg, knob[0]), knob[1], value)
    m = setup_soufflet_model(mesh_dir, device="cpu", cfg=cfg)
    if knob[1] in PORTED_KNOBS:
        s = m(m.initial_state(), zero_forcing(m.mesh))
        assert bool(torch.isfinite(s.tr).all()) and int(s.step) == 1
        return
    assert knob[1] == "ldiag_DVD"
    jm = jax_setup(mesh_path=mesh_dir)
    jm.cfg.diag.ldiag_DVD = True
    js = jm.initial_state()
    assert js.dvd_h.shape[0] == 2
    ts = state_from_numpy({f.name: np.asarray(getattr(js, f.name))
                           for f in dataclasses.fields(js)}, "cpu")
    jstep, jf = jm.step_fn(jit=False), jax_zero_forcing(jm.mesh)
    for _ in range(2):
        js = jstep(js, jf)
        ts = m(ts, zero_forcing(m.mesh))
    for name in ("dvd_h", "dvd_v"):
        assert float(getattr(ts, name).abs().max()) > 0.0
        assert rel_err(getattr(ts, name), getattr(js, name)) <= 1e-10, name
    for name in FIELDS:
        assert rel_err(getattr(ts, name), getattr(js, name)) <= 1e-9, name


PORTED_KNOBS = ("mix_scheme", "tra_adv_hor", "i_vert_visc", "tra_adv_ver",
                "SPP", "use_global_tides", "use_ice")
