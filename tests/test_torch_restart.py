"""The port's restarts (``io/restart.py``), resume, blowup dump and mesh
description (``io/mesh_info.py``) against the JAX package's, on the CPU.

On the level-3 globe with 12 layers: the port's state, ice and an
Icepack state with aux tracers (ponds, age, first-year and level ice)
written and read back bit for bit; the port's file read by the JAX
package's ``read_restart`` and the JAX package's file by the port's,
field for field, bit for bit; the ALE geometry both rebuild on read
(``helem``, ``zbar_3d``, ``Z_3d``) equal; a ``run.run_pi`` of 2 coupled
steps and a resume from its restart for 2 more equal to 4 unbroken steps,
bit for bit (8 mEVP subcycles); a state with a NaN raises, naming the
bad step, and leaves ``blowup.nc``; ``fesom.mesh.diag.nc`` equal to the
JAX package's file; the CLI's ``--result``, ``--restart-every``,
``--resume``, ``--version`` and ``--info``.
"""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fesom2_tpu.core.state import allocate_state as jallocate_state
from fesom2_tpu.core.state import init_thickness_linfs as jinit_thickness
from fesom2_tpu.ice.icepack.state import IcepackConfig as JIcepackConfig
from fesom2_tpu.ice.icepack.state import IcepackState as JIcepackState
from fesom2_tpu.ice.icepack.state import \
    init_icepack_state as jinit_icepack_state
from fesom2_tpu.ice.state import allocate_ice as jallocate_ice
from fesom2_tpu.io import restart as jrestart
from fesom2_tpu.io.mesh_info import write_mesh_info as jwrite_mesh_info
from fesom2_tpu.io.netcdf import list_vars

from fesom2_tpu_torch.convert import to_numpy
from fesom2_tpu_torch.core.state import (OceanState, allocate_state,
                                         init_thickness_linfs)
from fesom2_tpu_torch.ice.icepack import IcepackConfig, init_icepack_state
from fesom2_tpu_torch.ice.state import IceState, allocate_ice
from fesom2_tpu_torch.io import restart
from fesom2_tpu_torch.io.mesh_info import write_mesh_info
from fesom2_tpu_torch.io.netcdf import read_vars
from fesom2_tpu_torch.model import pi_config, pi_initial_state
from fesom2_tpu_torch.run import run_pi

from test_torch_diagnostics import globe_run, path  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUX = dict(tr_pond_cesm=True, tr_iage=True, tr_FY=True, tr_lvl=True)


def short_config():
    cfg = pi_config()
    cfg.ice.evp_rheol_steps = 8
    return cfg


@pytest.fixture(scope="module")
def run(path):  # noqa: F811
    return globe_run(path, short_config())


@pytest.fixture(scope="module")
def ipk(run):
    """An Icepack state with every aux stack, its values seeded."""
    ipc = IcepackConfig(**AUX)
    p = init_icepack_state(ipc, run.tice.a_ice, run.tice.m_ice,
                           run.tice.m_snow, run.tice.t_skin)
    rng = np.random.default_rng(16)
    seeded = lambda x: x + torch.as_tensor(rng.uniform(0.0, 0.1, x.shape))
    p = dataclasses.replace(p, ta=seeded(p.ta), tv=seeded(p.tv))
    assert p.ta.shape[1] > 0 and p.tv.shape[1] > 0
    return p


def templates(mesh, cfg, ipk=None):
    """Freshly allocated (state, ice, ipk) to read a restart into."""
    s = init_thickness_linfs(allocate_state(mesh, cfg.tra.num_tracers,
                                            with_gm=cfg.dyn.Fer_GM), mesh)
    t = None
    if ipk is not None:
        z = torch.zeros(mesh.n_nodes, dtype=torch.float64)
        t = init_icepack_state(IcepackConfig(**AUX), z, z, z, z)
    return s, allocate_ice(mesh), t


def jax_templates(r, cfg):
    js = jinit_thickness(jallocate_state(r.jmesh, cfg.tra.num_tracers,
                                         jnp.float64,
                                         with_gm=cfg.dyn.Fer_GM), r.jmesh)
    z = jnp.zeros(r.jmesh.n_nodes)
    return js, jallocate_ice(r.jmesh), jinit_icepack_state(
        JIcepackConfig(**AUX), z, z, z, z)


def to_jax_ipk(p):
    return JIcepackState(**{f.name: jnp.asarray(to_numpy(getattr(p, f.name)))
                            for f in dataclasses.fields(JIcepackState)})


def assert_fields_equal(got, want, names):
    for f in names:
        a, b = to_numpy(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.shape == b.shape and a.dtype == b.dtype, f
        assert np.array_equal(a, b), f


def test_restart_reads_back_bitwise(run, ipk, tmp_path):
    r = run
    path = str(tmp_path / "restart.nc")
    restart.write_restart(path, r.ts, r.tice, 2, ipk=ipk)
    s0, i0, p0 = templates(r.mesh, r.cfg, ipk)
    s, i, p = restart.read_restart(path, s0, i0, ipk=p0)
    assert_fields_equal(s, r.ts, restart.OCE_FIELDS + ["step"])
    assert_fields_equal(i, r.tice, restart.ICE_FIELDS)
    assert_fields_equal(p, ipk, restart.IPK_FIELDS + list(restart.IPK_AUX))
    assert int(s.step) == 2 and s.step.dtype == torch.int32
    assert {"ipk_ta", "ipk_tv", "ice_alpha_aevp"} <= set(list_vars(path))
    # the ALE geometry rebuilt from hnode equals the step's own
    s, _ = restart.read_restart(path, s0, i0, mesh=r.mesh, cfg=r.cfg)
    for f in ("helem", "zbar_3d", "Z_3d"):
        assert torch.equal(getattr(s, f), getattr(r.ts, f)), f
    # the ocean alone; float32
    s, i = restart.read_restart(path, s0, None, dtype=torch.float32)
    assert i is None and s.tr.dtype == torch.float32
    assert torch.equal(s.tr, r.ts.tr.float())


def test_files_cross_between_the_packages(run, ipk, tmp_path):
    """The port's file read by JAX's read_restart, JAX's file by the
    port's: every field equal, bit for bit."""
    r = run
    ours, theirs = str(tmp_path / "port.nc"), str(tmp_path / "jax.nc")
    restart.write_restart(ours, r.ts, r.tice, 2, ipk=ipk)
    js0, ji0, jp0 = jax_templates(r, r.cfg)
    js, ji, jp = jrestart.read_restart(ours, js0, ji0, dtype=jnp.float64,
                                       ipk=jp0)
    names = restart.OCE_FIELDS + ["step"]
    for f in names:
        assert np.array_equal(np.asarray(getattr(js, f)),
                              to_numpy(getattr(r.ts, f))), f
    for f in restart.ICE_FIELDS:
        assert np.array_equal(np.asarray(getattr(ji, f)),
                              to_numpy(getattr(r.tice, f))), f
    for f in restart.IPK_FIELDS + list(restart.IPK_AUX):
        assert np.array_equal(np.asarray(getattr(jp, f)),
                              to_numpy(getattr(ipk, f))), f
    jrestart.write_restart(theirs, r.js, r.jice, 2, ipk=to_jax_ipk(ipk))
    s0, i0, p0 = templates(r.mesh, r.cfg, ipk)
    s, i, p = restart.read_restart(theirs, s0, i0, ipk=p0)
    assert_fields_equal(s, r.ts, names)
    assert_fields_equal(i, r.tice, restart.ICE_FIELDS)
    assert_fields_equal(p, ipk, restart.IPK_FIELDS + list(restart.IPK_AUX))
    assert restart.OCE_FIELDS == jrestart.OCE_FIELDS
    assert restart.ICE_FIELDS == jrestart.ICE_FIELDS
    assert restart.IPK_FIELDS == jrestart.IPK_FIELDS


def test_rebuilt_geometry_matches_jax(run, tmp_path):
    r = run
    path = str(tmp_path / "restart.nc")
    restart.write_restart(path, r.ts, r.tice)
    js0, ji0, _ = jax_templates(r, r.cfg)
    js, _ = jrestart.read_restart(path, js0, ji0, dtype=jnp.float64,
                                  mesh=r.jmesh, cfg=r.cfg)
    s, _ = restart.read_restart(path, *templates(r.mesh, r.cfg)[:2],
                                mesh=r.mesh, cfg=r.cfg)
    for f in ("helem", "zbar_3d", "Z_3d"):
        a, b = to_numpy(getattr(s, f)), np.asarray(getattr(js, f))
        assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max(), f
    assert r.cfg.ale.which_ALE == "zstar"


def test_resume_equals_unbroken_run(run, tmp_path):
    """2 steps with a restart, then a resume to step 4, against 4 steps
    in one run: every field of the state and the ice, bit for bit."""
    r = run
    once, twice = str(tmp_path / "once"), str(tmp_path / "twice")
    s0, i0 = pi_initial_state(r.tm)
    s4, i4 = run_pi(r.tm, r.tatm, s0, i0, 4, result_path=once)
    run_pi(r.tm, r.tatm, s0, i0, 2, result_path=twice, restart_every=2)
    assert os.path.exists(os.path.join(twice, "restart.nc"))
    assert open(os.path.join(twice, "fesom.clock")).read().split()[:2] \
        == ["1800.0", "1"]
    sr, ir = run_pi(r.tm, r.tatm, *pi_initial_state(r.tm), 4,
                    result_path=twice, resume=True)
    assert int(sr.step) == 4
    for f in dataclasses.fields(OceanState):
        assert torch.equal(getattr(sr, f.name), getattr(s4, f.name)), f.name
    for f in dataclasses.fields(IceState):
        assert torch.equal(getattr(ir, f.name), getattr(i4, f.name)), f.name
    for d in (once, twice):
        assert os.path.exists(os.path.join(d, "fesom.mesh.diag.nc"))


def test_blowup_raises_names_the_step_and_dumps(run, tmp_path):
    r = run
    s0, i0 = pi_initial_state(r.tm)
    eta = s0.eta.clone()
    eta[11] = float("nan")
    d = str(tmp_path / "blown")
    with pytest.raises(RuntimeError, match=r"blowup detected at step 1 "
                       r"\(read at step 2\): \|eta\| > 10 or not "
                       r"finite at \d+ points"):
        run_pi(r.tm, r.tatm, dataclasses.replace(s0, eta=eta), i0, 2,
               result_path=d)
    dump = read_vars(os.path.join(d, "blowup.nc"), ["eta", "step"])
    assert int(dump["step"][0]) == 2 and np.isnan(dump["eta"]).any()
    # a sane run reads the flag and goes on
    run_pi(r.tm, r.tatm, s0, i0, 1, logfile_outfreq=1)


def test_mesh_info_matches_jax(run, tmp_path):
    r = run
    ours = write_mesh_info(str(tmp_path / "port"), r.mesh)
    theirs = jwrite_mesh_info(str(tmp_path / "jax"), r.jmesh)
    assert os.path.basename(ours) == "fesom.mesh.diag.nc"
    names = list_vars(theirs)
    assert sorted(list_vars(ours)) == sorted(names)
    a, b = read_vars(ours, names), read_vars(theirs, names)
    for n in names:
        assert a[n].dtype == b[n].dtype and a[n].shape == b[n].shape, n
        if np.issubdtype(b[n].dtype, np.integer):
            assert np.array_equal(a[n], b[n]), n
        else:
            assert np.abs(a[n] - b[n]).max() <= 1e-12 * max(
                np.abs(b[n]).max(), 1e-300), n
    part = np.arange(r.mesh.n_nodes) % 3
    p = read_vars(write_mesh_info(str(tmp_path / "p.nc"), r.mesh,
                                  nod_part=part), ["nod_part"])
    assert np.array_equal(p["nod_part"], part)


def test_cli_restart_resume_version_info(path, tmp_path):  # noqa: F811
    env = dict(os.environ, PYTHONPATH=REPO)
    res = str(tmp_path / "result")
    base = [sys.executable, "-m", "fesom2_tpu_torch.run"]
    pi = base + ["pi", "--device", "cpu", "--level", "3", "--mesh", path,
                 "--result", res]
    for extra in (["--steps", "2", "--restart-every", "2"],
                  ["--steps", "3", "--resume"]):
        out = subprocess.run(pi + extra, cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        assert "runtime output [s]" in out.stdout
    assert "resumed from" in out.stdout and "steps               : 1" \
        in out.stdout
    assert {"restart.nc", "fesom.clock", "fesom.mesh.diag.nc"} <= set(
        os.listdir(res))
    out = subprocess.run(base + ["--version"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip()
    out = subprocess.run(base + ["--info"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "torch: " in out.stdout
    assert "jax" not in out.stdout
