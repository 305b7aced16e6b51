"""The port's post-processing (``fesom2_tpu_torch/post``) against the JAX
package's ``fesom2_tpu/post`` on one run directory the port writes:
3 CI coupled steps of ``run.run_pi`` on the level-3 globe (501 nodes, 47
layers) with the density-space MOC on, a record every step of the default
ocean streams and ``std_dens_VDZ``, and ``fesom.mesh.diag.nc`` (CPU,
float64).

- ``load_mesh`` from the run directory and from the raw mesh directory,
  ``read_stream``, ``cut_region``, ``ind_for_depth``, ``fesom2regular``
  (nn and idist), ``fesom3d_to_regular``, ``moc_z``, ``moc_dens``, the
  WOA comparison ``fesom2clim`` on the file ``forcing/synthetic.py``
  writes, and every FPost product function: bitwise, or within 1e-12 of
  max|JAX|;
- JAX's ``run_fpost`` raises on this 47-level stream (it unpacks the
  time mean as records and times); the port's writes the products that
  JAX's product functions give on all records, and its ``moc.nc`` holds
  ``moc_z``'s [lat, nz] array;
- the plots run under Agg;
- ``write_goldens``/``load_goldens``/``fcheck`` round trip against JAX's,
  and the two CLIs.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fesom2_tpu.post import (climatology as jclim, fcheck as jfcheck,
                             fpost as jfpost, mesh_loader as jml,
                             moc as jmoc, regrid as jregrid)

from fesom2_tpu_torch.forcing import synthetic
from fesom2_tpu_torch.io import streams as streams_io
from fesom2_tpu_torch.io.netcdf import read_vars
from fesom2_tpu_torch.mesh import globe
from fesom2_tpu_torch.model import (pi_config, pi_initial_state,
                                    setup_pi_model)
from fesom2_tpu_torch.post import (climatology, fcheck, fpost, mesh_loader,
                                   moc, plot, regrid)
from fesom2_tpu_torch.run import run_pi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-12
N_STEPS = 3


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(mesh dir, result dir) of 3 port steps with the streams."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("post")
    mesh_dir = globe.write_globe(str(root / "mesh"), level=3)
    cfg = pi_config()
    cfg.ice.evp_rheol_steps = 8
    cfg.diag.ldiag_dMOC = True
    m, atm = setup_pi_model(mesh_dir, device="cpu", cfg=cfg)
    defs = streams_io.default_ocean_streams(m.mesh) \
        + [streams_io.make_stream("std_dens_VDZ", m.mesh, m.cfg)]
    for d in defs:
        d.unit, d.freq = "s", 1
    out = str(root / "run")
    run_pi(m, atm, *pi_initial_state(m), N_STEPS, result_path=out,
           stream_defs=defs)
    return mesh_dir, out


@pytest.fixture(scope="module")
def meshes(run):
    _, out = run
    return jml.load_mesh(out), mesh_loader.load_mesh(out)


def _same(got, want, tol=0.0, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if tol == 0.0:
        assert np.array_equal(got, want, equal_nan=True), what
    else:
        assert np.array_equal(np.isnan(got), np.isnan(want)), what
        ok = ~np.isnan(want)
        err = np.abs(got[ok] - want[ok]).max() / max(
            np.abs(want[ok]).max(), 1e-300)
        assert err <= tol, (what, err)


def _same_mesh(a, b):
    for f in ("x2", "y2", "elem", "zlev", "zmid", "nlevels_nod2D",
              "nlevels_elem", "area", "elem_area"):
        _same(getattr(a, f), getattr(b, f), what=f)
    assert (a.n2d, a.e2d) == (b.n2d, b.e2d)


def test_load_mesh_equals_jax(run, meshes):
    mesh_dir, out = run
    jm, tm = meshes
    _same_mesh(tm, jm)
    _same_mesh(mesh_loader.load_mesh(os.path.join(out, "fesom.mesh.diag.nc")),
               jm)
    # the raw directory: the port's build_mesh against JAX's
    _same_mesh(mesh_loader.load_mesh(mesh_dir), jml.load_mesh(mesh_dir))
    assert tm.n2d == 501 and len(tm.zlev) == 48


def test_read_stream_and_selection_equal_jax(run, meshes):
    _, out = run
    jm, tm = meshes
    for rec in ("mean", "all", 1, slice(0, 2), [0, 2], None):
        for how in ("mean", "max", "min"):
            _same(mesh_loader.read_stream(out, "temp", 1948, records=rec,
                                          how=how),
                  jml.read_stream(out, "temp", 1948, records=rec, how=how),
                  what=f"{rec} {how}")
    assert mesh_loader.read_stream(out, "temp", 1948, records="all"
                                   ).shape == (N_STEPS, 47, 501)
    for box in ((13, 30, 53, 66), (-180, 180, -90, 0)):
        _same(mesh_loader.cut_region(tm, box), jml.cut_region(jm, box))
    for depth in (0.0, 100.0, 2500.0, 1e5):
        assert mesh_loader.ind_for_depth(depth, tm) \
            == jml.ind_for_depth(depth, jm)


def test_regrid_equals_jax(run, meshes):
    _, out = run
    jm, tm = meshes
    sst = mesh_loader.read_stream(out, "sst", 1948)
    lons, lats = regrid.regular_grid(72, 36)
    jl, jt = jregrid.regular_grid(72, 36)
    _same(lons, jl), _same(lats, jt)
    _same(regrid.lon_lat_to_cartesian(lons, lats),
          jregrid.lon_lat_to_cartesian(lons, lats))
    for how, radius in (("nn", 1e5), ("nn", 1e6), ("idist", 5e5)):
        _same(regrid.fesom2regular(sst, tm, lons, lats, how=how,
                                   radius_of_influence=radius),
              jregrid.fesom2regular(sst, jm, lons, lats, how=how,
                                    radius_of_influence=radius),
              tol=TOL, what=how)
    T = mesh_loader.read_stream(out, "temp", 1948)
    for how in ("nn", "idist"):
        _same(regrid.fesom3d_to_regular(T, tm, lons, lats, levels=[0, 5, 30],
                                        how=how, radius_of_influence=5e5),
              jregrid.fesom3d_to_regular(T, jm, lons, lats, levels=[0, 5, 30],
                                         how=how, radius_of_influence=5e5),
              tol=TOL, what=how)


def test_moc_equals_jax(run, meshes):
    _, out = run
    jm, tm = meshes
    w = mesh_loader.read_stream(out, "w", 1948)
    for bins in (None, np.arange(-80.0, 81.0, 4.0)):
        for got, want in zip(moc.moc_z(w, tm.area, tm.y2, lat_bins=bins),
                             jmoc.moc_z(w, jm.area, jm.y2, lat_bins=bins)):
            _same(got, want, tol=TOL)
    vdz = mesh_loader.read_stream(out, "std_dens_VDZ", 1948)
    assert vdz.shape[-1] == tm.e2d and np.abs(vdz).max() > 0
    lat_e = tm.y2[tm.elem].mean(-1)
    from fesom2_tpu_torch.core.diagnostics import STD_DENS
    got = moc.moc_dens(vdz, tm.elem_area, lat_e, STD_DENS)
    want = jmoc.moc_dens(vdz, jm.elem_area, lat_e, STD_DENS)
    for a, b in zip(got, want):
        _same(a, b, tol=TOL)
    assert np.isfinite(got[2]).all()


def test_climatology_equals_jax(run, meshes, tmp_path):
    _, out = run
    jm, tm = meshes
    path = synthetic.write_woa18(str(tmp_path), seed=2)
    c, jc = climatology.Climatology(path), jclim.Climatology(path)
    for f in ("T", "S", "x", "y", "z"):
        _same(getattr(c, f), getattr(jc, f), what=f)
    assert np.isnan(c.T).any()
    T = mesh_loader.read_stream(out, "temp", 1948)
    for field in ("T", "S"):
        for a, b in zip(climatology.fesom2clim(T, tm, c, field=field),
                        jclim.fesom2clim(T, jm, jc, field=field)):
            _same(a, b, tol=TOL, what=field)


@pytest.fixture(scope="module")
def fcfg():
    cfg = fpost.FpostConfig(RegDx=6.0, RegDy=6.0)
    jcfg = jfpost.FpostConfig(RegDx=6.0, RegDy=6.0)
    return cfg, jcfg


def test_fpost_products_equal_jax(run, meshes, fcfg):
    _, out = run
    jm, tm = meshes
    cfg, jcfg = fcfg
    gi, jgi = fpost.make_grid_info(tm, cfg), jfpost.make_grid_info(jm, jcfg)
    assert set(gi) == set(jgi)
    for k in gi:
        _same(gi[k], jgi[k], what=k)
    assert gi["mask2"].sum() > 0
    recs = {n: fpost.read_records(out, n, 1948)[0]
            for n in ("temp", "salt", "u", "v", "w")}
    got = fpost.do_ts3(tm, cfg, recs["temp"], recs["salt"])
    want = jfpost.do_ts3(jm, jcfg, recs["temp"], recs["salt"])
    for k in ("temp", "salt"):
        _same(got[k], want[k], what=k)
    assert got["temp"].shape == (N_STEPS, 47, 28, 60)
    _same(fpost.elem_to_node_volume_mean(recs["u"], tm),
          jfpost.elem_to_node_volume_mean(recs["u"], jm), tol=TOL)
    _same(fpost.do_uv_norm(tm, cfg, recs["u"], recs["v"]),
          jfpost.do_uv_norm(jm, jcfg, recs["u"], recs["v"]), tol=TOL)
    curl = np.random.default_rng(3).normal(size=(2, 47, tm.n2d))
    _same(fpost.do_uv_curl(tm, cfg, curl), jfpost.do_uv_curl(jm, jcfg, curl))
    wm = recs["w"].mean(0)
    for a, b in zip(fpost.do_moc(tm, cfg, wm), jfpost.do_moc(jm, jcfg, wm)):
        _same(a, b, tol=TOL)


def test_parse_interp_namelist_equals_jax(tmp_path):
    p = tmp_path / "namelist.interp"
    p.write_text("&config\nrunid='fesom'\ndatapath='/d/r'\nyear_start=1948\n"
                 "year_end=1949, ! two years\n/\n&todo\ndo_TS3=.true.\n"
                 "do_UVnorm=.false.\ndo_MOC=.true.\ndo_mesh=.true.\n/\n"
                 "&regular_mesh\nLonMin=-100.\nRegDx=0.5\nRegDy=0.25\n/\n")
    got = fpost.parse_interp_namelist(str(p))
    want = jfpost.parse_interp_namelist(str(p))
    assert got.__dict__ == want.__dict__
    assert got.year_end == 1949 and got.do_MOC and got.LonMin == -100.0


def test_run_fpost_repairs_jax_unpacking(run, meshes, fcfg, tmp_path):
    """JAX's run_fpost unpacks read_stream's time mean [47, N] as
    (records, times) and raises; the port's reads every record and the
    time axis, and writes the products of JAX's functions on them."""
    _, out = run
    jm, tm = meshes
    cfg, jcfg = fcfg
    for c in (cfg, jcfg):
        c.datapath, c.do_TS3 = out, True
    jcfg.outpath = str(tmp_path / "jax")
    with pytest.raises(ValueError, match="too many values to unpack"):
        jfpost.run_fpost(jcfg, mesh=jm)
    cfg.outpath = str(tmp_path / "port")
    cfg.do_grid_info = cfg.do_UVnorm = cfg.do_MOC = cfg.do_UVcurl = True
    written = fpost.run_fpost(cfg)
    assert written == ["grid_info.nc", "TS3.nc", "uv_norm.nc", "moc.nc"]
    recs = {n: jml.read_stream(out, n, 1948, records="all")
            for n in ("temp", "salt", "u", "v", "w")}
    times = read_vars(os.path.join(out, "temp.fesom.1948.nc"),
                      ["time"])["time"]
    ts3 = read_vars(os.path.join(cfg.outpath, "TS3.nc"),
                    ["temp", "salt", "time", "depth", "lon", "lat"])
    want = jfpost.do_ts3(jm, jcfg, recs["temp"], recs["salt"])
    _same(ts3["temp"], want["temp"]), _same(ts3["salt"], want["salt"])
    _same(ts3["time"], times)
    _same(ts3["depth"], jm.zmid)
    uvn = read_vars(os.path.join(cfg.outpath, "uv_norm.nc"), ["uv_norm"])
    _same(uvn["uv_norm"], jfpost.do_uv_norm(jm, jcfg, recs["u"], recs["v"]),
          tol=TOL)
    lats, psi = jfpost.do_moc(jm, jcfg, recs["w"].mean(0))
    mocf = read_vars(os.path.join(cfg.outpath, "moc.nc"),
                     ["moc", "lat_moc", "nz"])
    _same(mocf["moc"], psi, tol=TOL), _same(mocf["lat_moc"], lats)
    _same(mocf["nz"], jm.zlev)
    gi = read_vars(os.path.join(cfg.outpath, "grid_info.nc"), ["mask3"])
    _same(gi["mask3"], jfpost.make_grid_info(jm, jcfg)["mask3"])
    # the CLI on a namelist
    nml = tmp_path / "namelist.interp"
    nml.write_text(f"&config\ndatapath='{out}'\noutpath='{tmp_path / 'cli'}'"
                   f"\n/\n&todo\ndo_MOC=.true.\n/\n&regular_mesh\n"
                   f"RegDx=6.0\nRegDy=6.0\n/\n")
    res = subprocess.run([sys.executable, "-m", "fesom2_tpu_torch.post.fpost",
                          str(nml)], cwd=REPO, capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
    assert "moc.nc" in res.stdout
    _same(read_vars(str(tmp_path / "cli" / "moc.nc"), ["moc"])["moc"], psi,
          tol=TOL)


def test_plots_run_under_agg(run, meshes, tmp_path):
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.pyplot as plt
    _, out = run
    _, tm = meshes
    sst = mesh_loader.read_stream(out, "sst", 1948)
    for oce in ("global", "np", "sp"):
        fig, _, _ = plot.ftriplot(tm, sst, oce=oce)
        fig.savefig(str(tmp_path / f"sst_{oce}.png"))
        plt.close(fig)
    fig, _, _ = plot.ftriplot(tm, np.arange(tm.e2d, dtype=float),
                              data_on_elem=True)
    plt.close(fig)
    lons, lats = regrid.regular_grid(72, 36)
    reg = regrid.fesom2regular(sst, tm, lons, lats, radius_of_influence=1e6)
    fig, _, _ = plot.wplot_xy(lons, lats, reg)
    plt.close(fig)
    lat_b, psi = moc.moc_z(mesh_loader.read_stream(out, "w", 1948), tm.area,
                           tm.y2)
    fig, _, _ = plot.wplot_yz(lat_b, np.abs(tm.zlev), psi.T)
    plt.close(fig)
    with pytest.raises(ValueError):
        plot.wplot_xy(lons, lats, np.full(lons.shape, np.nan))
    s = np.random.default_rng(0).normal(size=50)
    from fesom2_tpu.post import plot as jplot
    _same(plot.moving_average(s, 7), jplot.moving_average(s, 7))


def test_fcheck_round_trip_equals_jax(run, tmp_path):
    _, out = run
    port_gold, jax_gold = str(tmp_path / "port.yml"), str(tmp_path / "j.yml")
    fcheck.write_goldens(out, port_gold)
    jfcheck.write_goldens(out, jax_gold)
    assert open(port_gold).read() == open(jax_gold).read()
    gold = fcheck.load_goldens(port_gold)
    assert gold == jfcheck.load_goldens(port_gold) and len(gold) >= 10
    assert gold == fcheck.field_means(out)
    assert fcheck.fcheck(out, jax_gold, verbose=False)
    assert jfcheck.fcheck(out, port_gold, verbose=False)
    off = str(tmp_path / "off.yml")
    with open(off, "w") as f:
        f.write("# goldens 1 % off\nfcheck:\n")
        for k, v in gold.items():
            f.write(f"  {k}: {v * 1.01!r}\n")
        f.write("other:\n  temp: 0.0\n")
    assert fcheck.load_goldens(off) == jfcheck.load_goldens(off)
    assert not fcheck.fcheck(out, off, verbose=False)
    assert not jfcheck.fcheck(out, off, verbose=False)
    env = dict(os.environ, PYTHONPATH=REPO)
    cli = [sys.executable, "-m", "fesom2_tpu_torch.post.fcheck", out]
    rec = str(tmp_path / "cli.yml")
    subprocess.run(cli + [rec, "--record"], cwd=REPO, env=env, check=True,
                   timeout=120)
    assert fcheck.load_goldens(rec) == gold
    assert subprocess.run(cli + [rec], cwd=REPO, env=env, timeout=120,
                          capture_output=True).returncode == 0
    assert subprocess.run(cli + [off], cwd=REPO, env=env, timeout=120,
                          capture_output=True).returncode == 1
