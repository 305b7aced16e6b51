"""The host side of forcing and initial state in the port against the JAX
package: the file readers and their copies, the loaders, the WOA initial
state, the year switch, the tidal potential and the GOTM bulk formulae.

The tests write their own NetCDF3 files (``forcing/synthetic.py``: the
NCEP test-set layout on a 48 x 24 grid with latitudes descending, as the
shipped T62 files have them, and a WOA18-style climatology with missing
values), once with CF ``units`` on every time axis and once without on the
radiation and precipitation files, so both branches of
``_time_axis_seconds`` run.  The numpy path is the JAX package's, so the
loaders' results are equal, not close; the tidal potential and the bulk
formulae agree within 1e-12 of max|JAX| in float64.

* ``io/netcdf.py``, ``forcing/interp.py``, ``utils/clock.py`` and
  ``forcing/prefetch.py`` are the port's copies of jax-free modules: the
  source of every function and class equals the original's, and each
  gives the original's results (the HDF5 branch of ``read_vars`` where
  ``h5py`` is installed);
* ``load_core_forcing``, ``load_sbc_forcing`` (CF units and the
  namelist's convention with its quarter-interval last stamp),
  ``climatology_ic``, ``setup_pi_model(forcing_path=...)`` and
  ``pi_initial_state(forcing_path=...)`` against JAX's on the level-3
  globe;
* ``SbcProvider``: a prefetch on a thread holds numpy, ``get`` gives the
  year's ``AtmData``, ``evict`` drops it; ``run_pi`` across a year's end
  takes the next year's series with the year-relative step index, the
  same steps as taken by hand.
"""
import dataclasses
import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fesom2_tpu.io.netcdf as jnetcdf
import fesom2_tpu.forcing.interp as jinterp
import fesom2_tpu.utils.clock as jclock
import fesom2_tpu.forcing.prefetch as jprefetch
import fesom2_tpu.forcing.atmos as jatmos
import fesom2_tpu.forcing.tides as jtides
import fesom2_tpu.forcing.gotm_bulk as jgotm
import fesom2_tpu.model as jmodel
from fesom2_tpu.core import ic as jic
from fesom2_tpu.mesh import build_mesh as jax_build_mesh

import fesom2_tpu_torch.io.netcdf as tnetcdf
import fesom2_tpu_torch.forcing.interp as tinterp
import fesom2_tpu_torch.utils.clock as tclock
import fesom2_tpu_torch.forcing.prefetch as tprefetch
from fesom2_tpu_torch.config import SbcConfig
from fesom2_tpu_torch.core import ic
from fesom2_tpu_torch.forcing import atmos, gotm_bulk, synthetic, tides
from fesom2_tpu_torch.mesh import build_mesh, globe
from fesom2_tpu_torch.model import (pi_config, pi_coupled_step_fn,
                                    pi_initial_state, setup_pi_model)
from fesom2_tpu_torch.run import run_pi

from test_torch_kpp import assert_close

MESH = dict(force_rotation=True, cyclic_length_deg=360.0,
            use_partial_cell=True, partial_cell_thresh=0.0)
GRID = dict(nlon=48, nlat=24)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(mesh dir, forcing dir with CF units and the WOA file for 1948-1950,
    forcing dir without units on radiation and precipitation)."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("forcing")
    mesh_dir = globe.write_globe(str(root / "globe"), level=3, n_layers=12,
                                 dz_bottom=1000.0)
    cf = str(root / "cf")
    for year in (1948, 1949, 1950):
        synthetic.write_ncep_test_set(cf, seed=3, year=year, **GRID)
    synthetic.write_woa18(cf, seed=3)
    bare = synthetic.write_ncep_test_set(str(root / "bare"), seed=5,
                                         cf_units=False, **GRID)
    return mesh_dir, cf, bare


@pytest.fixture(scope="module")
def meshes(files):
    return (jax_build_mesh(files[0], **MESH),
            build_mesh(files[0], device="cpu", **MESH))


def assert_atm_equal(got, want):
    for f in dataclasses.fields(want):
        assert_close(getattr(got, f.name), getattr(want, f.name), f.name,
                     tol=0.0)


# --------------------------------------------------------------------------
# the copies
# --------------------------------------------------------------------------
@pytest.mark.parametrize("orig,copy", [(jnetcdf, tnetcdf), (jinterp, tinterp),
                                       (jclock, tclock),
                                       (jprefetch, tprefetch)])
def test_copies_keep_the_originals_code(orig, copy):
    def members(mod):
        return {k: inspect.getsource(v) for k, v in vars(mod).items()
                if (inspect.isfunction(v) or inspect.isclass(v))
                and v.__module__ == mod.__name__}
    want, got = members(orig), members(copy)
    assert want and set(got) == set(want)
    for name, src in want.items():
        assert got[name] == src, name
    consts = lambda mod: {k: v for k, v in vars(mod).items()
                          if k.isupper() and isinstance(v, (int, float))}
    assert consts(copy) == consts(orig)


def test_read_vars_netcdf3(files):
    path = os.path.join(files[1], "u_10.1948.nc")
    names = ["LON", "LAT", "TIME", "U_10_MOD"]
    a, b = jnetcdf.read_vars(path, names), tnetcdf.read_vars(path, names)
    for n in names:
        assert np.array_equal(a[n], b[n]), n
    assert b["LAT"][0] > b["LAT"][-1]          # descending, as shipped
    assert tnetcdf.list_vars(path) == jnetcdf.list_vars(path)
    assert tnetcdf.read_vars(path, ["nope"], missing_ok=True) == {}


def test_read_vars_hdf5(tmp_path):
    h5py = pytest.importorskip("h5py")
    path = str(tmp_path / "f.h5")
    rng = np.random.default_rng(0)
    with h5py.File(path, "w") as h:
        h["lon"] = np.arange(8.0)
        h["temp"] = rng.standard_normal((3, 4, 8))
    a = jnetcdf.read_vars(path, ["lon", "temp", "salt"], missing_ok=True)
    b = tnetcdf.read_vars(path, ["lon", "temp", "salt"], missing_ok=True)
    assert set(b) == {"lon", "temp"}
    for n in b:
        assert np.array_equal(a[n], b[n])
    assert tnetcdf.list_vars(path) == ["lon", "temp"]


def test_write_dataset_round_trip(tmp_path):
    path = str(tmp_path / "w.nc")
    tnetcdf.write_dataset(path, {"n": 5}, {"x": (("n",), np.arange(5)),
                                          "m": (("n",), np.ones(5, bool))})
    got = jnetcdf.read_vars(path, ["x", "m"])
    # classic NetCDF has no 64-bit int and no bool (big-endian on disk)
    assert got["x"].dtype.newbyteorder("=") == np.int32
    assert got["m"].dtype.newbyteorder("=") == np.int8
    assert np.array_equal(got["x"], np.arange(5))


def test_bilinear_weights_match(meshes):
    jm, _ = meshes
    glon = np.degrees(np.asarray(jm.geo_coords[:, 0]))
    glat = np.degrees(np.asarray(jm.geo_coords[:, 1]))
    lon, lat = synthetic.t62_grid(48, 24)
    lat = lat[::-1].copy()
    field = np.random.default_rng(2).standard_normal((3, 24, 48))
    for cyclic in (True, False):
        ia, wa = jinterp.bilinear_weights(lon, lat, glon, glat, cyclic)
        ib, wb = tinterp.bilinear_weights(lon, lat, glon, glat, cyclic)
        assert np.array_equal(ia, ib) and np.array_equal(wa, wb)
        assert np.array_equal(jinterp.apply_weights(field, ia, wa),
                              tinterp.apply_weights(field, ib, wb))


def test_clock_and_events_match():
    for leap in (False, True):
        a = jclock.Clock(0.0, 365, 1951, leap)
        b = tclock.Clock(0.0, 365, 1951, leap)
        for k in range(300):
            a0, b0 = a.copy(), b.copy()
            a.advance(3600.0)
            b.advance(3600.0)
            assert (a.timenew, a.daynew, a.yearnew, a.month) \
                == (b.timenew, b.daynew, b.yearnew, b.month)
            for unit, freq in (("y", 1), ("m", 1), ("d", 2), ("h", 6),
                               ("s", 5)):
                assert jclock.event_triggered(unit, freq, a0, a, k) \
                    == tclock.event_triggered(unit, freq, b0, b, k)
        assert b.yearnew == 1952 or leap


def test_prefetch_readers_match(files):
    path = os.path.join(files[1], "t_10.1948.nc")
    ja = jprefetch.AsyncForcingProvider()
    ta = tprefetch.AsyncForcingProvider()
    try:
        for k in (0, 1, 2, 5, 6, 7, 3):
            assert np.array_equal(ja.get(path, "T_10_MOD", k),
                                  ta.get(path, "T_10_MOD", k))
        sync = tprefetch.LookaheadReader(path, "T_10_MOD",
                                         async_allowed=False)
        assert sync.n_timesteps == 8
        assert np.array_equal(sync.yield_data(4), ta.get(path, "T_10_MOD", 4))
        sync.close()
    finally:
        ja.close()
        ta.close()


# --------------------------------------------------------------------------
# the loaders and the initial state
# --------------------------------------------------------------------------
@pytest.mark.parametrize("units", [True, False])
def test_time_axis_seconds_both_branches(units):
    sbc = SbcConfig(nm_nc_iyear=1948, nm_nc_imm=2, nm_nc_idd=3, nm_nc_freq=4)
    t = np.array([0.0, 1.0, 2.0, 4.0])
    text = "hours since 1949-01-16 12:30:00" if units else ""
    want = jatmos._time_axis_seconds(t, text, 1949, sbc)
    got = atmos._time_axis_seconds(t, text, 1949, sbc)
    assert np.array_equal(got, want)
    if not units:
        # mid-points, the last a quarter interval past the last raw stamp
        raw = t / 4 * 86400.0 + (-365.0 + 31.0 + 2.0) * 86400.0
        assert got[-1] == raw[-1] + 0.25 * (raw[-1] - raw[-2])
        assert got[0] == 0.5 * (raw[0] + raw[1])


def test_load_core_forcing_matches(files, meshes):
    jm, tm = meshes
    want = jatmos.load_core_forcing(jm, files[1])
    got = atmos.load_core_forcing(tm, files[1])
    assert_atm_equal(got, want)
    assert got.u_wind.shape == (8, tm.n_nodes) and got.swdn.shape[0] == 2
    assert float(got.runoff.abs().max()) > 0.0


@pytest.mark.parametrize("which", ["cf", "bare"])
def test_load_sbc_forcing_matches(files, meshes, which):
    jm, tm = meshes
    path = files[1] if which == "cf" else files[2]
    jsbc = jatmos.ncep_test_sbc(path)
    tsbc = atmos.ncep_test_sbc(path)
    assert dataclasses.asdict(tsbc) == dataclasses.asdict(jsbc)
    if which == "bare":
        kw = dict(nm_nc_iyear=1948, nm_nc_freq=1)
        jsbc, tsbc = (dataclasses.replace(s, **kw) for s in (jsbc, tsbc))
    want = jatmos.load_sbc_forcing(jm, jsbc, year=1948)
    got = atmos.load_sbc_forcing(tm, tsbc, year=1948)
    assert_atm_equal(got, want)
    # Kelvin-coded air temperature turned into Celsius
    assert -60.0 < float(got.tair.min()) and float(got.tair.max()) < 40.0
    single = atmos.load_sbc_forcing(tm, tsbc, year=1948,
                                    dtype=torch.float32)
    assert single.tair.dtype == torch.float32
    assert torch.equal(single.tair, got.tair.float())


def test_climatology_ic_matches(files, meshes):
    jm, tm = meshes
    path = os.path.join(files[1], "woa18_netcdf_5deg.nc")
    jT, jS = jic.climatology_ic(jm, path)
    T, S = ic.climatology_ic(tm, path)
    assert np.array_equal(T, jT) and np.array_equal(S, jS)
    wet = tm.node_layer_mask.numpy()
    assert np.all(T[~wet] == 0.0) and 30.0 < S[wet].min() < S[wet].max() < 37
    F = np.random.default_rng(1).uniform(-2.0, 30.0, (5,))
    assert np.array_equal(ic.ptheta(35.0, F, 4000.0),
                          jic.ptheta(35.0, F, 4000.0))
    assert np.array_equal(ic.atg(35.0, F, 100.0), jic.atg(35.0, F, 100.0))


@pytest.fixture(scope="module")
def file_pair(files):
    """The JAX setup of the files (``setup_pi_model(mesh_path,
    forcing_path)`` with its initial state) and the port's."""
    mesh_dir, cf, _ = files
    jm, jatm = jmodel.setup_pi_model(mesh_path=mesh_dir, forcing_path=cf)
    js, jice = jmodel.pi_initial_state(jm, forcing_path=cf)
    tm, tatm = setup_pi_model(mesh_dir, device="cpu", forcing_path=cf)
    ts, tice = pi_initial_state(tm, forcing_path=cf)
    return (jm, jatm, js, jice), (tm, tatm, ts, tice)


def test_setup_and_initial_state_from_files_match(file_pair, files):
    (jm, jatm, js, jice), (tm, tatm, ts, tice) = file_pair
    assert_atm_equal(tatm, jatm)
    assert dataclasses.asdict(tm.sbc) == dataclasses.asdict(jm.sbc)
    assert not tm.sbc.y_perpetual          # the clock's 1948 has its files
    for name in ("tr", "tr_old", "hnode", "zbar_3d"):
        assert_close(getattr(ts, name), getattr(js, name), name, tol=0.0)
    for name in ("m_ice", "a_ice", "m_snow"):
        assert_close(getattr(tice, name), getattr(jice, name), name, tol=0.0)
    for name in ("Ssurf", "Tclim", "Sclim", "relax2clim"):
        assert_close(getattr(tm, name), getattr(jm, name), name, tol=0.0)
    assert float(tice.a_ice.max()) > 0.5      # ice where the WOA is cold
    # a clock year without files: the test set's 1948, perpetually
    cfg = pi_config()
    cfg.clock.yearnew = 1960
    m60, a60 = setup_pi_model(files[0], device="cpu", cfg=cfg,
                              forcing_path=files[1])
    assert m60.sbc.y_perpetual and torch.equal(a60.tair, tatm.tair)


def test_sbc_provider_switches_years(files, meshes):
    _, tm = meshes
    sbc = atmos.ncep_test_sbc(files[1])
    prov = atmos.SbcProvider(tm, sbc)
    prov.prefetch(1949)
    prov.prefetch(1949)                       # a second ask is a no-op
    prov._threads[1949].join()
    assert isinstance(prov._cache[1949], dict)   # numpy from the thread
    got = prov.get(1949)
    assert isinstance(got, atmos.AtmData)
    assert_atm_equal(got, jatmos.load_sbc_forcing(
        jax_build_mesh(files[0], **MESH), jatmos.ncep_test_sbc(files[1]),
        year=1949))
    assert prov.get(1949) is got              # cached as AtmData
    prov.evict(1949)
    assert 1949 not in prov._cache
    again = prov.get(1950)                     # no prefetch: read now
    assert not torch.equal(again.tair, got.tair)


def test_run_pi_switches_the_forcing_year(files):
    """Four steps across the end of 1948 from step index 35038: the last
    two of 1948 with 1948's series and indices 35038, 35039, then 1949's
    series (prefetched on a thread) with indices 0 and 1, as taken by
    hand; 1950 is read ahead after the switch."""
    mesh_dir, cf, _ = files
    cfg = pi_config()
    cfg.ice.evp_rheol_steps = 4
    tm, atm48 = setup_pi_model(mesh_dir, device="cpu", cfg=cfg,
                               forcing_path=cf)
    ts0, tice0 = pi_initial_state(tm, forcing_path=cf)
    spy = 365 * 96
    got_s, got_i = run_pi(tm, atm48, ts0, tice0, 4, first_step=spy - 2)
    atm49 = atmos.load_sbc_forcing(tm.mesh, tm.sbc, year=1949)
    s, i = ts0, tice0
    for atm, idx in ((atm48, spy - 2), (atm48, spy - 1), (atm49, 0),
                     (atm49, 1)):
        s, i, _ = pi_coupled_step_fn(tm, atm)(s, i, idx)
    assert torch.equal(got_s.tr, s.tr) and torch.equal(got_i.u_ice, i.u_ice)
    # the 1948 series at 1949's indices gives another state
    s48, _, _ = pi_coupled_step_fn(tm, atm48)(ts0, tice0, 0)
    s49, _, _ = pi_coupled_step_fn(tm, atm49)(ts0, tice0, 0)
    assert not torch.equal(s48.tr, s49.tr)


# --------------------------------------------------------------------------
# tides and the GOTM bulk formulae
# --------------------------------------------------------------------------
def test_foreph_offset_matches():
    for year, month, dt in ((1948, 1, 900.0), (2000, 3, 600.0),
                            (2013, 12, 3600.0), (1999, 2, 450.0)):
        assert tides.foreph_offset(year, month, dt) \
            == jtides.foreph_offset(year, month, dt)


def test_tidal_potential_matches(meshes, capsys):
    jm, tm = meshes
    off = tides.foreph_offset(1948, 1, 900.0)
    glon, glat = tm.geo_coords[:, 0], tm.geo_coords[:, 1]
    worst32 = jworst32 = 0.0
    for k in (0, 1, 37, 960):
        want = np.asarray(jtides.tidal_potential(
            off + jnp.asarray(float(k)) + 1.0, 900.0, jm.geo_coords[:, 0],
            jm.geo_coords[:, 1]))
        got = tides.tidal_potential(off + k + 1.0, 900.0, glon, glat)
        assert_close(got, want, f"ssh_gp {k}", tol=1e-12)
        dev = tides.tidal_potential(
            torch.tensor(off + k + 1.0, dtype=torch.float64), 900.0, glon,
            glat)
        assert torch.equal(dev, got)
        assert 0.1 < float(got.abs().max()) < 10.0
        # float32: the counter since 2000 cancels in the ephemeris, as in
        # the JAX package; stated, not gated beyond finiteness
        f32 = tides.tidal_potential(off + k + 1.0, 900.0, glon.float(),
                                    glat.float())
        assert f32.dtype == torch.float32 and bool(torch.isfinite(f32).all())
        j32 = np.asarray(jtides.tidal_potential(
            jnp.float32(off) + jnp.float32(k) + 1.0, 900.0,
            jm.geo_coords[:, 0].astype(jnp.float32),
            jm.geo_coords[:, 1].astype(jnp.float32)))
        assert j32.dtype == np.float32
        scale = float(got.abs().max())
        worst32 = max(worst32, float((f32.double() - got).abs().max())
                      / scale)
        jworst32 = max(jworst32, float(np.abs(j32 - want).max()) / scale)
    with capsys.disabled():
        print(f"\ntidal_potential float32 against float64, of max|ssh_gp|: "
              f"port {worst32:.3e}, JAX {jworst32:.3e}")


def _bulk_inputs(n=200, seed=9):
    rng = np.random.default_rng(seed)
    u = lambda lo, hi: rng.uniform(lo, hi, n)
    return dict(sst=u(-1.8, 30.0), airt=u(-30.0, 32.0), u10=u(-15.0, 15.0),
                v10=u(-15.0, 15.0), precip=u(0.0, 5e-7), hum=u(60.0, 99.0),
                airp=u(98000.0, 103000.0), dlat=u(-89.0, 89.0),
                dlon=u(-180.0, 180.0), cloud=u(0.0, 1.0),
                yday=u(1.0, 365.0), hh=u(0.0, 24.0), ZoL=u(-3.0, 3.0))


def _cmp(got, want, name):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, np.asarray(w), f"{name}[{i}]", tol=1e-12)


@pytest.mark.parametrize("method", [1, 2, 3, 4])
def test_gotm_humidity_and_back_radiation(method):
    """Each humidity input (relative humidity, wet-bulb and dew-point
    temperature, specific humidity) and each back-radiation formula."""
    x = _bulk_inputs()
    hum = {1: x["hum"], 2: x["airt"] - 2.0, 3: x["airt"] - 3.0,
           4: np.full_like(x["hum"], 0.01)}[method]
    t, j = (lambda a: torch.tensor(a)), (lambda a: jnp.asarray(a))
    args = (hum, x["airp"], x["sst"], x["airt"])
    got = gotm_bulk.humidity(method, *map(t, args))
    _cmp(got, jgotm.humidity(method, *map(j, args)), f"humidity {method}")
    # the back radiation on relative humidity's qa, ea (positive)
    qa, _, _, ea, _ = gotm_bulk.humidity(1, *map(t, (x["hum"],) + args[1:]))
    rad = (x["dlat"], x["sst"] + 273.16, x["airt"] + 273.16, x["cloud"],
           ea.numpy(), qa.numpy())
    _cmp(gotm_bulk.back_radiation(method, *map(t, rad)),
         jgotm.back_radiation(method, *map(j, rad)),
         f"back_radiation {method}")


@pytest.mark.parametrize("rain", [True, False])
def test_gotm_fairall_psi_and_sun(rain):
    x = _bulk_inputs()
    t, j = (lambda k: torch.tensor(x[k])), (lambda k: jnp.asarray(x[k]))
    for flag in (1, 2):
        _cmp(gotm_bulk.psi(flag, t("ZoL")), jgotm.psi(flag, j("ZoL")),
             f"psi {flag}")
    qa, qs, rhoa, _, _ = gotm_bulk.humidity(1, t("hum"), t("airp"), t("sst"),
                                            t("airt"))
    args = [t("sst"), t("airt"), t("u10"), t("v10"), t("precip"), qs, qa,
            rhoa]
    jargs = [jnp.asarray(a.numpy()) for a in args]
    _cmp(gotm_bulk.fairall(*args, rain_impact=rain),
         jgotm.fairall(*jargs, rain_impact=rain), "fairall")
    zen = gotm_bulk.solar_zenith_angle(t("yday"), t("hh"), t("dlon"),
                                       t("dlat"))
    _cmp(zen, jgotm.solar_zenith_angle(j("yday"), j("hh"), j("dlon"),
                                       j("dlat")), "zenith")
    _cmp(gotm_bulk.short_wave_radiation(zen, t("yday"), t("dlon"), t("dlat"),
                                        t("cloud")),
         jgotm.short_wave_radiation(jnp.asarray(zen.numpy()), j("yday"),
                                    j("dlon"), j("dlat"), j("cloud")),
         "short_wave")
