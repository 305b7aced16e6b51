"""The port's atmospheric forcing against the JAX package (CPU, float64).

The same numpy arrays go to both sides: seeded inputs through the NCAR
bulk formulae, and the code-built atmosphere of
``mesh.globe.globe_atm_fixtures`` on the level-3 globe through the time
interpolation (between records, on a record, before the first and after
the last), ``atm_window``, ``atm_state_at`` and ``update_atm_forcing``.
Every output agrees to 1e-10 of its largest JAX magnitude; the
interpolation, which only picks and blends two rows, to 1e-14.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fesom2_tpu.forcing import atmos as jatmos, bulk as jbulk
from fesom2_tpu.ice.state import zero_ice_forcing as jzero_ice_forcing
from fesom2_tpu.mesh import build_mesh as jax_build_mesh

from fesom2_tpu_torch.convert import atm_from_numpy
from fesom2_tpu_torch.forcing import atmos, bulk
from fesom2_tpu_torch.ice.state import zero_ice_forcing
from fesom2_tpu_torch.mesh import build_mesh, globe

from test_torch_kpp import assert_close

PC = dict(force_rotation=True, cyclic_length_deg=360.0,
          use_partial_cell=True, partial_cell_thresh=0.0)


def t(x):
    return torch.tensor(np.asarray(x))


class Case:
    """The JAX and the port side of one atmosphere."""


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    torch.set_num_threads(1)
    path = globe.write_globe(str(tmp_path_factory.mktemp("globe")), level=3,
                             n_layers=12, dz_bottom=1000.0)
    c = Case()
    c.jmesh = jax_build_mesh(path, **PC)
    c.tmesh = build_mesh(path, device="cpu", **PC)
    c.fx = globe.globe_atm_fixtures(np.asarray(c.jmesh.geo_coords[:, 1]),
                                    seed=3, n_records=4)
    c.jatm = jatmos.AtmData(**{k: jnp.asarray(v) for k, v in c.fx.items()})
    c.tatm = atm_from_numpy(c.fx, "cpu")
    return c


def test_atm_fixtures_are_an_atmosphere(case):
    fx = case.fx
    lat_rad = np.asarray(case.jmesh.geo_coords[:, 1])
    lat = np.degrees(lat_rad)
    assert [f.name for f in dataclasses.fields(atmos.AtmData)] \
        == [f.name for f in dataclasses.fields(jatmos.AtmData)] == list(fx)
    for axis in ("t_wind", "t_rad", "t_prec"):
        assert fx[axis].shape == (4,) and (np.diff(fx[axis]) > 0).all()
    steps = {float(np.diff(fx[a])[0]) for a in ("t_wind", "t_rad", "t_prec")}
    assert len(steps) == 3
    assert (fx["tair"][:, np.abs(lat) > 65.0] < 0.0).all()
    assert (fx["tair"][:, np.abs(lat) < 30.0] > 0.0).all()
    for name in ("shum", "swdn", "lwdn", "prec", "runoff"):
        assert (fx[name] >= 0.0).all() and fx[name].max() > 0.0, name
    assert fx["snow"].max() > 0.0 and (fx["snow"][:, np.abs(lat) < 30] == 0).all()
    again = globe.globe_atm_fixtures(lat_rad, seed=3, n_records=4)
    assert all(np.array_equal(again[k], fx[k]) for k in fx)
    with pytest.raises(ValueError, match="n_records"):
        globe.globe_atm_fixtures(lat_rad, n_records=2)


def test_cd_n10_and_psi():
    u10 = np.linspace(0.3, 40.0, 200)
    assert_close(bulk._cd_n10(t(u10)), jbulk._cd_n10(jnp.asarray(u10)),
                 "cd_n10", tol=1e-14)
    zeta = np.linspace(-10.0, 10.0, 401)
    for name, a, b in zip(("psi_m", "psi_h"), bulk._psi(t(zeta)),
                          jbulk._psi(jnp.asarray(zeta))):
        assert_close(a, b, name, tol=1e-13)


@pytest.mark.parametrize("heights", [(10.0, 10.0, 10.0), (10.0, 2.0, 2.0)])
def test_ncar_ocean_fluxes(heights):
    rng = np.random.default_rng(2)
    n = 400
    tair = rng.uniform(-30.0, 30.0, n)
    sst = rng.uniform(-1.8, 30.0, n)
    shum = rng.uniform(1e-4, 2e-2, n)
    wind = rng.uniform(-15.0, 15.0, (2, n))
    wind[:, :5] = 0.0                       # calm: the u10min floor
    cur = rng.uniform(-0.5, 0.5, (2, n))
    args = (tair, sst, shum, wind[0], wind[1], cur[0], cur[1])
    want = jax.jit(lambda *a: jbulk.ncar_ocean_fluxes(*a, *heights))(
        *map(jnp.asarray, args))
    got = bulk.ncar_ocean_fluxes(*map(t, args), *heights)
    for name, a, b in zip(("cd", "ch", "ce"), got, want):
        assert_close(a, b, name)
        assert torch.isfinite(a).all() and float(a.min()) > 0.0


# between records, on a record, before the first, after the last, and on
# the last record of the 6-hourly axis
TIMES = [10800.0, 5000.0, 21600.0, 0.0, -3600.0, 64800.0, 1.0e6]


@pytest.mark.parametrize("t_sec", TIMES)
def test_time_interp(case, t_sec):
    c = case
    for series, axis in (("u_wind", "t_wind"), ("swdn", "t_rad"),
                         ("prec", "t_prec")):
        want = jatmos._time_interp(getattr(c.jatm, series),
                                   getattr(c.jatm, axis), jnp.asarray(t_sec))
        got = atmos._time_interp(getattr(c.tatm, series),
                                 getattr(c.tatm, axis), t_sec)
        assert_close(got, want, f"{series} at {t_sec}", tol=1e-14)
        # a 0-d tensor for the time gives the same
        assert torch.equal(got, atmos._time_interp(
            getattr(c.tatm, series), getattr(c.tatm, axis),
            torch.tensor(t_sec, dtype=torch.float64)))
    if t_sec <= 0.0:
        assert torch.equal(got, c.tatm.prec[0])
    if t_sec == 21600.0:
        assert torch.equal(atmos._time_interp(c.tatm.u_wind, c.tatm.t_wind,
                                              t_sec), c.tatm.u_wind[1])


@pytest.mark.parametrize("window", [(0.0, 18000.0), (30000.0, 50000.0),
                                    (1.0e6, 2.0e6)])
def test_atm_window(case, window):
    c = case
    want = jatmos.atm_window(c.jatm, *window)
    got = atmos.atm_window(c.tatm, *window)
    for f in dataclasses.fields(want):
        assert_close(getattr(got, f.name), getattr(want, f.name), f.name,
                     tol=0.0)
    assert got.t_wind.shape[0] >= 2 and got.u_wind.shape[0] == got.t_wind.shape[0]
    # inside the window the cut series interpolates as the whole one
    mid = min(0.5 * (window[0] + window[1]), 1.5e6)
    assert torch.equal(
        atmos._time_interp(got.u_wind, got.t_wind, mid),
        atmos._time_interp(c.tatm.u_wind, c.tatm.t_wind, mid))


@pytest.mark.parametrize("t_sec", [0.0, 4500.0, 30000.0])
def test_atm_state_at(case, t_sec):
    want = jatmos.atm_state_at(case.jatm, jnp.asarray(t_sec))
    got = atmos.atm_state_at(case.tatm, t_sec)
    assert list(got) == list(want)
    for k in want:
        assert_close(got[k], want[k], k, tol=1e-14)


@pytest.mark.parametrize("t_sec", [0.0, 2700.0, 40000.0])
def test_update_atm_forcing(case, t_sec):
    c = case
    rng = np.random.default_rng(9)
    N = c.jmesh.n_nodes
    ice_uv = rng.uniform(-0.2, 0.2, (2, N))
    oce_uv = rng.uniform(-0.3, 0.3, (2, N))
    sst = 27.0 * np.cos(np.asarray(c.jmesh.geo_coords[:, 1])) ** 2 - 1.5
    args = (ice_uv[0], ice_uv[1], oce_uv[0], oce_uv[1], sst)
    want = jax.jit(lambda ts, *a: jatmos.update_atm_forcing(
        c.jatm, ts, *a, jzero_ice_forcing(c.jmesh)))(
        jnp.asarray(t_sec), *map(jnp.asarray, args))
    got = atmos.update_atm_forcing(c.tatm, t_sec, *map(t, args),
                                   zero_ice_forcing(c.tmesh))
    for f in dataclasses.fields(want):
        assert_close(getattr(got, f.name), getattr(want, f.name), f.name)
    assert float(got.stress_atmice_x.abs().max()) > 0.01
    assert float(got.Ch_atm_oce.min()) > 0.0


def test_cd_atm_ice_is_the_reference_value():
    assert atmos.Cd_atm_ice == jatmos.Cd_atm_ice == 1.32e-3
