"""The port's output streams (``io/streams.py``) against the JAX
package's, on the CPU.

On the level-3 globe with 12 layers, the CI configuration with the ice,
GM/Redi, the density-space MOC, the DVD and the 3D vorticity on: the 51
ids of ``tests/test_streams_registry.py:53-62`` resolve in both packages,
the gated ids of ``:121-128`` give None in both, ``STREAMS_NOT_CARRIED``
is the same; every id either package resolves (the atmosphere's too)
resolves in the other, and its extract on the port's state after two
coupled steps (handed to JAX through numpy) agrees within 1e-10 of the
largest JAX magnitude, Icepack's streams with every aux tracer and the
floe-size distribution too; ``OutputStreams`` over three states writes
the files JAX's writes (``async_write=False``; the same values within
1e-10), the writer thread the same files as the caller; the density-MOC
streams evaluate ``diag_dens_moc`` once an update; ``parse_namelist_io``
reads a ``namelist.io`` the test writes, as JAX's does.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fesom2_tpu.config import ModelConfig as JModelConfig
from fesom2_tpu.forcing.atmos import AtmData as JAtmData
from fesom2_tpu.ice.icepack.state import IcepackConfig as JIcepackConfig
from fesom2_tpu.io import streams as jstreams
from fesom2_tpu.io.netcdf import list_vars
from fesom2_tpu.utils.clock import Clock as JClock

from fesom2_tpu_torch.config import ModelConfig
from fesom2_tpu_torch.convert import to_numpy
from fesom2_tpu_torch.core import diagnostics
from fesom2_tpu_torch.ice.icepack import IcepackConfig, init_icepack_state
from fesom2_tpu_torch.io import streams
from fesom2_tpu_torch.io.netcdf import read_vars
from fesom2_tpu_torch.model import pi_config
from fesom2_tpu_torch.utils.clock import Clock

from test_torch_diagnostics import globe_run, path, to_jax  # noqa: F401
from test_torch_restart import to_jax_ipk

TOL = 1e-10
RESOLVABLE = [
    "sst", "sss", "ssh", "vve_5", "ssh_rhs_old", "MLD1", "MLD2",
    "uice", "vice", "a_ice", "m_ice", "m_snow", "thdgr", "thdgrsn",
    "flice", "evap", "ist",
    "fh", "fw", "atmoce_x", "atmoce_y", "tx_sur", "ty_sur",
    "virtual_salt", "real_salt_flux", "curl_surf", "dens_flux",
    "temp", "salt", "u", "v", "w", "Kv", "Av", "N2", "pgf_x", "pgf_y",
    "unod", "vnod", "alpha", "beta", "slope_x", "slope_y", "slope_z",
    "bolus_u", "bolus_v", "bolus_w", "fer_K", "fer_C", "fer_scal",
    "dMOC",
]
# every other id make_stream knows; with the CI configuration some give
# None (the TKE, IDEMIX and aEVP fields, the passive tracers)
MORE = [
    "dflux", "density_dMOC", "dvd_temp_h", "dvd_temp_v", "dvd_salt_h",
    "dvd_salt_v", "curl_u", "density_flux_e", "std_dens_UDZ",
    "std_dens_VDZ", "std_dens_VOL", "std_dens_Z", "std_dens_W",
    "std_dens_flux_H", "U_rho_x_DZ", "V_rho_x_DZ", "std_heat_flux",
    "std_frwt_flux", "std_rest_flux", "tair", "shum", "uwind", "vwind",
    "swr", "lwr", "prec", "snow", "runoff", "otracers", "atmice_x",
    "atmice_y", "iceoce_x", "iceoce_y", "alpha_EVP", "beta_EVP", "subli",
    "cd", "ce", "ch", "u_surf", "v_surf", "u_bott", "v_bott", "tx_bot",
    "ty_bot", "utau_surf", "utau_bott", "uu", "vv", "uv", "um", "vm",
    "wm", "uw", "vw", "rhof", "wrhof", "dudx", "dudy", "dvdx", "dvdy",
    "dudz", "dvdz", "av_dudz", "av_dvdz", "av_dudz_sq", "tke", "tke_Lmix",
    "tke_Pr", "iwe", "iwe_Tdis", "kpp_obldepth", "kpp_sbuoyflx", "Redi_K",
    "momix_length", "tra_101", "tra_x", "no_such_id", "ssh_rhs"]
# ids whose extract reads a forcing field the ocean Forcing does not hold
# (in both packages): resolution only
NOT_EXTRACTED = ("atmice_x", "atmice_y")


def full_config():
    cfg = pi_config()
    cfg.ice.evp_rheol_steps = 8
    for flag in ("ldiag_dMOC", "ldiag_DVD", "ldiag_curl_vel3"):
        setattr(cfg.diag, flag, True)
    return cfg


@pytest.fixture(scope="module")
def run(path):  # noqa: F811
    r = globe_run(path, full_config(), n_steps=3)
    r.jatm = to_jax(JAtmData, r.tatm)
    return r


def extract(d, st, ice, extra, forcing):
    if d.wants_forcing:
        return d.extract(st, ice, forcing)
    if d.wants_extra:
        return d.extract(st, ice, extra)
    return d.extract(st, ice)


def test_registry_ids_resolve_in_both(run):
    r = run
    assert len(RESOLVABLE) == 51
    for sid in RESOLVABLE:
        d = streams.make_stream(sid, r.mesh, r.cfg)
        jd = jstreams.make_stream(sid, r.jmesh, r.cfg)
        assert d is not None and jd is not None, sid
        assert (d.name, d.comment, d.wants_forcing) == (
            jd.name, jd.comment, jd.wants_forcing), sid


def test_gated_ids_give_none_in_both(run):
    r = run
    for cfg in (ModelConfig(), JModelConfig()):
        cfg.run.use_ice = False
        cfg.dyn.Fer_GM = False
        for sid in ("a_ice", "uice", "bolus_u", "fer_K", "dMOC",
                    "otracers"):
            assert streams.make_stream(sid, r.mesh, cfg) is None, sid
            assert jstreams.make_stream(sid, r.jmesh, cfg) is None, sid


def test_not_carried_lists_agree():
    assert streams.STREAMS_NOT_CARRIED == jstreams.STREAMS_NOT_CARRIED


def test_every_extract_matches_jax(run):
    r = run
    hold, jhold = streams.AtmHolder(r.tatm), jstreams.AtmHolder(r.jatm)
    n = 0
    for sid in RESOLVABLE + MORE:
        d = streams.make_stream(sid, r.mesh, r.cfg, atm=hold)
        jd = jstreams.make_stream(sid, r.jmesh, r.cfg, atm=jhold)
        assert (d is None) == (jd is None), sid
        if d is None or sid in NOT_EXTRACTED:
            continue
        assert (d.name, d.comment, d.freq, d.unit, d.precision,
                d.wants_forcing, d.wants_extra) == (
            jd.name, jd.comment, jd.freq, jd.unit, jd.precision,
            jd.wants_forcing, jd.wants_extra), sid
        got = extract(d, r.ts, r.tice, None, r.tof)
        want = extract(jd, r.js, r.jice, None, r.jf)
        scale = max(float(np.abs(np.asarray(want)).max()), 1e-300)
        err = float(np.abs(to_numpy(got) - np.asarray(want)).max())
        assert err <= TOL * scale, f"{sid}: {err:.3e} of {scale:.3e}"
        n += 1
    assert n >= 110


def test_icepack_streams_match_jax(run):
    r = run
    opts = dict(tr_pond_cesm=True, tr_iage=True, tr_FY=True, tr_lvl=True,
                tr_fsd=True)
    ipc, jipc = IcepackConfig(**opts), JIcepackConfig(**opts)
    p = init_icepack_state(ipc, r.tice.a_ice, r.tice.m_ice, r.tice.m_snow,
                           r.tice.t_skin)
    rng = np.random.default_rng(7)
    p = dataclasses.replace(p, ta=p.ta + torch.as_tensor(
        rng.uniform(0.0, 0.1, p.ta.shape)), tv=p.tv + torch.as_tensor(
        rng.uniform(0.0, 0.1, p.tv.shape)))
    defs = streams.default_icepack_streams(ipc)
    jdefs = jstreams.default_icepack_streams(jipc)
    assert [d.name for d in defs] == [d.name for d in jdefs]
    assert "fsdrad" in [d.name for d in defs] and len(defs) > 8
    jp = to_jax_ipk(p)
    for d, jd in zip(defs, jdefs):
        got, want = d.extract(r.ts, r.tice, p), jd.extract(r.js, r.jice, jp)
        scale = max(float(np.abs(np.asarray(want)).max()), 1e-300)
        assert float(np.abs(to_numpy(got) - np.asarray(want)).max()) \
            <= TOL * scale, d.name
    assert [d.name for d in streams.default_icepack_streams()] == [
        "aicen", "vicen", "vsnon", "Tsfcn"]


FILE_IDS = ("fh", "curl_surf", "std_dens_VOL", "std_dens_W", "dvd_temp_h",
            "density_flux_e", "std_heat_flux")


def stream_defs(mod, mesh, cfg):
    """The default ocean and ice streams and a few more: every third
    step, and sst and a_ice every step."""
    defs = mod.default_ocean_streams(mesh) + mod.default_ice_streams() \
        + [mod.make_stream(sid, mesh, cfg) for sid in FILE_IDS]
    for d in defs:
        d.unit = "s"
        d.freq = 1 if d.name in ("sst", "a_ice") else 3
    return defs


def write_streams(out, states, clock_cls, dt):
    c = clock_cls(0.0, 1, 1948)
    for k, (st, ice, f) in enumerate(states):
        out.update_means(st, ice, None, f)
        before = c.copy()
        c.advance(dt)
        out.maybe_flush(before, c, k)
    out.finalize()


def test_output_streams_write_jax_files(run, tmp_path):
    r = run
    mine, theirs, threaded = (str(tmp_path / n)
                              for n in ("port", "jax", "thread"))
    write_streams(streams.OutputStreams(stream_defs(streams, r.mesh, r.cfg),
                                        mine, async_write=False),
                  r.states, Clock, r.cfg.dt)
    jstates = [(to_jax(type(r.js), s), to_jax(type(r.jice), i),
                to_jax(type(r.jf), f)) for s, i, f in r.states]
    write_streams(jstreams.OutputStreams(
        stream_defs(jstreams, r.jmesh, r.cfg), theirs, async_write=False),
        jstates, JClock, r.cfg.dt)
    write_streams(streams.OutputStreams(stream_defs(streams, r.mesh, r.cfg),
                                        threaded), r.states, Clock, r.cfg.dt)
    files = sorted(os.listdir(theirs))
    assert files == sorted(os.listdir(mine)) == sorted(os.listdir(threaded))
    assert len(files) == 14 + len(FILE_IDS)
    for name in files:
        names = list_vars(os.path.join(theirs, name))
        assert sorted(list_vars(os.path.join(mine, name))) == sorted(names)
        a = read_vars(os.path.join(mine, name), names)
        b = read_vars(os.path.join(theirs, name), names)
        c = read_vars(os.path.join(threaded, name), names)
        for v in names:
            assert a[v].shape == b[v].shape and a[v].dtype == b[v].dtype
            scale = max(float(np.abs(b[v]).max()), 1e-300)
            assert float(np.abs(a[v] - b[v]).max()) <= TOL * scale, \
                (name, v)
            assert np.array_equal(a[v], c[v]), (name, v)
    sst = read_vars(os.path.join(mine, "sst.fesom.1948.nc"), ["sst", "time"])
    assert sst["sst"].shape[0] == 3
    assert np.array_equal(sst["sst"][1], to_numpy(r.states[1][0].tr[0, 0]))
    temp = read_vars(os.path.join(mine, "temp.fesom.1948.nc"), ["temp"])
    mean = sum(s.tr[0] for s, _, _ in r.states) / 3
    assert temp["temp"].shape[0] == 1
    assert np.abs(temp["temp"][0] - to_numpy(mean)).max() <= 1e-13


def test_density_moc_bundle_runs_once_an_update(run, monkeypatch, tmp_path):
    r = run
    calls = []
    real = diagnostics.diag_dens_moc

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(diagnostics, "diag_dens_moc", counted)
    defs = [streams.make_stream(sid, r.mesh, r.cfg)
            for sid in ("std_dens_UDZ", "std_dens_VOL", "std_dens_W",
                        "U_rho_x_DZ", "std_rest_flux")]
    out = streams.OutputStreams(defs, str(tmp_path))
    for s, i, f in r.states:
        out.update_means(s, i, None, f)
    assert len(calls) == 3
    # an id the bundle lacks takes the classes, as in the JAX package
    assert torch.equal(out._acc[4], 3 * torch.as_tensor(
        diagnostics.STD_DENS))


NAMELIST_IO = """&diag_list
ldiag_solver=.false.
/
&nml_listsize
io_listsize=100
/
&nml_list
io_list =  'sst       ',1, 'm', 4,
           'sss       ',1, 'm', 4,
           'a_ice     ',1, 'd', 4,
           'salt      ',1, 'y', 8,
           'bolus_u   ',1, 'y', 4,
           'unknown   ',1, 'y', 4,
           'temp      ',1, 'y', 8,
/
"""


def test_parse_namelist_io_matches_jax(run, tmp_path):
    r = run
    f = tmp_path / "namelist.io"
    f.write_text(NAMELIST_IO)
    got = streams.parse_namelist_io(str(f))
    assert got == jstreams.parse_namelist_io(str(f))
    assert got == [("sst", 1, "m", "f4"), ("sss", 1, "m", "f4"),
                   ("a_ice", 1, "d", "f4"), ("salt", 1, "y", "f8"),
                   ("bolus_u", 1, "y", "f4")]
    defs = streams.streams_from_io_list(got, r.mesh, r.cfg, atm=r.tatm)
    jdefs = jstreams.streams_from_io_list(got, r.jmesh, r.cfg, atm=r.jatm)
    assert [(d.name, d.freq, d.unit, d.precision) for d in defs] == [
        (d.name, d.freq, d.unit, d.precision) for d in jdefs]
    empty = tmp_path / "empty.io"
    empty.write_text("&nml_listsize\n/\n")
    assert streams.parse_namelist_io(str(empty)) == []
