"""The port's OASIS stand-in (``fesom2_tpu_torch/coupler``) against the
JAX package's ``fesom2_tpu/coupler`` on the level-3 globe (12 layers) with
the seeded ice of ``tests/test_torch_ice.py`` (CPU, float64):

- ``CplDriver``'s send means (ECHAM and OIFS sets, 3 collected steps)
  bitwise JAX's, its accumulators kept on the state's device in its
  dtype; ``recv``'s fluxes and stresses bitwise JAX's, None while a field
  is missing;
- ``force_flux_consv`` within 1e-13 of max|JAX| for hemispheres 0, 1 and
  2 (and the uniform fallback), the corrected field's area integral equal
  to ``atm_net``;
- one ``ice_timestep_cpl`` fed by ``recv`` (8 mEVP subcycles) within 1e-9
  of JAX's fed by its own ``recv``;
- the wire format: the port's ``SocketTransport`` against JAX's
  ``OasisEndpoint``, JAX's client against the port's endpoint, over a
  local TCP socket, each socket with a 30 s timeout;
- an atmosphere in a subprocess that imports only the port, coupled
  through the port's endpoint.
"""
import dataclasses
import os
import socket
import subprocess
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fesom2_tpu import coupler as jcpl
from fesom2_tpu.ice import step as jstep

from fesom2_tpu_torch import coupler
from fesom2_tpu_torch.ice.step import ice_timestep_cpl
from fesom2_tpu_torch.mesh import globe
from fesom2_tpu_torch.model import pi_config

from test_torch_ice import ICE_FIELDS, ice_case, t
from test_torch_kpp import assert_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return ice_case(globe.write_globe(
        str(tmp_path_factory.mktemp("globe")), level=3, n_layers=12,
        dz_bottom=1000.0))


@pytest.fixture
def socket_timeout():
    old = socket.getdefaulttimeout()
    socket.setdefaulttimeout(30.0)
    yield
    socket.setdefaulttimeout(old)


def _steps(c, n=3):
    """n seeded (state, ice) pairs: SST and the ice fields moved."""
    rng = np.random.default_rng(8)
    out = []
    for _ in range(n):
        tr = rng.normal(size=(2, 3, c.jmesh.n_nodes))
        d = dict(a_ice=rng.uniform(0, 1, c.jmesh.n_nodes),
                 m_ice=rng.uniform(0, 2, c.jmesh.n_nodes),
                 m_snow=rng.uniform(0, 0.3, c.jmesh.n_nodes),
                 t_skin=rng.uniform(-20, 0, c.jmesh.n_nodes))
        out.append(((types.SimpleNamespace(tr=jnp.asarray(tr)),
                     dataclasses.replace(c.jice, **{
                         k: jnp.asarray(v) for k, v in d.items()})),
                    (types.SimpleNamespace(tr=t(tr)),
                     dataclasses.replace(c.tice, **{k: t(v)
                                                    for k, v in d.items()}))))
    return out


def _recv_fields(names, n, seed=4):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(scale=100.0 if "heat" in k else 1e-7
                          if k in ("prec_oce", "snow_oce", "evap_oce",
                                   "subl_oce", "hydr_oce") else 0.1,
                          size=n) for k in names}


@pytest.mark.parametrize("oifs", [False, True])
def test_send_means_equal_jax(case, oifs):
    c = case
    jt, tt = jcpl.InMemoryTransport(), coupler.InMemoryTransport()
    jd = jcpl.CplDriver(c.jmesh, jt, oifs=oifs)
    td = coupler.CplDriver(c.tmesh, tt, oifs=oifs)
    assert td.send_names == jd.send_names and td.recv_names == jd.recv_names
    for (js, ji), (ts, ti) in _steps(c):
        jd.collect(js, ji)
        td.collect(ts, ti)
    for v in td._acc.values():
        assert isinstance(v, torch.Tensor) and v.dtype == torch.float64
        assert v.device == ts.tr.device
    jd.send()
    td.send()
    assert sorted(tt._box) == sorted(jt._box) == sorted(jd.send_names)
    for k in jd.send_names:
        got, want = tt._box[k], jt._box[k]
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        assert np.array_equal(got, want), k
    assert td._count == 0 and not td._acc
    td.send()                                # nothing collected: no put
    assert sorted(tt._box) == sorted(jd.send_names)


@pytest.mark.parametrize("oifs", [False, True])
def test_recv_equals_jax(case, oifs):
    c = case
    jt, tt = jcpl.InMemoryTransport(), coupler.InMemoryTransport()
    jd = jcpl.CplDriver(c.jmesh, jt, oifs=oifs)
    td = coupler.CplDriver(c.tmesh, tt, oifs=oifs)
    fields = _recv_fields(jd.recv_names, c.jmesh.n_nodes)
    for k, v in list(fields.items())[:-1]:
        jt.put(k, v), tt.put(k, v)
    assert td.recv() is None and jd.recv() is None
    k, v = list(fields.items())[-1]
    jt.put(k, v), tt.put(k, v)
    (tatm, tst), (jatm, jst) = td.recv(), jd.recv()
    for f in dataclasses.fields(jatm):
        got = getattr(tatm, f.name)
        assert got.dtype == c.tmesh.area.dtype
        assert np.array_equal(got.numpy(), np.asarray(getattr(jatm, f.name)))
    assert sorted(tst) == sorted(jst)
    for k in jst:
        assert np.array_equal(tst[k].numpy(), np.asarray(jst[k])), k


@pytest.mark.parametrize("hemisphere", [0, 1, 2])
@pytest.mark.parametrize("zero_field", [False, True])
def test_force_flux_consv_equals_jax(case, hemisphere, zero_field):
    c = case
    rng = np.random.default_rng(hemisphere)
    N = c.jmesh.n_nodes
    field = np.zeros(N) if zero_field else rng.normal(50.0, 80.0, N)
    mask = (rng.uniform(size=N) < 0.8).astype(np.float64)
    atm_net = 3.0e15
    want = np.asarray(jcpl.force_flux_consv(jnp.asarray(field),
                                            jnp.asarray(mask), atm_net,
                                            c.jmesh, hemisphere))
    got = coupler.force_flux_consv(t(field), t(mask), atm_net, c.tmesh,
                                   hemisphere).numpy()
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
    # the corrected field's integral over the hemisphere's masked area is
    # the atmosphere's net flux
    lat = c.tmesh.geo_coords[:, 1].numpy()
    sel = {0: np.ones(N, bool), 1: lat >= 0, 2: lat < 0}[hemisphere]
    w = np.where(sel, mask, 0.0) * c.tmesh.area[0].numpy()
    assert abs((got * w).sum() - atm_net) <= 1e-12 * atm_net


def test_ice_timestep_cpl_fed_by_recv(case):
    c = case
    cfg = pi_config()
    cfg.ice.evp_rheol_steps = 8
    jt, tt = jcpl.InMemoryTransport(), coupler.InMemoryTransport()
    jd = jcpl.CplDriver(c.jmesh, jt)
    td = coupler.CplDriver(c.tmesh, tt)
    rng = np.random.default_rng(6)
    n = c.jmesh.n_nodes
    u = lambda lo, hi: rng.uniform(lo, hi, n)
    fields = dict(heat_oce=u(-300.0, 100.0), heat_ico=u(-150.0, 80.0),
                  heat_swo=u(0.0, 250.0), evap_oce=u(-5e-8, 0.0),
                  subl_oce=u(-1e-8, 0.0), prec_oce=u(0.0, 3e-8),
                  snow_oce=u(0.0, 2e-8), hydr_oce=u(0.0, 1e-9),
                  taux_oce=u(-0.2, 0.2), tauy_oce=u(-0.2, 0.2),
                  taux_ico=u(-0.2, 0.2), tauy_ico=u(-0.2, 0.2))
    for k, v in fields.items():
        jt.put(k, v), tt.put(k, v)
    (tatm, tst), (jatm, jst) = td.recv(), jd.recv()
    jforcing = dataclasses.replace(c.jforcing, **jst)
    tforcing = dataclasses.replace(c.tforcing, **tst)
    want = jax.jit(lambda i, f, a, s: jstep.ice_timestep_cpl(
        i, c.jmesh, f, a, s, cfg, False))(c.jice, jforcing, jatm, c.jsurf)
    got = ice_timestep_cpl(c.tice, c.tmesh, tforcing, tatm, c.tsurf, cfg,
                           False)
    for name in ICE_FIELDS:
        assert_close(getattr(got, name), getattr(want, name), name, tol=1e-9)
    assert float(got.u_ice.abs().max()) > 1e-3


@pytest.mark.parametrize("server", ["jax", "port"])
def test_socket_wire_format_across_packages(server, socket_timeout):
    """A client of one package against the endpoint of the other: puts,
    gets of both dtypes and shapes, a get of a missing name."""
    ep_mod, cl_mod = (jcpl, coupler) if server == "jax" else (coupler, jcpl)
    ep = ep_mod.OasisEndpoint(("127.0.0.1", 0))
    try:
        cl = cl_mod.SocketTransport(ep.address)
        try:
            rng = np.random.default_rng(1)
            a64 = rng.normal(size=(3, 7))
            a32 = rng.normal(size=11).astype(np.float32)
            ep.put("sst_feom", a64)
            got = cl.get("sst_feom", timeout=10.0)
            assert got.dtype == np.float64 and np.array_equal(got, a64)
            cl.put("heat_oce", a32)
            cl.put("scalar", np.float64(2.5))
            back = ep.get("heat_oce", timeout=10.0)
            assert back.dtype == np.float32 and np.array_equal(back, a32)
            assert ep.get("scalar", timeout=10.0).item() == 2.5
            assert cl.get("nothing") is None
        finally:
            cl.close()
    finally:
        ep.close()


ATMOSPHERE = """
import sys
import numpy as np
from fesom2_tpu_torch.coupler import SocketTransport, RECV_FIELDS_ECHAM
host, port, n = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
cl = SocketTransport((host, port))
sst = cl.get("sst_feom", timeout=30.0)
assert sst is not None and sst.shape == (n,)
rng = np.random.default_rng(0)
for name in RECV_FIELDS_ECHAM:
    cl.put(name, rng.normal(size=n) + float(sst.mean()))
cl.put("done", np.ones(1))
cl.close()
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "fesom2_tpu" or m.startswith("fesom2_tpu.")]
assert not bad, bad
print("atmosphere ok")
"""


def test_subprocess_atmosphere_imports_only_the_port(case, socket_timeout):
    c = case
    ep = coupler.OasisEndpoint(("127.0.0.1", 0))
    try:
        drv = coupler.CplDriver(c.tmesh, ep)
        for _, (ts, ti) in _steps(c, 2):
            drv.collect(ts, ti)
        drv.send()
        res = subprocess.run(
            [sys.executable, "-c", ATMOSPHERE, "127.0.0.1",
             str(ep.address[1]), str(c.tmesh.n_nodes)], cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
            text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        assert ep.get("done", timeout=10.0) is not None
        atm, stresses = drv.recv()
        rng = np.random.default_rng(0)
        sst_mean = float(ep.get("sst_feom").mean())
        want = {k: rng.normal(size=c.tmesh.n_nodes) + sst_mean
                for k in coupler.RECV_FIELDS_ECHAM}
        assert torch.equal(atm.oce_heat_flux, t(want["heat_oce"]))
        assert torch.equal(stresses["stress_atmice_y"], t(want["tauy_ico"]))
    finally:
        ep.close()
    assert threading.active_count() < 20
