"""The port's KPP (``fesom2_tpu_torch/core/mixing/kpp.py``) against the
JAX package's, on the level-3 globe with 20 layers (partial cells,
varying depth): T/S from ``globe_fixtures``, seeded node velocities, the
JAX ``pressure_bv`` for N^2 and the surface buoyancy difference.  Every
output agrees to 1e-10 of its largest JAX magnitude (float64, CPU), with
double diffusion off and on.  On the CPU ``kpp_column`` runs
``kpp_column_plain`` and launches no kernel.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fesom2_tpu.core import eos as jeos
from fesom2_tpu.core.mixing import kpp as jkpp
from fesom2_tpu.core.state import (allocate_state as jalloc,
                                   init_thickness_linfs as jinit,
                                   initial_z3d as jz3d,
                                   zero_forcing as jzero_forcing)
from fesom2_tpu.mesh import build_mesh as jax_build_mesh

from fesom2_tpu_torch import kernels
from fesom2_tpu_torch.convert import (forcing_from_numpy, state_from_numpy,
                                      to_numpy)
from fesom2_tpu_torch.core.mixing import kpp
from fesom2_tpu_torch.mesh import build_mesh, globe
from fesom2_tpu_torch.model import pi_config

TOL = 1e-10
PC = dict(force_rotation=True, cyclic_length_deg=360.0,
          use_partial_cell=True, partial_cell_thresh=0.0)


class Case:
    """The JAX and the port side of one column state."""


def _port(obj, conv):
    return conv({f.name: np.asarray(getattr(obj, f.name))
                 for f in dataclasses.fields(obj)}, "cpu")


def column_case(tmp_path_factory, n_layers=20, dz_bottom=600.0, seed=5):
    """A state on the level-3 globe whose KPP has boundary layers deeper
    than one level: T/S of the fixtures, seeded velocities, the JAX
    pressure_bv's N^2, dbsfc and mld2."""
    torch.set_num_threads(1)
    path = globe.write_globe(str(tmp_path_factory.mktemp("globe")), level=3,
                             n_layers=n_layers, dz_bottom=dz_bottom)
    c = Case()
    c.cfg = pi_config()
    c.cfg.run.use_ice = False
    c.jmesh = jax_build_mesh(path, **PC)
    c.tmesh = build_mesh(path, device="cpu", **PC)
    m = c.jmesh
    fx = globe.globe_fixtures(np.asarray(m.geo_coords[:, 1]),
                              np.asarray(m.elem_nodes), np.asarray(m.Z),
                              np.asarray(m.nlevels_node),
                              np.asarray(m.area[0]), seed=seed)
    rng = np.random.default_rng(seed)
    wet = np.asarray(m.node_layer_mask)
    uv = rng.uniform(-0.3, 0.3, (2,) + wet.shape) * wet
    js = jinit(jalloc(m, 2, jnp.float64, with_gm=True), m)
    _, Z3 = jz3d(m, jnp.float64)
    dref = jeos.reference_density(m, Z3, 1)
    js = dataclasses.replace(js, tr=jnp.asarray(np.stack([fx["T"], fx["S"]])),
                             unode=jnp.asarray(uv[0]),
                             vnode=jnp.asarray(uv[1]))
    c.js = jeos.pressure_bv(js, m, c.cfg, dref)
    c.ts = _port(c.js, state_from_numpy)
    jf = jzero_forcing(m)
    c.jf = dataclasses.replace(jf, **{
        k: jnp.asarray(fx[k]) for k in ("stress_x", "stress_y", "heat_flux",
                                        "water_flux")})
    c.tf = _port(c.jf, forcing_from_numpy)
    return c


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return column_case(tmp_path_factory)


def assert_close(port, ref, name, tol=TOL):
    ref = np.asarray(ref)
    got = to_numpy(port)
    assert got.shape == ref.shape, name
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{name}: {err:.3e} of {scale:.3e}"


def test_guard_eps():
    assert kpp.guard_eps(torch.float64) == jkpp.guard_eps(jnp.float64)
    assert kpp.guard_eps(torch.float32) == jkpp.guard_eps(jnp.float32)
    assert kpp.guard_eps(torch.float32) == 1e-30


def test_wscale():
    rng = np.random.default_rng(0)
    zehat = rng.uniform(-2e-5, 1e-5, (6, 500))
    us = np.concatenate([rng.uniform(0.0, 0.03, (6, 499)),
                         np.zeros((6, 1))], 1)
    jw = jax.jit(jkpp._wscale)(jnp.asarray(zehat), jnp.asarray(us))
    tw = kpp._wscale(torch.tensor(zehat), torch.tensor(us))
    for name, a, b in zip(("wm", "ws"), tw, jw):
        assert_close(a, b, name)


def test_ri_iwmix(case):
    c = case
    jv, jd = jax.jit(lambda s: jkpp._ri_iwmix(s, c.jmesh, c.cfg))(c.js)
    tv, td = kpp._ri_iwmix(c.ts.unode, c.ts.vnode, c.ts.bvfreq, c.ts.Z_3d,
                           c.tmesh.nlevels_node.long(), c.cfg)
    assert_close(tv, jv, "viscA")
    assert_close(td, jd, "diffK")


def test_ddmix(case):
    c = case
    _, jd = jkpp._ri_iwmix(c.js, c.jmesh, c.cfg)
    ja, jb = jeos.sw_alpha_beta(c.js.tr[0], c.js.tr[1], c.js.Z_3d)
    jT, jS = jkpp._ddmix(jd, ja, jb, c.js, c.jmesh)
    tT, tS = kpp._ddmix(torch.tensor(np.asarray(jd)),
                        torch.tensor(np.asarray(ja)),
                        torch.tensor(np.asarray(jb)), c.ts.tr[0], c.ts.tr[1],
                        c.tmesh.nlevels_node.long())
    assert_close(tT, jT, "diffK_T")
    assert_close(tS, jS, "diffK_S")
    # salt fingering or diffusive convection somewhere
    assert float(np.abs(np.asarray(jS) - np.asarray(jd)).max()) > 0.0


@pytest.mark.parametrize("double_diffusion", [False, True])
def test_oce_mixing_kpp(case, double_diffusion):
    c = case
    cfg = pi_config()
    cfg.run.use_ice = False
    cfg.tra.double_diffusion = double_diffusion
    js = jax.jit(lambda s, f: jkpp.oce_mixing_kpp(s, c.jmesh, cfg, f))(
        c.js, c.jf)
    kernels.reset_launches()
    ts = kpp.oce_mixing_kpp(c.ts, c.tmesh, cfg, c.tf)
    assert kernels.LAUNCHES["kpp_column"] == 0
    names = ("Av", "Kv", "kpp_nonloc") + (("Kv_s",) if double_diffusion
                                          else ())
    for name in names:
        assert_close(getattr(ts, name), getattr(js, name), name)
    # the boundary layer is deeper than one level in some columns, and the
    # nonlocal term is live there
    nonloc = to_numpy(ts.kpp_nonloc)
    assert (nonloc > 0.0).sum() > 10
    assert ((nonloc[2:] > 0.0).any(0)).sum() > 5


def test_kpp_column_plain_is_the_cpu_path(case):
    c = case
    cfg = c.cfg
    s = c.ts
    args = (s.unode, s.vnode, s.bvfreq, s.dbsfc, s.zbar_3d, s.Z_3d, s.hnode,
            torch.full_like(s.eta, 0.01), torch.full_like(s.eta, -1e-8),
            c.tmesh.coriolis_node, c.tmesh.nlevels_node, cfg)
    got = kpp.kpp_column(*args)
    want = kpp.kpp_column_plain(*args)
    assert got[2] is None and want[2] is None
    for g, w in zip(got, want):
        if w is not None:
            assert torch.equal(g, w)
