"""The port's GM/Redi (``fesom2_tpu_torch/core/gm_redi.py``) and
``ale.bolus_wvel`` against the JAX package's, on the column state of
``tests/test_torch_kpp.py`` (level-3 globe, 20 layers, partial cells,
the CI configuration's GM values with K_GM_rampmax = K_GM_rampmin = -1):
every output to 1e-10 of its largest JAX magnitude (float64, CPU).
"""
import jax
import numpy as np
import pytest
import torch

from fesom2_tpu.core import ale as jale, gm_redi as jgm

from fesom2_tpu_torch.core import ale, gm_redi

from test_torch_kpp import assert_close, column_case


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    c = column_case(tmp_path_factory, seed=11)
    m = c.jmesh
    # the JAX chain once, compiled; its intermediate fields feed the
    # port's functions one by one
    c.jsig = jax.jit(lambda s: jgm.compute_sigma_xy(s, m))(c.js)
    c.jns, c.jtaper = jax.jit(
        lambda sg, bv: jgm.compute_neutral_slope(sg, bv, m))(c.jsig,
                                                            c.js.bvfreq)
    c.jfer = jax.jit(lambda s, ns: jgm.init_redi_gm(s, m, c.cfg, ns))(
        c.js, c.jns)
    c.jgamma = jax.jit(lambda s, sg, fc, fk: jgm.fer_solve_gamma(
        s, m, sg, fc, fk))(c.js, c.jsig, c.jfer[0], c.jfer[1])
    c.juv = jax.jit(lambda g, s: jgm.fer_gamma2vel(g, s, m))(c.jgamma, c.js)
    return c


def t(x):
    return torch.tensor(np.asarray(x))


def test_node_min_levels(case):
    c = case
    assert np.array_equal(ale._nlevels_node_min(c.tmesh).numpy(),
                          np.asarray(jgm._node_min_levels(c.jmesh)))


def test_compute_sigma_xy(case):
    c = case
    assert_close(gm_redi.compute_sigma_xy(c.ts, c.tmesh), c.jsig, "sigma_xy")


def test_compute_neutral_slope(case):
    c = case
    ns, taper = gm_redi.compute_neutral_slope(t(c.jsig), c.ts.bvfreq, c.tmesh)
    assert_close(ns, c.jns, "neutral_slope")
    assert_close(taper, c.jtaper, "tapered")
    assert float(taper[2].max()) > 0.0


def test_init_redi_gm(case):
    c = case
    assert c.cfg.dyn.K_GM_rampmax == c.cfg.dyn.K_GM_rampmin == -1.0
    out = gm_redi.init_redi_gm(c.ts, c.tmesh, c.cfg, t(c.jns))
    for name, a, b in zip(("fer_c", "fer_K", "Ki"), out, c.jfer):
        assert torch.isfinite(a).all(), name
        assert_close(a, b, name)


def test_fer_solve_gamma(case):
    c = case
    gamma = gm_redi.fer_solve_gamma(c.ts, c.tmesh, t(c.jsig), t(c.jfer[0]),
                                    t(c.jfer[1]))
    assert_close(gamma, c.jgamma, "gamma")
    assert float(gamma.abs().max()) > 0.0


def test_fer_gamma2vel_and_bolus_wvel(case):
    c = case
    uv = gm_redi.fer_gamma2vel(t(c.jgamma), c.ts, c.tmesh)
    for name, a, b in zip(("fer_u", "fer_v"), uv, c.juv):
        assert_close(a, b, name)
    jw = jax.jit(lambda u, v, s: jale.bolus_wvel(u, v, s, c.jmesh))(
        c.juv[0], c.juv[1], c.js)
    assert_close(ale.bolus_wvel(t(c.juv[0]), t(c.juv[1]), c.ts, c.tmesh), jw,
                 "fer_w")
