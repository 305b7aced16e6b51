"""The port's Icepack modules (``fesom2_tpu_torch/ice/icepack``) against the
JAX package's, function by function, on 200 seeded columns (CPU, float64,
within 1e-12 of max|JAX| unless stated), and the data flow of the two
hand-written kernels of the slice.

* constants and ``IcepackConfig``: the port's copies value for value and
  field for field, with the derived layouts (bounds, aux-tracer stacks);
* every function of state, itd, shortwave, thermo_vertical, thermo_itd,
  ridge, ponds, dedd, fsd, bgc and the driver's tracer packing;
  ``temperature_solve`` takes JAX's sweep count (its ``while_loop``
  counted) in a case that stops at ``niter_therm``, one that stops at the
  tolerance and one that runs into the cap of 100;
* mEVP with the Icepack strength field on the whole level-3 globe and on
  its subdomain (1e-10, as ``test_torch_ice.py`` holds mEVP);
* the module-level checks of ``tests/test_icepack.py`` that need no
  reference data (conservation of the remap, rebin, cleanup, ridging and
  thickness changes, the shortwave budget, the ponds), run on the port;
* a numpy walk of ``bl99_temperature_solve``'s per-thread code (column
  sweeps, the block maxima folded into each sweep's slot through the
  order-preserving bit image, the global stopping rule, the final fluxes)
  and of ``itd_remap``'s (remap and rebin on the packed state), in the
  kernels' order of operations, against the plain versions in float64
  and float32: bit for bit with torch's exp and pow (the kernel's own
  order of operations is the plain version's), within 1e-14 per sweep
  where the walk takes numpy's exp and pow;
* the ``*_work`` counters.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fesom2_tpu.ice.icepack import bgc as jbgc
from fesom2_tpu.ice.icepack import constants as jc
from fesom2_tpu.ice.icepack import dedd as jdedd
from fesom2_tpu.ice.icepack import driver as jdriver
from fesom2_tpu.ice.icepack import fsd as jfsd
from fesom2_tpu.ice.icepack import itd as jitd
from fesom2_tpu.ice.icepack import ponds as jponds
from fesom2_tpu.ice.icepack import ridge as jridge
from fesom2_tpu.ice.icepack import shortwave as jsw
from fesom2_tpu.ice.icepack import state as jstate
from fesom2_tpu.ice.icepack import thermo_itd as jti
from fesom2_tpu.ice.icepack import thermo_vertical as jtv
from fesom2_tpu.ice import evp as jevp

from fesom2_tpu_torch import kernels
from fesom2_tpu_torch.convert import to_numpy
from fesom2_tpu_torch.ice import evp
from fesom2_tpu_torch.ice.icepack import bgc, dedd, driver, fsd, itd, ponds
from fesom2_tpu_torch.ice.icepack import constants as tc
from fesom2_tpu_torch.ice.icepack import ridge, shortwave
from fesom2_tpu_torch.ice.icepack import state as tstate
from fesom2_tpu_torch.ice.icepack import thermo_itd, thermo_vertical as tv
from fesom2_tpu_torch.mesh import globe

from test_torch_kpp import assert_close

N = 200
TOL = 1e-12
AUX = dict(tr_pond_cesm=True, tr_iage=True, tr_FY=True, tr_lvl=True)
ALL = dict(AUX, tr_fsd=True, tr_bgc=True)


def J(x):
    return None if x is None else jnp.asarray(np.asarray(x))


def T(x, dtype=torch.float64):
    return None if x is None else torch.as_tensor(np.asarray(x)).to(dtype)


def close_all(got, want, names, tol=TOL):
    for g, w, n in zip(got, want, names):
        w = np.asarray(w)
        if w.size == 0:
            assert tuple(g.shape) == w.shape, n
        else:
            assert_close(g, w, n, tol=tol)


def cfgs(opts):
    return jstate.IcepackConfig(**opts), tstate.IcepackConfig(**opts)


def rand_state(ipc, seed=0, n=N, spill=True):
    """A numpy Icepack state on ``n`` columns: about a quarter of the
    categories empty, thicknesses inside their bounds (``spill``: 15 % of
    them pushed out by up to 60 %), cold profiles, random aux tracers."""
    rng = np.random.default_rng(seed)
    ncat, ni, ns = ipc.ncat, ipc.nilyr, ipc.nslyr
    hb = ipc.hin_max
    a = rng.uniform(0.0, 1.0, (ncat, n)) * (rng.random((ncat, n)) > 0.25)
    a *= rng.uniform(0.2, 1.0, n) / np.maximum(a.sum(0), 1e-3)
    h = np.stack([rng.uniform(hb[k] + 0.01, min(hb[k + 1], hb[k] + 2.0), n)
                  for k in range(ncat)])
    if spill:
        h *= np.where(rng.random((ncat, n)) < 0.15,
                      rng.uniform(0.4, 1.6, (ncat, n)), 1.0)
    has = a > 0
    sal = jstate.salinity_profile(ni)
    Tin = np.minimum(rng.uniform(-25.0, -0.3, (ncat, ni, n)),
                     (-jc.mu_liq * sal)[None, :, None] - 0.01)
    qin = np.asarray(jstate.enthalpy_ice(J(Tin), J(sal)[None, :, None]))
    qsn = np.asarray(jstate.enthalpy_snow(J(rng.uniform(-25.0, -0.3,
                                                      (ncat, ns, n)))))
    ka, kv = len(ipc.area_tracers), len(ipc.vol_tracers)
    return dict(
        aicen=a, vicen=a * h, vsnon=a * rng.uniform(0.0, 0.4, (ncat, n)),
        Tsfcn=np.where(has, rng.uniform(-30.0, 0.0, (ncat, n)), 0.0),
        qin=np.where(has[:, None], qin, 0.0),
        qsn=np.where(has[:, None], qsn, 0.0),
        ta=rng.uniform(0.0, 1.0, (ncat, ka, n)) * has[:, None],
        tv=rng.uniform(0.0, 2.0, (ncat, kv, n)) * has[:, None])


STATE = ("aicen", "vicen", "vsnon", "Tsfcn", "qin", "qsn")
STATE8 = STATE + ("ta", "tv")


# --------------------------------------------------------------------------
# constants and configuration
# --------------------------------------------------------------------------
def _values(module):
    return {k: v for k, v in vars(module).items()
            if not k.startswith("_") and isinstance(v, (int, float))}


def test_constants_equal_value_for_value():
    ref, got = _values(jc), _values(tc)
    assert ref and set(got) == set(ref)
    for name, value in ref.items():
        assert got[name] == value and type(got[name]) is type(value), name
    for mod_j, mod_t, names in (
            (jtv, tv, ("Ch_ice", "Ce_ice")), (jridge, ridge,
                                              ("gravit", "fsnowrdg")),
            (jdriver, driver, ("h_ml",)),
            (jbgc, bgc, ("BGC_NAMES", "N_BGC", "sk_l", "pv_mol", "pv_grow",
                         "pv_melt")),
            (jdedd, dedd, ("BAND_FRAC", "IOPS", "H_SSL_SNOW", "H_SSL_ICE",
                           "ALB_OCN_BAND"))):
        for n in names:
            assert getattr(mod_t, n) == getattr(mod_j, n), n
    assert np.array_equal(fsd.FSD_BOUNDS_12, jfsd.FSD_BOUNDS_12)


def test_config_has_the_same_fields_and_defaults():
    rf = dataclasses.fields(jstate.IcepackConfig)
    gf = dataclasses.fields(tstate.IcepackConfig)
    assert [f.name for f in gf] == [f.name for f in rf]
    assert [str(f.type) for f in gf] == [str(f.type) for f in rf]
    j, t = cfgs({})
    for f in rf:
        assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert type(getattr(t, f.name)) is type(getattr(j, f.name)), f.name


@pytest.mark.parametrize("opts", [
    {}, AUX, dict(tr_fsd=True), dict(tr_bgc=True), ALL,
    dict(ALL, nfsd=7, ncat=3, kcatbound=0), dict(tr_lvl=True, tr_iage=True)])
def test_config_derived_layout(opts):
    j, t = cfgs(opts)
    assert np.array_equal(t.hin_max, j.hin_max)
    for name in ("area_tracers", "vol_tracers", "ta_ridge_keep",
                 "tv_ridge_keep", "has_aux"):
        assert getattr(t, name) == getattr(j, name), name
    if j.tr_fsd:
        assert t.fsd_slice == j.fsd_slice and t.fsd_i0 == j.fsd_i0
        assert np.array_equal(t.fsd_lims, j.fsd_lims)
    if j.tr_bgc:
        assert t.bgc_slice == j.bgc_slice
    for n in j.area_tracers:
        assert t.ta_index(n) == j.ta_index(n)
    for n in j.vol_tracers:
        assert t.tv_index(n) == j.tv_index(n)


@pytest.mark.parametrize("ncat,kcat", [(5, 1), (5, 0), (3, 1), (7, 0)])
def test_category_bounds(ncat, kcat):
    got = itd.category_bounds(ncat, kcat)
    assert np.array_equal(got, jitd.category_bounds(ncat, kcat))
    if (ncat, kcat) == (5, 1):
        assert np.allclose(got[:5], [0.0, 0.6, 1.4, 2.4, 3.6])


# --------------------------------------------------------------------------
# state, itd, shortwave
# --------------------------------------------------------------------------
def test_state_functions():
    for ni in (4, 7):
        assert np.array_equal(tstate.salinity_profile(ni),
                              jstate.salinity_profile(ni))
        assert np.array_equal(tstate.melt_temps(ni), jstate.melt_temps(ni))
    rng = np.random.default_rng(1)
    S = jstate.salinity_profile(4)[:, None]
    Tt = rng.uniform(-30.0, -0.2, (4, N))
    q = rng.uniform(-3.4e8, -1e8, (4, N))
    assert_close(tstate.enthalpy_ice(T(Tt), T(S)),
                 jstate.enthalpy_ice(J(Tt), J(S)), "enthalpy_ice")
    assert_close(tstate.enthalpy_snow(T(Tt)), jstate.enthalpy_snow(J(Tt)),
                 "enthalpy_snow")
    assert_close(tstate.temperature_ice(T(q), T(S)),
                 jstate.temperature_ice(J(q), J(S)), "temperature_ice")
    assert_close(tstate.temperature_snow(T(q * 0.3)),
                 jstate.temperature_snow(J(q * 0.3)), "temperature_snow")


@pytest.mark.parametrize("aux", [False, True])
def test_itd_functions(aux):
    j, t = cfgs(ALL if aux else {})
    s = rand_state(j, seed=2)
    r = rand_state(j, seed=3, spill=False)
    close_all(itd.aggregate(*(T(s[k]) for k in STATE[:3])),
              jitd.aggregate(*(J(s[k]) for k in STATE[:3])),
              ("aice", "vice", "vsno"))
    assert_close(itd.aggregate_tsfc(T(s["aicen"]), T(s["Tsfcn"])),
                 jitd.aggregate_tsfc(J(s["aicen"]), J(s["Tsfcn"])), "tsfc")
    kw_t = dict(ta=T(s["ta"]), tv=T(s["tv"])) if aux else {}
    kw_j = dict(ta=J(s["ta"]), tv=J(s["tv"])) if aux else {}
    names = STATE8 if aux else STATE
    # the remap after growth: r is the state before the thermodynamics
    got = itd.linear_itd(T(r["aicen"]), T(r["vicen"]),
                         *(T(s[k]) for k in STATE), j.hin_max, **kw_t)
    want = jitd.linear_itd(J(r["aicen"]), J(r["vicen"]),
                           *(J(s[k]) for k in STATE), j.hin_max, **kw_j)
    close_all(got, want, names)
    got = itd.rebin(*(T(s[k]) for k in STATE), j.hin_max, **kw_t)
    want = jitd.rebin(*(J(s[k]) for k in STATE), j.hin_max, **kw_j)
    close_all(got, want, names)
    assert float(np.abs(np.asarray(want[0]) - s["aicen"]).max()) > 1e-3
    small = dict(s, aicen=np.where(s["aicen"] < 0.05, 1e-12, s["aicen"]))
    small["aicen"][:, :20] *= 3.0             # a total area above 1
    got = itd.cleanup_itd(*(T(small[k]) for k in STATE), 900.0, **kw_t)
    want = jitd.cleanup_itd(*(J(small[k]) for k in STATE), 900.0, **kw_j)
    close_all(got, want, names + ("dfresh", "dfsalt", "dfhocn"))


def test_ccsm3_shortwave():
    j, t = cfgs({})
    s = rand_state(j, seed=4)
    rng = np.random.default_rng(4)
    hi = s["vicen"] / np.maximum(s["aicen"], 1e-11)
    hs = s["vsnon"] / np.maximum(s["aicen"], 1e-11)
    Tsf = rng.uniform(-5.0, 0.0, hi.shape)
    fsw = rng.uniform(0.0, 400.0, N)
    close_all(shortwave.ccsm3_shortwave(t, T(hi), T(hs), T(Tsf), T(fsw)),
              jsw.ccsm3_shortwave(j, J(hi), J(hs), J(Tsf), J(fsw)),
              ("albedo", "fswsfc", "iabs", "fswthru"))


# --------------------------------------------------------------------------
# thermo_vertical
# --------------------------------------------------------------------------
def column_inputs(seed=5, ncat=5, n=N):
    """Seeded inputs of the temperature solve: thin to thick ice with and
    without snow, a warm and a cold atmosphere (some columns melt)."""
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, shape=(ncat, n): rng.uniform(lo, hi, shape)
    hi = u(0.0, 4.0) * (rng.random((ncat, n)) > 0.1)
    hs = u(0.0, 0.5) * (rng.random((ncat, n)) > 0.3)
    return dict(hi=hi, hs=hs, Tsf0=u(-30.0, -0.1),
                Tsn0=u(-30.0, -1.0, (ncat, 4, n)),
                Tin0=u(-25.0, -2.0, (ncat, 4, n)),
                fswsfc=u(0.0, 300.0), iabs=u(0.0, 10.0, (ncat, 4, n)),
                flw=u(150.0, 330.0, (n,)), Tair=u(-30.0, 6.0, (n,)),
                shum=u(2e-4, 5e-3, (n,)), wind=u(1.0, 12.0, (n,)),
                Tbot=u(-1.9, -1.7, (n,)))


COLS = ("hi", "hs", "Tsf0", "Tsn0", "Tin0", "fswsfc", "iabs", "flw", "Tair",
        "shum", "wind", "Tbot")
SOL = ("Tsf", "Tsn", "Tin", "melting", "fsurf", "fcondtop", "fcondbot",
       "fsens", "flat", "flwout")


def test_surface_fluxes_conductivity_and_boundary_coeffs():
    x = column_inputs()
    args = ("fswsfc", "flw", "Tair", "shum", "wind")
    shc, lhc = tv.atmo_boundary_coeffs(T(x["Tsf0"]), T(x["Tair"]),
                                       T(x["shum"]), T(x["wind"]))
    jshc, jlhc = jtv.atmo_boundary_coeffs(J(x["Tsf0"]), J(x["Tair"]),
                                          J(x["shum"]), J(x["wind"]))
    close_all((shc, lhc), (jshc, jlhc), ("shcoef", "lhcoef"))
    for coeffs in ((None, None), (shc, lhc)):
        jco = (None, None) if coeffs[0] is None else (jshc, jlhc)
        close_all(tv.surface_fluxes(T(x["Tsf0"]), *(T(x[k]) for k in args),
                                    0.95, *coeffs),
                  jtv.surface_fluxes(J(x["Tsf0"]), *(J(x[k]) for k in args),
                                     0.95, *jco),
                  ("fsurf", "dfsurf", "fsens", "flat", "flwout"))
    S = jstate.salinity_profile(4)[None, :, None]
    for conduct in ("bubbly", "MU71"):
        assert_close(tv.conductivity_ice(T(x["Tin0"]), T(S), conduct),
                     jtv.conductivity_ice(J(x["Tin0"]), J(S), conduct),
                     conduct)


def jax_solve_counted(monkeypatch, ipc, x, coeffs=None):
    """JAX's temperature_solve, eagerly, with the sweeps its while_loop
    took."""
    counts = []
    orig = jax.lax.while_loop

    def counted(cond, body, init):
        out = orig(cond, body, init)
        counts.append(int(out[0]))
        return out
    monkeypatch.setattr(jax.lax, "while_loop", counted)
    ni = ipc.nilyr
    sol = jtv.temperature_solve(
        ipc, *(J(x[k]) for k in COLS), 900.0, jstate.salinity_profile(ni),
        jstate.melt_temps(ni), *(coeffs or (None, None)))
    monkeypatch.setattr(jax.lax, "while_loop", orig)
    return sol, counts[0]


@pytest.mark.parametrize("case,niter_therm,expect", [
    ("stops at niter_therm", 30, lambda n: n == 30),
    ("stops at the tolerance", 1, lambda n: 1 < n < 100),
    ("runs into the cap", 150, lambda n: n == 100),
    ("similarity coefficients, MU71", 4, lambda n: 4 <= n < 100)])
def test_temperature_solve_matches_jax_with_its_sweep_count(
        monkeypatch, case, niter_therm, expect):
    opts = dict(niter_therm=niter_therm)
    if case.startswith("similarity"):
        opts.update(conduct="MU71", atmbndy="similarity")
    j, t = cfgs(opts)
    x = column_inputs()
    coeffs = jcoeffs = None
    if case.startswith("similarity"):
        coeffs = tv.atmo_boundary_coeffs(T(x["Tsf0"]), T(x["Tair"]),
                                         T(x["shum"]), T(x["wind"]))
        jcoeffs = tuple(J(to_numpy(c)) for c in coeffs)
    want, n_jax = jax_solve_counted(monkeypatch, j, x, jcoeffs)
    got = tv.temperature_solve(t, *(T(x[k]) for k in COLS), 900.0,
                               tstate.salinity_profile(4),
                               tstate.melt_temps(4), *(coeffs or (None,
                                                                  None)))
    assert int(got["niter"]) == n_jax and expect(n_jax), (n_jax, case)
    assert torch.equal(got["melting"], torch.as_tensor(np.array(
        want["melting"])))
    assert bool(got["melting"].any()) and not bool(got["melting"].all())
    close_all([got[k] for k in SOL if k != "melting"],
              [want[k] for k in SOL if k != "melting"],
              [k for k in SOL if k != "melting"])


def test_thickness_changes():
    j, t = cfgs({})
    x = column_inputs(seed=6)
    rng = np.random.default_rng(6)
    sal = jstate.salinity_profile(4)
    sol = tv.temperature_solve(t, *(T(x[k]) for k in COLS), 3600.0, sal,
                               tstate.melt_temps(4))
    jsol = {k: J(to_numpy(v)) for k, v in sol.items()}
    S = sal[None, :, None]
    qi = tstate.enthalpy_ice(sol["Tin"], T(S))
    qs = tstate.enthalpy_snow(sol["Tsn"])
    fbot = rng.uniform(-20.0, 80.0, N)
    snow = rng.uniform(0.0, 1e-7, N)
    got = tv.thickness_changes(t, T(x["hi"]), T(x["hs"]), qi, qs, sol["Tsf"],
                               sol, T(fbot), T(x["Tbot"]), T(snow),
                               T(x["Tair"]), 3600.0, sal)
    want = jtv.thickness_changes(j, J(x["hi"]), J(x["hs"]), J(to_numpy(qi)),
                                 J(to_numpy(qs)), jsol["Tsf"], jsol, J(fbot),
                                 J(x["Tbot"]), J(snow), J(x["Tair"]), 3600.0,
                                 sal)
    assert set(got) == set(want)
    close_all([got[k] for k in want], [want[k] for k in want], list(want))
    assert float(got["meltt"].max()) > 0 and float(got["congel"].max()) > 0


# --------------------------------------------------------------------------
# thermo_itd, ridge
# --------------------------------------------------------------------------
def test_add_new_ice_and_lateral_melt():
    j, t = cfgs({})
    s = rand_state(j, seed=7)
    rng = np.random.default_rng(7)
    frz = rng.uniform(-50.0, 200.0, N)
    Tf = rng.uniform(-1.95, -1.7, N)
    sst = Tf + rng.uniform(0.0, 3.0, N)
    pot = rng.uniform(0.0, 300.0, N)
    close_all(thermo_itd.add_new_ice(t, *(T(s[k]) for k in STATE), T(frz),
                                     T(Tf), 900.0),
              jti.add_new_ice(j, *(J(s[k]) for k in STATE), J(frz), J(Tf),
                              900.0), STATE + ("vi0new", "fhocn"))
    scale = rng.uniform(0.5, 2.0, (5, N))
    for sc in (None, scale):
        close_all(thermo_itd.lateral_melt(t, *(T(s[k]) for k in STATE),
                                          T(sst), T(Tf), T(pot), 900.0,
                                          rside_scale=T(sc)),
                  jti.lateral_melt(j, *(J(s[k]) for k in STATE), J(sst),
                                   J(Tf), J(pot), 900.0, rside_scale=J(sc)),
                  STATE + ("dfresh", "dfsalt", "dfhocn"))


@pytest.mark.parametrize("kstrength", [0, 1])
def test_ice_strength(kstrength):
    j, t = cfgs(dict(kstrength=kstrength))
    s = rand_state(j, seed=8)
    assert_close(ridge.ice_strength(t, T(s["aicen"]), T(s["vicen"])),
                 jridge.ice_strength(j, J(s["aicen"]), J(s["vicen"])),
                 "strength")


@pytest.mark.parametrize("aux", [False, True])
def test_ridge_ice(aux):
    j, t = cfgs(ALL if aux else {})
    s = rand_state(j, seed=9)
    rng = np.random.default_rng(9)
    conv = rng.uniform(0.0, 2e-6, N)
    shear = rng.uniform(0.0, 1e-6, N)
    kw_t = dict(ta=T(s["ta"]), tv=T(s["tv"])) if aux else {}
    kw_j = dict(ta=J(s["ta"]), tv=J(s["tv"])) if aux else {}
    close_all(ridge.ridge_ice(t, *(T(s[k]) for k in STATE), T(conv),
                              T(shear), 3600.0, j.hin_max, **kw_t),
              jridge.ridge_ice(j, *(J(s[k]) for k in STATE), J(conv),
                               J(shear), 3600.0, j.hin_max, **kw_j),
              (STATE8 if aux else STATE) + ("dfresh", "dfhocn"))


# --------------------------------------------------------------------------
# ponds, dedd, fsd, bgc
# --------------------------------------------------------------------------
def test_ponds():
    j, t = cfgs(ALL)
    s = rand_state(j, seed=10)
    rng = np.random.default_rng(10)
    u = lambda lo, hi: rng.uniform(lo, hi, (5, N))
    meltt, melts, apnd, hpnd = u(0, 0.05), u(0, 0.05), u(0, 0.5), u(0, 0.3)
    Tsf = u(-6.0, 0.0)
    close_all(ponds.compute_ponds_cesm(t, T(s["aicen"]), T(s["vicen"]),
                                       T(Tsf), T(meltt), T(melts), T(apnd),
                                       T(hpnd)),
              jponds.compute_ponds_cesm(j, J(s["aicen"]), J(s["vicen"]),
                                        J(Tsf), J(meltt), J(melts), J(apnd),
                                        J(hpnd)), ("apnd", "hpnd"))
    assert_close(ponds.advance_age(T(apnd), T(s["aicen"]), 900.0),
                 jponds.advance_age(J(apnd), J(s["aicen"]), 900.0), "age")
    lat = rng.uniform(-1.5, 1.5, N)
    for yday in (258.2, 74.0, 100.0):
        for day in (yday, torch.tensor(yday, dtype=torch.float64)):
            assert_close(ponds.reset_first_year(T(apnd), T(lat), day),
                         jponds.reset_first_year(J(apnd), J(lat),
                                                 jnp.asarray(yday)), "FY")
    a2 = s["aicen"] * 1.2
    v2 = s["vicen"] * 1.1
    close_all(ponds.dilute_on_new_ice(t, T(s["ta"]), T(s["tv"]),
                                      T(s["aicen"]), T(a2), T(s["vicen"]),
                                      T(v2)),
              jponds.dilute_on_new_ice(j, J(s["ta"]), J(s["tv"]),
                                       J(s["aicen"]), J(a2), J(s["vicen"]),
                                       J(v2)), ("ta", "tv"))
    alb, fsfc, sw = u(0.3, 0.8), u(0.0, 200.0), rng.uniform(0, 300.0, N)
    hs = s["vsnon"] / np.maximum(s["aicen"], 1e-11)
    close_all(ponds.pond_albedo_adjust(t, T(alb), T(fsfc), T(apnd),
                                       T(hpnd), T(hs), T(sw)),
              jponds.pond_albedo_adjust(j, J(alb), J(fsfc), J(apnd),
                                        J(hpnd), J(hs), J(sw)),
              ("albedo", "fswsfc"))


@pytest.mark.parametrize("with_ponds", [False, True])
def test_dedd_shortwave(with_ponds):
    j, t = cfgs(dict(shortwave="dEdd"))
    s = rand_state(j, seed=11)
    rng = np.random.default_rng(11)
    hi = s["vicen"] / np.maximum(s["aicen"], 1e-11)
    hs = s["vsnon"] / np.maximum(s["aicen"], 1e-11)
    Tsf = rng.uniform(-5.0, 0.0, hi.shape)
    fsw = rng.uniform(0.0, 400.0, N)
    pond = (rng.uniform(0, 0.6, hi.shape), rng.uniform(0, 0.4, hi.shape)) \
        if with_ponds else (None, None)
    close_all(dedd.dedd_shortwave(t, T(hi), T(hs), T(Tsf), T(fsw),
                                  *(T(p) for p in pond)),
              jdedd.dedd_shortwave(j, J(hi), J(hs), J(Tsf), J(fsw),
                                   *(J(p) for p in pond)),
              ("albedo", "fswsfc", "iabs", "fswthru"))


def test_fsd_functions():
    j, t = cfgs(dict(tr_fsd=True))
    lims = j.fsd_lims
    for n in (12, 7):
        assert np.array_equal(fsd.fsd_bounds(n), jfsd.fsd_bounds(n))
    assert np.array_equal(fsd._weld_targets(lims), jfsd._weld_targets(lims))
    s = rand_state(j, seed=12)
    rng = np.random.default_rng(12)
    afsd = rng.uniform(0.0, 1.0, (5, 12, N)) * (rng.random((5, 1, N)) > 0.1)
    a, v = s["aicen"], s["vicen"]
    assert_close(fsd.afsd_normalize(T(afsd), T(a)),
                 jfsd.afsd_normalize(J(afsd), J(a)), "normalize")
    dr = rng.uniform(-3.0, 3.0, (5, N))
    assert_close(fsd.fsd_radial_evolve(T(afsd), T(dr), lims),
                 jfsd.fsd_radial_evolve(J(afsd), J(dr), lims), "evolve")
    frz = rng.random(N) > 0.5
    assert_close(fsd.fsd_weld(T(afsd), T(a), torch.as_tensor(frz), 900.0,
                              5e-7, lims),
                 jfsd.fsd_weld(J(afsd), J(a), J(frz), 900.0, 5e-7, lims),
                 "weld")
    assert_close(fsd.fsd_lateral_melt_scale(T(afsd), lims),
                 jfsd.fsd_lateral_melt_scale(J(afsd), lims), "scale")
    assert_close(fsd.fsd_mean_radius(T(afsd), T(a), lims),
                 jfsd.fsd_mean_radius(J(afsd), J(a), lims), "radius")
    dv = rng.uniform(0.0, 1e-6, N) * (rng.random(N) > 0.3)
    assert_close(fsd.fsd_radial_growth_rate(t, T(afsd), T(a), T(v), T(dv),
                                            900.0, lims),
                 jfsd.fsd_radial_growth_rate(j, J(afsd), J(a), J(v), J(dv),
                                             900.0, lims), "growth")


def test_bgc_step():
    j, t = cfgs(dict(tr_bgc=True))
    s = rand_state(j, seed=13)
    rng = np.random.default_rng(13)
    u = lambda lo, hi: rng.uniform(lo, hi, (5, N))
    args = (u(0.0, 5.0), u(0.0, 20.0), u(0.0, 30.0))
    rest = (s["aicen"], s["vicen"], u(0.0, 50.0), u(-1e-6, 1e-6))
    Tb = rng.uniform(-1.9, -1.7, N)
    close_all(bgc.skl_bgc_step(t, *(T(x) for x in args + rest), T(Tb), 900.0),
              jbgc.skl_bgc_step(j, *(J(x) for x in args + rest), J(Tb),
                                900.0),
              ("algN", "NO3", "Sil", "flux_N", "flux_NO3", "flux_Sil"))
    assert bgc.bgc_defaults(t) == jbgc.bgc_defaults(j)


# --------------------------------------------------------------------------
# the driver's tracer stack, the packed remap
# --------------------------------------------------------------------------
@pytest.mark.parametrize("opts", [{}, ALL])
def test_pack_and_unpack_tracers(opts):
    j, t = cfgs(opts)
    s = rand_state(j, seed=14)
    aux = j.has_aux
    tst = tstate.IcepackState(**{k: T(v) for k, v in s.items()
                                 if aux or k not in ("ta", "tv")})
    jst = jstate.IcepackState(**{k: J(v) for k, v in s.items()
                                 if aux or k not in ("ta", "tv")})
    work = driver._pack_tracers(tst, t)
    jwork = jdriver._pack_tracers(jst, j)
    assert_close(work, jwork, "work")
    rng = np.random.default_rng(14)
    noisy = to_numpy(work) * rng.uniform(0.9, 1.1, work.shape)
    got = driver._unpack_tracers(T(noisy), t)
    want = jdriver._unpack_tracers(J(noisy), j)
    names = STATE8 if aux else STATE
    close_all([getattr(got, k) for k in names],
              [getattr(want, k) for k in names], names)


@pytest.mark.parametrize("linear", [True, False])
def test_itd_remap_on_the_cpu_is_the_plain_remap_and_rebin(linear):
    """The eight category tensors in, a fresh pack out (``pack_itd``'s
    layout, whose views ``unpack_itd`` hands back), the inputs untouched,
    no launch."""
    j, t = cfgs(ALL)
    s = rand_state(j, seed=15)
    r = rand_state(j, seed=16, spill=False)
    st = [T(s[k]) for k in STATE8]
    pack = itd.pack_itd(*st)
    assert pack.shape == (5, 4 + 4 + 4 + len(j.area_tracers)
                          + len(j.vol_tracers), N)
    back = itd.unpack_itd(pack, 4, 4, len(j.area_tracers))
    assert all(torch.equal(a, b) for a, b in zip(back, st))
    kept = [x.clone() for x in st]
    kernels.reset_launches()
    got = itd.itd_remap(*st, T(r["aicen"]), T(r["vicen"]), j.hin_max,
                        linear)
    assert kernels.LAUNCHES["itd_remap"] == 0
    assert got.shape == pack.shape
    assert all(torch.equal(a, b) for a, b in zip(st, kept))
    assert all(got.untyped_storage().data_ptr()
               != x.untyped_storage().data_ptr() for x in st)
    ka = len(j.area_tracers)
    want = st
    if linear:
        want = itd.linear_itd(T(r["aicen"]), T(r["vicen"]), *want[:6],
                              j.hin_max, ta=want[6], tv=want[7])
    want = itd.rebin(*want[:6], j.hin_max, ta=want[6], tv=want[7])
    assert all(torch.equal(a, b) for a, b in zip(
        itd.unpack_itd(got, 4, 4, ka), want))


# --------------------------------------------------------------------------
# mEVP with the strength field
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def case(tmp_path_factory):
    from test_torch_ice import ice_case
    return ice_case(globe.write_globe(
        str(tmp_path_factory.mktemp("globe")), level=3, n_layers=12,
        dz_bottom=1000.0))


@pytest.mark.parametrize("where", ["whole mesh", "subdomain"])
def test_mevp_with_the_icepack_strength(case, where):
    from test_torch_ice import assert_ice_close, subcycle_config
    c = case
    cfg = subcycle_config(8)
    rng = np.random.default_rng(17)
    strength = np.where(np.asarray(c.jice.a_ice) > 0,
                        rng.uniform(0.0, 3e4, c.tmesh.n_nodes), 0.0)
    sub_t, sub_j = (None, None) if where == "whole mesh" else (c.tsub, c.jsub)
    want = jevp.ice_dynamics(c.jice, c.jmesh, c.jforcing, c.jsurf, cfg,
                             strength_node=J(strength), sub=sub_j)
    got = evp.ice_dynamics(c.tice, c.tmesh, c.tforcing, c.tsurf, cfg,
                           strength_node=T(strength), sub=sub_t)
    assert_ice_close(got, want)
    plain = evp.ice_dynamics(c.tice, c.tmesh, c.tforcing, c.tsurf, cfg,
                             sub=sub_t)
    assert float((got.sigma11 - plain.sigma11).abs().max()) > 1.0
    tab = evp.mevp_setup(c.tice, c.tmesh, c.tforcing, c.tsurf, cfg,
                         strength_node=T(strength))
    en = c.tmesh.elem_nodes.long()
    pe = T(strength)[en].mean(-1)
    det2 = 1.0 / (1.0 + cfg.ice.alpha_evp)
    assert torch.equal(tab.elem_c[7], torch.where(tab.elem_c[9] > 0,
                                                  det2 * pe, 0.0))
    # standard and adaptive EVP drop the field, as the JAX package does
    for which in (0, 2):
        cfg.ice.whichEVP = which
        a = evp.ice_dynamics(c.tice, c.tmesh, c.tforcing, c.tsurf, cfg,
                             strength_node=T(strength), sub=sub_t)
        b = evp.ice_dynamics(c.tice, c.tmesh, c.tforcing, c.tsurf, cfg,
                             sub=sub_t)
        assert torch.equal(a.u_ice, b.u_ice)


# --------------------------------------------------------------------------
# the JAX package's module checks (tests/test_icepack.py) on the port
# --------------------------------------------------------------------------
def _remap_conserves(t):
    s = {k: T(v) for k, v in rand_state(t, seed=20, spill=False).items()}
    v2 = s["vicen"] * 1.2
    a2, w2, vs2, t2, qi2, qs2 = itd.linear_itd(
        s["aicen"], s["vicen"], s["aicen"], v2, s["vsnon"], s["Tsfcn"],
        s["qin"], s["qsn"], t.hin_max)
    assert torch.allclose(a2.sum(0), s["aicen"].sum(0), atol=1e-13)
    assert torch.allclose(w2.sum(0), v2.sum(0), rtol=1e-12)
    assert torch.allclose(vs2.sum(0), s["vsnon"].sum(0), rtol=1e-12)
    E0 = (s["qin"] * (v2 / 4)[:, None]).sum((0, 1))
    E1 = (qi2 * (w2 / 4)[:, None]).sum((0, 1))
    assert torch.allclose(E0, E1, rtol=1e-10)
    assert float((a2 - s["aicen"]).abs().max()) > 1e-6


def _rebin_restores_bounds(t):
    s = {k: T(v) for k, v in rand_state(t, seed=21).items()}
    out = itd.rebin(s["aicen"], s["vicen"] * 3.0, s["vsnon"], s["Tsfcn"],
                    s["qin"], s["qsn"], t.hin_max)
    a2, v2 = out[0].numpy(), out[1].numpy()
    hic = np.where(a2 > tc.puny, v2 / np.maximum(a2, tc.puny), 0.0)
    for n in range(t.ncat):
        ok = a2[n] > tc.puny
        assert (hic[n][ok] <= t.hin_max[n + 1] + 1e-9).all()
        assert (hic[n][ok] >= t.hin_max[n] - 1e-9).all()
    assert np.allclose(v2.sum(0), 3.0 * s["vicen"].sum(0).numpy(),
                       rtol=1e-12)


def _cleanup_returns_fluxes(t):
    s = {k: T(v) for k, v in rand_state(t, seed=22).items()}
    tiny = s["aicen"].clone()
    tiny[2] = 1e-13
    out = itd.cleanup_itd(tiny, s["vicen"], s["vsnon"], s["Tsfcn"], s["qin"],
                          s["qsn"], 900.0)
    assert float(out[0][2].max()) == 0.0
    mask = s["vicen"][2] > 0
    assert bool((out[6][mask] > 0).all()) and bool((out[8][mask] < 0).all())


def _shortwave_budget_closes(t):
    hi = T(np.linspace(0.05, 4.0, 8))[None]
    hs = T(np.linspace(0.0, 0.4, 8))[None]
    alb, fsfc, iabs, thru = shortwave.ccsm3_shortwave(
        t, hi, hs, torch.full((1, 8), -3.0, dtype=torch.float64),
        torch.full((8,), 250.0, dtype=torch.float64))
    assert torch.allclose(fsfc + iabs.sum(1) + thru, (1 - alb) * 250.0,
                          rtol=1e-12)


def _temperature_solve_conserves_energy(t):
    sal, Tm = tstate.salinity_profile(4), tstate.melt_temps(4)
    f = lambda *v: torch.tensor(v, dtype=torch.float64)
    hi = torch.full((1, 3), 2.0, dtype=torch.float64)
    hs = f([0.2, 0.0, 0.2])
    Tin0 = T(np.linspace(-15, -3, 4))[None, :, None].expand(1, 4, 3)
    Tin0 = Tin0.contiguous()
    Tsn0 = torch.full((1, 4, 3), -18.0, dtype=torch.float64)
    sol = tv.temperature_solve(
        t, hi, hs, torch.full((1, 3), -20.0, dtype=torch.float64), Tsn0,
        Tin0, f([0.0, 0.0, 300.0]), torch.zeros((1, 4, 3),
                                                  dtype=torch.float64),
        f(150.0, 150.0, 320.0), f(-25.0, -25.0, 5.0), f(2e-4, 2e-4, 4e-3),
        torch.full((3,), 5.0, dtype=torch.float64),
        torch.full((3,), -1.8, dtype=torch.float64), 900.0, sal, Tm)
    assert bool(sol["melting"][0, 2]) and not bool(sol["melting"][0, 0])
    S = T(sal)[None, :, None]
    dE = ((tstate.enthalpy_ice(sol["Tin"], S)
           - tstate.enthalpy_ice(Tin0, S)) * (hi / 4)[:, None]).sum(1) \
        + ((tstate.enthalpy_snow(sol["Tsn"]) - tstate.enthalpy_snow(Tsn0))
           * (torch.clamp_min(hs, 1e-4) / 4)[:, None]).sum(1) * (hs >= 1e-4)
    expect = 900.0 * (sol["fcondtop"] + sol["fcondbot"])
    rel = (dE - expect).abs() / torch.clamp_min(expect.abs(), 1.0)
    assert float(rel.max()) < 1e-6


def _ridging_conserves_volume(t):
    s = {k: T(v) for k, v in rand_state(t, seed=23).items()}
    conv = torch.full((N,), 1e-6, dtype=torch.float64)
    out = ridge.ridge_ice(t, *(s[k] for k in STATE), conv, conv * 0.5,
                          3600.0, t.hin_max)
    assert torch.allclose(out[1].sum(0), s["vicen"].sum(0), rtol=1e-10)
    assert bool((out[0].sum(0) <= s["aicen"].sum(0) + 1e-12).all())
    ds = s["vsnon"].sum(0) - out[2].sum(0)
    assert torch.allclose(ds, out[6] * 3600.0 / tc.rhos, rtol=1e-9)
    assert bool((out[7] <= 1e-15).all())


def _aux_conserved_through_itd(t):
    s = {k: T(v) for k, v in rand_state(t, seed=24, spill=False).items()}
    v2 = s["vicen"] * 1.3
    out = itd.linear_itd(s["aicen"], s["vicen"], s["aicen"], v2, s["vsnon"],
                         s["Tsfcn"], s["qin"], s["qsn"], t.hin_max,
                         ta=s["ta"], tv=s["tv"])
    A0 = (s["ta"] * s["aicen"][:, None]).sum(0)
    A1 = (out[6] * out[0][:, None]).sum(0)
    V0 = (s["tv"] * v2[:, None]).sum(0)
    V1 = (out[7] * out[1][:, None]).sum(0)
    assert torch.allclose(A0, A1, rtol=1e-10) and torch.allclose(V0, V1,
                                                                 rtol=1e-10)


def _ridging_destroys_ponds_keeps_fy(t):
    s = {k: T(v) for k, v in rand_state(t, seed=25).items()}
    conv = torch.full((N,), 1e-6, dtype=torch.float64)
    out = ridge.ridge_ice(t, *(s[k] for k in STATE), conv, conv * 0.5,
                          3600.0, t.hin_max, ta=s["ta"], tv=s["tv"])
    ia, jf = t.ta_index("apnd"), t.ta_index("FY")
    pond0 = (s["ta"][:, ia] * s["aicen"]).sum(0)
    pond1 = (out[6][:, ia] * out[0]).sum(0)
    fy0 = (s["ta"][:, jf] * s["aicen"]).sum(0)
    fy1 = (out[6][:, jf] * out[0]).sum(0)
    assert bool((pond1 <= pond0 + 1e-12).all()) and float(
        (pond0 - pond1).max()) > 0
    # FY area follows the ice: lost only with the area ridging removes
    assert float((fy1 - fy0).max()) <= 1e-12


def _ponds_grow_melt_and_refreeze(t):
    f = lambda v: torch.full((5, 4), v, dtype=torch.float64)
    a, vi = f(0.18), f(0.18 * 1.5)
    warm = ponds.compute_ponds_cesm(t, a, vi, f(0.0), f(0.02), f(0.01),
                                    f(0.0), f(0.0))
    assert float(warm[0].min()) > 0 and float(warm[1].min()) > 0
    cold = ponds.compute_ponds_cesm(t, a, vi, f(-10.0), f(0.0), f(0.0),
                                    *warm)
    assert bool(((cold[0] * cold[1]) < (warm[0] * warm[1])).all())


MODULE_CHECKS = {
    "remap_conserves": (_remap_conserves, {}),
    "rebin_restores_bounds": (_rebin_restores_bounds, {}),
    "cleanup_returns_fluxes": (_cleanup_returns_fluxes, {}),
    "shortwave_budget_closes": (_shortwave_budget_closes, {}),
    "temperature_solve_conserves_energy": (
        _temperature_solve_conserves_energy, {}),
    "ridging_conserves_volume": (_ridging_conserves_volume, {}),
    "aux_conserved_through_itd": (_aux_conserved_through_itd, AUX),
    "ridging_destroys_ponds_keeps_fy": (_ridging_destroys_ponds_keeps_fy,
                                        AUX),
    "ponds_grow_melt_and_refreeze": (_ponds_grow_melt_and_refreeze, AUX),
}


@pytest.mark.parametrize("name", list(MODULE_CHECKS))
def test_jax_module_checks_hold_for_the_port(name):
    fn, opts = MODULE_CHECKS[name]
    fn(tstate.IcepackConfig(**opts))


# --------------------------------------------------------------------------
# the kernels' data flow, walked in numpy
# --------------------------------------------------------------------------
def walk_itd_remap(pack, a_init, v_init, hin_max, nilyr, nslyr, ka, linear):
    """itd_remap's per-thread code, one node a lane (numpy, vectorised over
    the nodes), in the kernel's order of operations; returns the pack."""
    p = pack.copy()
    dt = p.dtype.type
    ncat, rows, _ = p.shape
    puny = dt(1e-11)
    hb = [dt(h) for h in hin_max]
    cmax = lambda x, lo: np.where(x < lo, lo, x)
    thick = lambda a, v: np.where(a > puny, v / cmax(a, puny), dt(0))

    def mix(dst, w, src, dw):
        wt = w + dw
        return np.where(wt > puny, (dst * w + src * dw) / cmax(wt, puny),
                        dst)

    def transfer(cn, cm, da, dv):
        a_n, v_n, vs_n = p[cn, 0].copy(), p[cn, 1].copy(), p[cn, 2].copy()
        a_m, v_m, vs_m = p[cm, 0].copy(), p[cm, 1].copy(), p[cm, 2].copy()
        da = np.minimum(cmax(da, dt(0)), a_n * dt(1.0 - 1e-11))
        dv = np.minimum(cmax(dv, dt(0)), v_n * dt(1.0 - 1e-11))
        ok = (a_n > puny) & (v_n > puny)
        da = np.where(ok, da, dt(0))
        dv = np.where(ok, dv, dt(0))
        fa = da / cmax(a_n, puny)
        dvs = vs_n * fa
        p[cm, 3] = mix(p[cm, 3], a_m, p[cn, 3], da)
        r = 4
        for w, d, cnt in ((v_m, dv, nilyr), (vs_m, dvs, nslyr),
                          (a_m, da, ka), (v_m, dv, rows - 4 - nilyr - nslyr
                                          - ka)):
            for _ in range(cnt):
                p[cm, r] = mix(p[cm, r], w, p[cn, r], d)
                r += 1
        p[cn, 0], p[cn, 1], p[cn, 2] = a_n - da, v_n - dv, vs_n - dvs
        p[cm, 0], p[cm, 1], p[cm, 2] = a_m + da, v_m + dv, vs_m + dvs

    if linear:
        h_init = [thick(a_init[n], v_init[n]) for n in range(ncat)]
        h_now = [thick(p[n, 0], p[n, 1]) for n in range(ncat)]
        has = [a_init[n] > puny for n in range(ncat)]
        dh = [np.where(has[n] & (p[n, 0] > puny), h_now[n] - h_init[n],
                       dt(0)) for n in range(ncat)]
        hbnew = [np.zeros_like(p[0, 0])] + [None] * (ncat - 1) \
            + [np.full_like(p[0, 0], dt(hin_max[ncat]))]
        for n in range(1, ncat):
            lo, hi = n - 1, n
            dspan = h_init[hi] - h_init[lo]
            big = np.abs(dspan) > puny
            slope = np.where(big, (dh[hi] - dh[lo])
                             / np.where(big, dspan, dt(1)), dt(0))
            disp_both = dh[lo] + slope * (hb[n] - h_init[lo])
            disp = np.where(has[lo] & has[hi], disp_both,
                            np.where(has[lo], dh[lo],
                                     np.where(has[hi], dh[hi], dt(0))))
            hbnew[n] = np.minimum(np.maximum(
                hb[n] + disp, hb[n - 1] * dt(1.0 + 1e-11) + puny),
                hb[n + 1] * dt(1.0 - 1e-11))
        fits = []
        for n in range(ncat):
            a, hice, hL, hR = p[n, 0].copy(), h_now[n], hbnew[n], hbnew[n + 1]
            eta, w = hice - hL, hR - hL
            hR = np.where(eta < w * dt(1.0 / 3.0), hL + dt(3) * eta, hR)
            hL = np.where(eta > (dt(2) * w) * dt(1.0 / 3.0),
                          hR - dt(3) * (hR - hice), hL)
            w, eta = hR - hL, hice - hL
            ok = (a > puny) & (w > puny)
            ws = cmax(w, puny)
            g0 = np.where(ok, (a / ws) * (dt(4) - (dt(6) * eta) / ws), dt(0))
            g1 = np.where(ok, ((dt(6) * a) / (ws * ws))
                          * ((dt(2) * eta) / ws - dt(1)), dt(0))
            fits.append((g0, g1, hL, hR))

        def integrate(f, x0, x1):
            g0, g1, hL, hR = f
            e0 = np.minimum(np.maximum(x0, hL), hR) - hL
            e1 = np.minimum(np.maximum(x1, hL), hR) - hL
            e1 = np.maximum(e1, e0)
            d2 = e1 * e1 - e0 * e0
            da = g0 * (e1 - e0) + (dt(0.5) * g1) * d2
            dv = (hL * da + (dt(0.5) * g0) * d2) \
                + (g1 * ((e1 * e1) * e1 - (e0 * e0) * e0)) * dt(1.0 / 3.0)
            return cmax(da, dt(0)), cmax(dv, dt(0))

        for n in range(1, ncat):
            up = hbnew[n] > hb[n]
            da_up, dv_up = integrate(fits[n - 1], hb[n], hbnew[n])
            da_dn, dv_dn = integrate(fits[n], hbnew[n], hb[n])
            transfer(n - 1, n, np.where(up, da_up, dt(0)),
                     np.where(up, dv_up, dt(0)))
            transfer(n, n - 1, np.where(up, dt(0), da_dn),
                     np.where(up, dt(0), dv_dn))
    for n in range(ncat - 1):
        move = thick(p[n, 0], p[n, 1]) > hb[n + 1]
        transfer(n, n + 1, np.where(move, p[n, 0], dt(0)),
                 np.where(move, p[n, 1], dt(0)))
    for n in range(ncat - 1, 0, -1):
        move = thick(p[n, 0], p[n, 1]) < hb[n]
        transfer(n, n - 1, np.where(move, p[n, 0], dt(0)),
                 np.where(move, p[n, 1], dt(0)))
    return p


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("opts", [{}, ALL])
@pytest.mark.parametrize("linear", [True, False])
def test_itd_remap_kernel_data_flow_equals_the_plain_version(dtype, opts,
                                                             linear):
    j, t = cfgs(opts)
    s = rand_state(j, seed=30)
    r = rand_state(j, seed=31, spill=False)
    ka = len(t.area_tracers)
    cats = [T(s[k], dtype) for k in STATE8]
    pack = itd.pack_itd(*cats)
    a0, v0 = T(r["aicen"], dtype), T(r["vicen"], dtype)
    want = itd.itd_remap_plain(*cats, a0, v0, t.hin_max, linear)
    got = walk_itd_remap(pack.numpy(), a0.numpy(), v0.numpy(), t.hin_max, 4,
                         4, ka, linear)
    assert np.array_equal(got, want.numpy())
    assert float((want - pack).abs().max()) > 1e-3


def _itd_constants(dtype):
    """kWarps and the rows held at once (kHeld64 or kHeld32) of
    csrc/itd_remap.cu for ``dtype``."""
    import re
    from fesom2_tpu_torch.kernels import build
    src = (build.SRC_DIR / "itd_remap.cu").read_text()
    held = "kHeld64" if dtype == torch.float64 else "kHeld32"
    return tuple(int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                 for k in ("kWarps", held))


def walk_itd_remap_lanes(cats, a_init, v_init, hin_max, linear, warps,
                         held):
    """itd_remap's data flow (csrc/itd_remap.cu) in numpy, vectorised over
    the nodes: warp 0's chain of each node (a lane) writes rows a, v, vs
    and leaves each transfer's six numbers (the receiver's old a, v, vs and
    the moved da, dv, dvs); the row warps 1 .. warps - 1 (warp 0 alone when
    warps is 1) then take rows 3 and up in the kernel's order, ``held`` at
    a time with their ncat values, and apply each transfer's mix in the
    chain's order.  Every value of the pack is written once.  A warp of 32
    nodes whose categories all hold at most puny of area walks its
    transfers with amounts of 0, no division and no init arrays (here NaN
    in their place); a warp where no mix can change a value copies its
    rows.  Returns the pack and the nodes of both kinds of warp."""
    aicen, vicen, vsnon, Tsfcn, qin, qsn, ta, tv = cats
    dt = aicen.dtype.type
    ncat, n = aicen.shape
    puny = dt(1e-11)
    hb = [dt(h) for h in hin_max]
    cmax = lambda x, lo: np.where(x < lo, lo, x)
    thick = lambda a_, v_: np.where(a_ > puny, v_ / cmax(a_, puny), dt(0))
    warp_all = lambda x: np.repeat(np.pad(x, (0, -n % 32), constant_values=True)
                                   .reshape(-1, 32).all(1), 32)[:n]
    idle = warp_all((aicen <= puny).all(0))
    a_init = np.where(idle, dt(np.nan), a_init)
    v_init = np.where(idle, dt(np.nan), v_init)
    a, v, vs = aicen.copy(), vicen.copy(), vsnon.copy()
    prm, pairs = [], []
    still = np.ones(n, bool)

    def transfer(cn, cm, da, dv):
        nonlocal still
        a_n, v_n, vs_n = a[cn].copy(), v[cn].copy(), vs[cn].copy()
        a_m, v_m, vs_m = a[cm].copy(), v[cm].copy(), vs[cm].copy()
        da = np.where(idle, dt(0), da)
        dv = np.where(idle, dt(0), dv)
        da = np.minimum(cmax(da, dt(0)), a_n * dt(1.0 - 1e-11))
        dv = np.minimum(cmax(dv, dt(0)), v_n * dt(1.0 - 1e-11))
        ok = (a_n > puny) & (v_n > puny)
        da = np.where(ok, da, dt(0))
        dv = np.where(ok, dv, dt(0))
        dvs = vs_n * np.where(idle, da, da / cmax(a_n, puny))
        prm.append((a_m, v_m, vs_m, da, dv, dvs))
        pairs.append((cn, cm))
        still = still & ~(a_m + da > puny) & ~(v_m + dv > puny) \
            & ~(vs_m + dvs > puny)
        a[cn], v[cn], vs[cn] = a_n - da, v_n - dv, vs_n - dvs
        a[cm], v[cm], vs[cm] = a_m + da, v_m + dv, vs_m + dvs

    if linear:
        h_init = [thick(a_init[c], v_init[c]) for c in range(ncat)]
        h_now = [thick(a[c], v[c]) for c in range(ncat)]
        has = [a_init[c] > puny for c in range(ncat)]
        dh = [np.where(has[c] & (a[c] > puny), h_now[c] - h_init[c], dt(0))
              for c in range(ncat)]
        hbnew = [np.zeros(n, aicen.dtype)] + [None] * (ncat - 1) \
            + [np.full(n, hb[ncat])]
        for c in range(1, ncat):
            lo, hi = c - 1, c
            dspan = h_init[hi] - h_init[lo]
            big = np.abs(dspan) > puny
            slope = np.where(big, (dh[hi] - dh[lo])
                             / np.where(big, dspan, dt(1)), dt(0))
            disp = np.where(has[lo] & has[hi],
                            dh[lo] + slope * (hb[c] - h_init[lo]),
                            np.where(has[lo], dh[lo],
                                     np.where(has[hi], dh[hi], dt(0))))
            hbnew[c] = np.minimum(np.maximum(
                hb[c] + disp, hb[c - 1] * dt(1.0 + 1e-11) + puny),
                hb[c + 1] * dt(1.0 - 1e-11))
        fits = []
        for c in range(ncat):
            hice, hL, hR = h_now[c], hbnew[c], hbnew[c + 1]
            eta, w = hice - hL, hR - hL
            hR = np.where(eta < w * dt(1.0 / 3.0), hL + dt(3) * eta, hR)
            hL = np.where(eta > (dt(2) * w) * dt(1.0 / 3.0),
                          hR - dt(3) * (hR - hice), hL)
            w, eta = hR - hL, hice - hL
            ok = (a[c] > puny) & (w > puny)
            ws = cmax(w, puny)
            fits.append((
                np.where(ok, (a[c] / ws) * (dt(4) - (dt(6) * eta) / ws),
                         dt(0)),
                np.where(ok, ((dt(6) * a[c]) / (ws * ws))
                         * ((dt(2) * eta) / ws - dt(1)), dt(0)), hL, hR))

        def integrate(f, x0, x1):
            g0, g1, hL, hR = f
            e0 = np.minimum(np.maximum(x0, hL), hR) - hL
            e1 = np.maximum(np.minimum(np.maximum(x1, hL), hR) - hL, e0)
            d2 = e1 * e1 - e0 * e0
            da = g0 * (e1 - e0) + (dt(0.5) * g1) * d2
            dv = (hL * da + (dt(0.5) * g0) * d2) \
                + (g1 * ((e1 * e1) * e1 - (e0 * e0) * e0)) * dt(1.0 / 3.0)
            return cmax(da, dt(0)), cmax(dv, dt(0))

        for c in range(1, ncat):
            up = hbnew[c] > hb[c]
            da_up, dv_up = integrate(fits[c - 1], hb[c], hbnew[c])
            da_dn, dv_dn = integrate(fits[c], hbnew[c], hb[c])
            transfer(c - 1, c, np.where(up, da_up, dt(0)),
                     np.where(up, dv_up, dt(0)))
            transfer(c, c - 1, np.where(up, dt(0), da_dn),
                     np.where(up, dt(0), dv_dn))
    for c in range(ncat - 1):
        move = thick(a[c], v[c]) > hb[c + 1]
        transfer(c, c + 1, np.where(move, a[c], dt(0)),
                 np.where(move, v[c], dt(0)))
    for c in range(ncat - 1, 0, -1):
        move = thick(a[c], v[c]) < hb[c]
        transfer(c, c - 1, np.where(move, a[c], dt(0)),
                 np.where(move, v[c], dt(0)))

    # rows 3 and up: (source [ncat, N], weight 0 area, 1 volume, 2 snow)
    src = [(Tsfcn, 0)] + [(x[:, j], kind) for x, kind in
                          ((qin, 1), (qsn, 2), (ta, 0), (tv, 1))
                          for j in range(x.shape[1])]
    out = np.full((ncat, 3 + len(src), n), np.nan, aicen.dtype)
    written = np.zeros(out.shape[:2], int)
    out[:, 0], out[:, 1], out[:, 2] = a, v, vs
    written[:, :3] += 1
    copy = warp_all(still)
    row_warps = warps - 1 if warps > 1 else 1
    for rw in range(row_warps):
        for first in range(rw, len(src), row_warps * held):
            mine = [r for r in range(first, first + held * row_warps,
                                     row_warps) if r < len(src)]
            val = {r: [src[r][0][c].copy() for c in range(ncat)]
                   for r in mine}
            for (cn, cm), p in zip(pairs, prm):
                for r in mine:
                    k = src[r][1]
                    w, dw = p[k], p[3 + k]
                    wt = w + dw
                    val[r][cm] = np.where(
                        wt > puny, (val[r][cm] * w + val[r][cn] * dw)
                        / cmax(wt, puny), val[r][cm])
            for r in mine:
                out[:, 3 + r] = np.where(copy, src[r][0], np.stack(val[r]))
                written[:, 3 + r] += 1
    assert (written == 1).all()
    return out, idle, copy


ITD_LAYOUTS = ["kernel", "warps 1", "warps 2, held 1", "warps 8, held 4"]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("opts", [{}, ALL])
@pytest.mark.parametrize("linear", [True, False])
@pytest.mark.parametrize("layout", ITD_LAYOUTS)
def test_itd_remap_chain_and_rows_walk_equals_the_plain_version(
        dtype, opts, linear, layout):
    """The kernel's chain-and-rows data flow bitwise against
    ``itd_remap_plain`` (NaN where it has NaN), on seeded columns with a
    NaN in one row of a few nodes and nodes where every transfer moves 0,
    at the kernel's layout (kWarps, and kHeld64 or kHeld32) and at others
    (the layout moves no bit); the walk within 1e-12 (float64) and 1e-5 (float32) of
    max|JAX| of JAX's ``linear_itd`` and ``rebin`` in the same dtype
    (measured: 2e-7 in float32)."""
    warps, held = {"kernel": _itd_constants(dtype), "warps 1": (1, 3),
                   "warps 2, held 1": (2, 1),
                   "warps 8, held 4": (8, 4)}[layout]
    j, t = cfgs(opts)
    s = rand_state(j, seed=32)
    r = rand_state(j, seed=33, spill=False)
    # nodes 0-9: the state before the thermodynamics is the state, so no
    # boundary moves; nodes 10-14 hold no ice at all: transfers of 0
    for k in STATE8:
        s[k][..., 10:15] = 0.0
    r["aicen"][:, :10], r["vicen"][:, :10] = s["aicen"][:, :10], \
        s["vicen"][:, :10]
    s["qin"][2, 1, 20:23] = np.nan              # a NaN in one row
    # whole warps (32 nodes) without ice: 32-63 empty; 64-95 with area of
    # 0, -0 or under puny beside volumes, snow and tracers (the idle chain,
    # but mixes that change values); 96-127 with -0 areas, surface
    # temperatures and growth since the init arrays (idle, rows copied);
    # 128-159 empty but for a NaN area (the full chain); a warp with ice
    # anywhere walks the full chain
    for k in STATE8:
        s[k][..., 32:64] = 0.0
        s[k][..., 96:160] = 0.0
    s["aicen"][:, 64:96] = np.array([0.0, -0.0, 1e-12, 5e-12])[
        np.arange(32) % 4]
    s["aicen"][:, 96:128] = -0.0
    s["Tsfcn"][:, 96:128] = -5.0
    s["aicen"][3, 140] = np.nan
    # 160-191: thin ice, every area under 0.04 (the full chain)
    for k in ("aicen", "vicen", "vsnon"):
        s[k][:, 160:192] *= 0.04
    cats = [T(s[k], dtype) for k in STATE8]
    a0, v0 = T(r["aicen"], dtype), T(r["vicen"], dtype)
    want = itd.itd_remap_plain(*cats, a0, v0, t.hin_max, linear).numpy()
    got, idle, copy = walk_itd_remap_lanes(
        [x.numpy() for x in cats], a0.numpy(), v0.numpy(), t.hin_max, linear,
        warps, held)
    assert np.array_equal(got, want, equal_nan=True)
    assert idle[32:128].all() and not idle[:32].any() \
        and not idle[128:192].any()
    assert copy[32:64].all() and copy[96:128].all() and not copy[64:96].any()
    assert np.isnan(want[:, 3:]).any() and np.isnan(want[:, :3]).any()
    assert np.nanmax(np.abs(want[:, 0] - s["aicen"])) > 1e-3
    # JAX in the same dtype
    Jd = lambda x: jnp.asarray(np.asarray(x, want.dtype))
    kw = dict(ta=Jd(s["ta"]), tv=Jd(s["tv"]))
    jst = (*(Jd(s[k]) for k in STATE),)
    if linear:
        jst = jitd.linear_itd(Jd(r["aicen"]), Jd(r["vicen"]), *jst,
                              j.hin_max, **kw)
        kw = dict(ta=jst[6], tv=jst[7])
    ref = itd.pack_itd(*(torch.as_tensor(np.array(x)) for x in jitd.rebin(
        *jst[:6], j.hin_max, **kw))).numpy()
    assert ref.dtype == want.dtype
    ok = np.isfinite(ref).all(axis=(0, 1)) & np.isfinite(want).all(axis=(0, 1))
    assert np.array_equal(np.isnan(ref), np.isnan(want))
    assert_close(got[..., ok], ref[..., ok], "pack",
                 tol=TOL if dtype == torch.float64 else 1e-5)


def _ulp_pow_exp(xp):
    """exp and pow on numpy arrays: torch's CPU functions (as the plain
    version calls them) or numpy's."""
    if xp == "torch":
        return (lambda x: torch.exp(torch.from_numpy(x)).numpy(),
                lambda x, e: torch.pow(torch.from_numpy(x), e).numpy())
    return np.exp, np.power


def walk_bl99(cfg, x, dt_s, sal, Tmlt, dtype, xp="torch", shcoef=None,
              lhcoef=None, block=256, grid=3):
    """bl99_temperature_solve's per-thread code (numpy, a lane per column,
    columns walked by ``grid`` blocks of ``block`` threads as the kernel's
    grid-stride loop assigns them), the block maxima folded into each
    sweep's slot through the order-preserving bit image, the stopping rule
    read back from the slot: returns (outputs, sweeps, slots)."""
    npdt = np.float64 if dtype == torch.float64 else np.float32
    Tc = npdt
    exp, pw = _ulp_pow_exp(xp)
    ncat, n = x["hi"].shape
    ni, ns = cfg.nilyr, cfg.nslyr
    g = lambda k: np.asarray(x[k], npdt)
    hi, hs, Tsf0, fsw = g("hi"), g("hs"), g("Tsf0"), g("fswsfc")
    Tsn0, Tin0, iabs = g("Tsn0"), g("Tin0"), g("iabs")
    node = lambda k: np.broadcast_to(g(k)[None], (ncat, n))
    flw, Tair, shum, wind, Tbot = (node(k) for k in ("flw", "Tair", "shum",
                                                     "wind", "Tbot"))
    cmax = lambda v, lo: np.where(v < lo, lo, v)
    cmin = lambda v, hi_: np.where(v > hi_, hi_, v)
    emiss = cfg.emissivity
    ks = cfg.ksno
    c = tc
    sal_t = [Tc(s) for s in np.asarray(sal)]
    Tm_t = [Tc(s) for s in np.asarray(Tmlt)]
    t_floor = Tc(-1e-3 if dtype == torch.float64 else -0.05)
    dtT = Tc(dt_s)
    cs = np.asarray(shcoef, npdt) if shcoef is not None \
        else Tc(c.rhoair * c.cp_air * tv.Ch_ice) * wind
    ce = np.asarray(lhcoef, npdt) if lhcoef is not None \
        else Tc(c.rhoair * c.Lsub * tv.Ce_ice) * wind
    dzi = cmax(hi, Tc(0.01)) / Tc(ni)
    snow_on = hs >= Tc(c.hs_min)
    dzs = cmax(hs, Tc(c.hs_min)) / Tc(ns)
    cap_snow = np.where(snow_on, (Tc(c.rhos * c.cp_ice) * dzs) / dtT,
                        Tc(1e-6))

    def surface(Tsf):
        TK = Tsf + Tc(c.Tffresh)
        flwout = Tc(-emiss * c.stefan_boltzmann) * pw(TK, 4)
        dflw = Tc(-4.0 * emiss * c.stefan_boltzmann) * ((TK * TK) * TK)
        fsens = cs * (Tair - Tsf)
        qs = Tc(c.qqqice / c.rhoair) * exp(
            (Tc(1) / (Tsf + Tc(c.Tffresh))) * Tc(-c.TTTice))
        flat = ce * (shum - qs)
        dflat = (((-ce) * qs) * Tc(c.TTTice)) / (TK * TK)
        fsurf = (((fsw + Tc(emiss) * flw) + flwout) + fsens) + flat
        return fsurf, (dflw + (-cs)) + dflat, fsens, flat, flwout

    def cond(Tk, S):
        Ts = cmin(Tk, Tc(-0.01))
        if cfg.conduct == "MU71":
            k = Tc(c.kice0) + (Tc(c.beta_mu71) * S) / Ts
        else:
            k = (Tc(2.11) - Tc(0.011) * Ts) + (Tc(0.09) * S) / Ts
        return cmax(k, Tc(0.1 * c.kice0))

    def couplings(Tin):
        ki = [cond(Tin[:, k], sal_t[k]) for k in range(ni)]
        k_direct = (Tc(2) * ki[0]) / dzi
        series = Tc(ns + 1) * k_direct
        Cs = [np.where(snow_on, (Tc(1) / dzs) * Tc(2.0 * ks), series)]
        Cs += [np.where(snow_on, (Tc(1) / dzs) * Tc(ks), series)
               for _ in range(ns - 1)]
        Cs.append(np.where(snow_on, (Tc(2.0 * ks) * ki[0])
                           / (ki[0] * dzs + Tc(ks) * dzi), series))
        Cs += [((Tc(2) * ki[k]) * ki[k + 1]) / (dzi * (ki[k] + ki[k + 1]))
               for k in range(ni - 1)]
        return Cs, (Tc(2) * ki[ni - 1]) / dzi

    Tsf, Tsn, Tin = Tsf0.copy(), Tsn0.copy(), Tin0.copy()
    melting = np.zeros_like(Tsf, dtype=bool)
    fs0 = surface(np.zeros_like(Tsf))[0]
    # the grid-stride assignment of columns (col = c * N + node) to blocks
    cols = np.arange(ncat * n)
    blk = (cols % (grid * block)) // block
    slots = np.zeros(100, np.uint64)
    it, err = 0, np.inf
    with np.errstate(all="ignore"):
        while it < 100 and (err > 5e-4 or it < cfg.niter_therm):
            Cs, K_bot = couplings(Tin)
            fsurf, dfsurf = surface(Tsf)[:2]
            m = 1 + ns + ni
            sub, diag, sup, rhs = ([None] * m for _ in range(4))
            sub[0] = np.zeros_like(Tsf)
            diag[0] = np.where(melting, Tc(1), Cs[0] - dfsurf)
            sup[0] = np.where(melting, Tc(0), -Cs[0])
            rhs[0] = np.where(melting, Tc(0), fsurf - dfsurf * Tsf)
            for j in range(ns):
                r = 1 + j
                diag[r] = (cap_snow + Cs[r - 1]) + Cs[r]
                sub[r], sup[r] = -Cs[r - 1], -Cs[r]
                rhs[r] = cap_snow * Tsn0[:, j]
            for k in range(ni):
                r = 1 + ns + k
                Tprod = cmin(Tin[:, k], t_floor) * cmin(Tin0[:, k], t_floor)
                cap = Tc(c.rhoi) * (Tc(c.cp_ice)
                                    - (Tc(c.Lfresh) * Tm_t[k]) / Tprod)
                a = (cap * dzi) / dtT
                cr = K_bot if k == ni - 1 else Cs[r]
                diag[r] = (a + Cs[r - 1]) + cr
                sub[r] = -Cs[r - 1]
                rhs[r] = a * Tin0[:, k] + iabs[:, k]
                if k == ni - 1:
                    rhs[r] = rhs[r] + K_bot * Tbot
                    sup[r] = np.zeros_like(Tsf)
                else:
                    sup[r] = -cr
            sup[0] = sup[0] / diag[0]
            rhs[0] = rhs[0] / diag[0]
            for j in range(1, m):
                den = diag[j] - sub[j] * sup[j - 1]
                sup[j] = sup[j] / den
                rhs[j] = (rhs[j] - sub[j] * rhs[j - 1]) / den
            for j in range(m - 2, -1, -1):
                rhs[j] = rhs[j] - sup[j] * rhs[j + 1]
            Tsn = np.stack([cmin(cmax(rhs[1 + j], Tc(-100)), Tc(0))
                            for j in range(ns)], 1)
            Tin = np.stack([cmin(cmax(rhs[1 + ns + k], Tc(-100)),
                                 Tm_t[k] - Tc(1e-6)) for k in range(ni)], 1)
            fct0 = Cs[0] * (Tc(0) - rhs[1])
            melt_next = np.where(melting, fs0 > fct0, rhs[0] > Tc(0))
            Tsf_new = np.where(melt_next, Tc(0),
                               cmin(cmax(rhs[0], Tc(-100)), Tc(0)))
            dT = np.abs(Tsf_new - Tsf).reshape(-1)
            dT = np.where(np.isfinite(dT), dT, Tc(0))
            # each block's maximum into the sweep's slot, as atomicMax of
            # the bit image
            bits = dT.view(np.uint64 if npdt is np.float64
                           else np.uint32).astype(np.uint64)
            for b in range(grid):
                slots[it] = max(slots[it], bits[blk == b].max(initial=0))
            err = float((np.asarray([slots[it]]).astype(np.uint64).view(
                np.float64) if npdt is np.float64
                else np.asarray([slots[it]]).astype(np.uint32).view(
                    np.float32))[0])
            Tsf, melting = Tsf_new, melt_next
            it += 1
        Cs, K_bot = couplings(Tin)
        fsurf, _, fsens, flat, flwout = surface(Tsf)
    out = dict(Tsf=Tsf, Tsn=Tsn, Tin=Tin, melting=melting, fsurf=fsurf,
               fcondtop=Cs[0] * (Tsf - Tsn[:, 0]),
               fcondbot=K_bot * (Tbot - Tin[:, ni - 1]), fsens=fsens,
               flat=flat, flwout=flwout)
    return out, it, slots


def walk_bl99_chunked(cfg, x, dt_s, sal, Tmlt, dtype, xp="torch",
                      shcoef=None, lhcoef=None, block=256, grid=3, chunk=4):
    """bl99_temperature_solve's per-thread code as it stands (numpy, a lane
    per column, columns walked by ``grid`` blocks of ``block`` threads as
    the kernel's grid-stride loop assigns them): the sweeps in chunks,
    each chunk loading the inputs once and computing what no sweep changes
    (dzi, dzs, the snow capacity and couplings, cs, ce, fswsfc + emiss
    flw, the balance at Tsf = 0), then its sweeps with each row eliminated
    as it is built (only cp and dp kept); each sweep's block maxima folded
    into its slot, the stop found from the slots after the chunk, the
    iterate in two buffers, the final pass rerunning from the chunk's
    start up to the stop; the chunks' lengths as ``tv.bl99_next_chunk``
    sets them, ``chunk`` where the error's decay does not.  Returns
    (outputs, sweeps, slots, sweeps run, the chunks' lengths)."""
    npdt = np.float64 if dtype == torch.float64 else np.float32
    Tc = npdt
    exp, pw = _ulp_pow_exp(xp)
    ncat, n = x["hi"].shape
    ni, ns = cfg.nilyr, cfg.nslyr
    m = 1 + ns + ni
    g = lambda k: np.asarray(x[k], npdt)
    node = lambda k: np.broadcast_to(g(k)[None], (ncat, n))
    cmax = lambda v, lo: np.where(v < lo, lo, v)
    cmin = lambda v, hi_: np.where(v > hi_, hi_, v)
    emiss, ks, c = cfg.emissivity, cfg.ksno, tc
    t_floor = Tc(-1e-3 if dtype == torch.float64 else -0.05)
    dtT = Tc(dt_s)
    # the per-layer constants (shared memory)
    beta = Tc(c.beta_mu71) if cfg.conduct == "MU71" else Tc(0.09)
    kS = [beta * Tc(v) for v in np.asarray(sal)]
    LTm = [Tc(c.Lfresh) * Tc(v) for v in np.asarray(Tmlt)]
    Tmax = [Tc(v) - Tc(1e-6) for v in np.asarray(Tmlt)]

    def surface(Tsf, q):
        TK = Tsf + Tc(c.Tffresh)
        flwout = Tc(-emiss * c.stefan_boltzmann) * pw(TK, 4)
        dflw = Tc(-4.0 * emiss * c.stefan_boltzmann) * ((TK * TK) * TK)
        fsens = q["cs"] * (q["Tair"] - Tsf)
        qs = Tc(c.qqqice / c.rhoair) * exp(
            (Tc(1) / (Tsf + Tc(c.Tffresh))) * Tc(-c.TTTice))
        flat = q["ce"] * (q["shum"] - qs)
        dflat = (((-q["ce"]) * qs) * Tc(c.TTTice)) / (TK * TK)
        fsurf = ((q["A"] + flwout) + fsens) + flat
        return fsurf, (dflw + (-q["cs"])) + dflat, fsens, flat, flwout

    def cond(Tk, k):
        Ts = cmin(Tk, Tc(-0.01))
        if cfg.conduct == "MU71":
            kk = Tc(c.kice0) + kS[k] / Ts
        else:
            kk = (Tc(2.11) - Tc(0.011) * Ts) + kS[k] / Ts
        return cmax(kk, Tc(0.1 * c.kice0))

    def load_column():
        hi, hs = g("hi"), g("hs")
        q = dict(dzi=cmax(hi, Tc(0.01)) / Tc(ni), snow_on=hs >= Tc(c.hs_min),
                 dzs=cmax(hs, Tc(c.hs_min)) / Tc(ns), Tair=node("Tair"),
                 shum=node("shum"), Tbot=node("Tbot"))
        q["cap_snow"] = np.where(q["snow_on"],
                                 (Tc(c.rhos * c.cp_ice) * q["dzs"]) / dtT,
                                 Tc(1e-6))
        q["c_sfc_snow"] = (Tc(1) / q["dzs"]) * Tc(2.0 * ks)
        q["c_snow_snow"] = (Tc(1) / q["dzs"]) * Tc(ks)
        q["ks_dzi"] = Tc(ks) * q["dzi"]
        wind = node("wind")
        q["cs"] = np.asarray(shcoef, npdt) if shcoef is not None \
            else Tc(c.rhoair * c.cp_air * tv.Ch_ice) * wind
        q["ce"] = np.asarray(lhcoef, npdt) if lhcoef is not None \
            else Tc(c.rhoair * c.Lsub * tv.Ce_ice) * wind
        q["A"] = g("fswsfc") + Tc(emiss) * node("flw")
        q["fs0"] = surface(np.zeros_like(hi), q)[0]
        q["Tin_init"], q["iabs"] = g("Tin0"), g("iabs")
        return q

    def sweep(q, Tsf, Tin, melting):
        ki = [cond(Tin[:, k], k) for k in range(ni)]
        series = Tc(ns + 1) * ((Tc(2) * ki[0]) / q["dzi"])
        Cs0 = np.where(q["snow_on"], q["c_sfc_snow"], series)
        fsurf, dfsurf = surface(Tsf, q)[:2]
        diag = Cs0 - dfsurf
        cp = [np.where(melting, Tc(0), (-Cs0) / diag)]
        dp = [np.where(melting, Tc(0), (fsurf - dfsurf * Tsf) / diag)]
        cl = Cs0
        for j in range(ns):
            if j + 1 < ns:
                cr = np.where(q["snow_on"], q["c_snow_snow"], series)
            else:
                cr = np.where(q["snow_on"], (Tc(2.0 * ks) * ki[0])
                              / (ki[0] * q["dzs"] + q["ks_dzi"]), series)
            sub = -cl
            den = ((q["cap_snow"] + cl) + cr) - sub * cp[-1]
            cp.append((-cr) / den)
            dp.append((q["cap_snow"] * g("Tsn0")[:, j] - sub * dp[-1])
                      / den)
            cl = cr
        for k in range(ni):
            last = k == ni - 1
            cr = (Tc(2) * ki[k]) / q["dzi"] if last else \
                ((Tc(2) * ki[k]) * ki[k + 1]) / (q["dzi"] * (ki[k]
                                                           + ki[k + 1]))
            Tprod = cmin(Tin[:, k], t_floor) * cmin(q["Tin_init"][:, k],
                                                   t_floor)
            a = ((Tc(c.rhoi) * (Tc(c.cp_ice) - LTm[k] / Tprod)) * q["dzi"]) \
                / dtT
            sub = -cl
            rhs = a * q["Tin_init"][:, k] + q["iabs"][:, k]
            if last:
                rhs = rhs + cr * q["Tbot"]
            den = ((a + cl) + cr) - sub * cp[-1]
            if not last:
                cp.append((-cr) / den)
            dp.append((rhs - sub * dp[-1]) / den)
            cl = cr
        for j in range(m - 2, -1, -1):
            dp[j] = dp[j] - cp[j] * dp[j + 1]
        Tsn = np.stack([cmin(cmax(dp[1 + j], Tc(-100)), Tc(0))
                        for j in range(ns)], 1)
        Tin = np.stack([cmin(cmax(dp[1 + ns + k], Tc(-100)), Tmax[k])
                        for k in range(ni)], 1)
        fct0 = Cs0 * (Tc(0) - dp[1])
        melt_next = np.where(melting, q["fs0"] > fct0, dp[0] > Tc(0))
        Tsf_new = np.where(melt_next, Tc(0),
                           cmin(cmax(dp[0], Tc(-100)), Tc(0)))
        return Tsf_new, Tin, melt_next, Tsn, np.abs(Tsf_new - Tsf)

    cols = np.arange(ncat * n)
    blk = (cols % (grid * block)) // block
    slots = np.zeros(100, np.uint64)
    uint = np.uint64 if npdt is np.float64 else np.uint32
    bufs = {0: (g("Tsf0"), g("Tin0"), np.zeros((ncat, n), bool))}
    k0, frm, to, stop, run, lens = 0, 0, 1, -1, 0, []
    e0 = e1 = 0.0
    with np.errstate(all="ignore"):
        while True:
            ln = tv.bl99_next_chunk(k0, cfg.niter_therm, chunk, e0, e1)
            lens.append(ln)
            q = load_column()
            Tsf, Tin, melting = bufs[frm]
            for j in range(ln):
                Tsf, Tin, melting, Tsn, dT = sweep(q, Tsf, Tin, melting)
                dT = np.where(np.isfinite(dT), dT, Tc(0)).reshape(-1)
                bits = dT.view(uint).astype(np.uint64)
                for b in range(grid):
                    slots[k0 + j] = max(slots[k0 + j],
                                        bits[blk == b].max(initial=0))
            run += ln
            bufs[to], Tsn_out = (Tsf, Tin, melting), Tsn
            for j in range(ln):
                it = k0 + j + 1
                err = float(np.asarray([slots[k0 + j]]).astype(uint).view(
                    npdt)[0])
                if not (it < 100 and (err > 5e-4 or it < cfg.niter_therm)):
                    stop = k0 + j
                    break
                e0, e1 = e1, err
            if stop >= 0:
                break
            k0, frm, to = k0 + ln, to, 3 - to
        rerun = 0 if stop - k0 + 1 == ln else stop - k0 + 1
        q = load_column()
        Tsf, Tin, melting = bufs[frm if rerun else to]
        for _ in range(rerun):
            Tsf, Tin, melting, Tsn_out, _ = sweep(q, Tsf, Tin, melting)
        run += rerun
        ki0, kib = cond(Tin[:, 0], 0), cond(Tin[:, ni - 1], ni - 1)
        Cs0 = np.where(q["snow_on"], q["c_sfc_snow"],
                       Tc(ns + 1) * ((Tc(2) * ki0) / q["dzi"]))
        fsurf, _, fsens, flat, flwout = surface(Tsf, q)
        out = dict(Tsf=Tsf, Tsn=Tsn_out, Tin=Tin, melting=melting,
                   fsurf=fsurf, fcondtop=Cs0 * (Tsf - Tsn_out[:, 0]),
                   fcondbot=((Tc(2) * kib) / q["dzi"]) * (q["Tbot"]
                                                         - Tin[:, ni - 1]),
                   fsens=fsens, flat=flat, flwout=flwout)
    return out, stop + 1, slots, run, lens


BL99_CASES = [("stops at niter_therm", 30), ("stops at the tolerance", 1),
              ("runs into the cap", 150), ("MU71 with coefficients", 4)]


def _bl99_case(case, niter_therm, dtype):
    """(config, inputs, salinity, melting temperatures, coefficients as
    tensors) of a case of the walks' tests."""
    opts = dict(niter_therm=niter_therm)
    if case.startswith("MU71"):
        opts["conduct"] = "MU71"
    t = tstate.IcepackConfig(**opts)
    x = column_inputs(seed=32)
    co = (None, None)
    if case.startswith("MU71"):
        co = tv.atmo_boundary_coeffs(T(x["Tsf0"], dtype),
                                     T(x["Tair"], dtype),
                                     T(x["shum"], dtype),
                                     T(x["wind"], dtype))
    return (t, x, tstate.salinity_profile(4), tstate.melt_temps(4), co)


@pytest.mark.parametrize("design", ["chunked", "per_sweep"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case,niter_therm", BL99_CASES)
def test_bl99_kernel_data_flow_equals_the_plain_version(dtype, case,
                                                        niter_therm, design):
    """The walk with torch's exp and pow bit for bit against the plain
    version; with numpy's within 1e-14 per sweep and the same sweep
    count.  The kernel's design (``chunked``): the slots hold each sweep's
    maximum up to the end of the last chunk, zero past it.  The first
    design (``per_sweep``, one grid barrier a sweep): each sweep's maximum,
    zero past the last."""
    t, x, sal, Tm, co = _bl99_case(case, niter_therm, dtype)
    want = tv.temperature_solve_plain(t, *(T(x[k], dtype) for k in COLS),
                                      900.0, sal, Tm, *co)
    cn = [None if v is None else v.numpy() for v in co]
    if design == "chunked":
        walk = lambda xp: walk_bl99_chunked(t, x, 900.0, sal, Tm, dtype, xp,
                                            *cn)
    else:
        walk = lambda xp: walk_bl99(t, x, 900.0, sal, Tm, dtype, xp,
                                    *cn) + (None, None)
    got, it, slots, _, lens = walk("torch")
    assert it == int(want["niter"])
    end = sum(lens) if design == "chunked" else it
    assert (slots[:it] > 0).all() and (slots[end:] == 0).all()
    for k in SOL:
        assert np.array_equal(got[k], want[k].numpy()), k
    got2, it2 = walk("numpy")[:2]
    assert it2 == it
    tol = 1e-14 * it if dtype == torch.float64 else 1e-5
    for k in SOL:
        if k == "melting":
            assert np.array_equal(got2[k], want[k].numpy())
        else:
            assert_close(got2[k], want[k].numpy(), k, tol=tol)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("chunk", [1, 2, 3, 5, 8])
def test_bl99_chunk_length_changes_nothing(dtype, chunk):
    """Any length of the chunks the error's decay does not set gives the
    plain version's outputs bit for bit and its sweep count: the sweeps
    past the stop are dropped, a stop inside a chunk reruns from the
    chunk's start (never more than a chunk again)."""
    t, x, sal, Tm, co = _bl99_case("stops at the tolerance", 1, dtype)
    want = tv.temperature_solve_plain(t, *(T(x[k], dtype) for k in COLS),
                                      900.0, sal, Tm)
    got, it, slots, ran, lens = walk_bl99_chunked(t, x, 900.0, sal, Tm,
                                                  dtype, chunk=chunk)
    assert it == int(want["niter"]) > 2
    assert lens[0] == chunk and max(lens) <= 16
    assert sum(lens[:-1]) < it <= sum(lens)
    errs = slots[:sum(lens)].astype(np.uint64 if dtype == torch.float64
                                    else np.uint32).view(
        np.float64 if dtype == torch.float64 else np.float32)
    assert tv.bl99_chunks(errs, 1, chunk) == lens
    assert ran == sum(lens) + (0 if it == sum(lens) else it - sum(lens[:-1]))
    for k in SOL:
        assert np.array_equal(got[k], want[k].numpy()), k


@pytest.mark.parametrize("case,niter_therm", BL99_CASES)
def test_bl99_chunked_walk_matches_jax(monkeypatch, case, niter_therm):
    """The kernel's data flow against the JAX package's temperature_solve
    (``fesom2_tpu/ice/icepack/thermo_vertical.py:142``) run eagerly: its
    sweep count and melting flags, each output within 1e-12 of its
    largest magnitude."""
    t, x, sal, Tm, co = _bl99_case(case, niter_therm, torch.float64)
    j = jstate.IcepackConfig(**{k: getattr(t, k) for k in ("niter_therm",
                                                           "conduct")})
    jco = None if co[0] is None else tuple(J(to_numpy(v)) for v in co)
    want, n_jax = jax_solve_counted(monkeypatch, j, x, jco)
    cn = [None if v is None else v.numpy() for v in co]
    got, it = walk_bl99_chunked(t, x, 900.0, sal, Tm, torch.float64,
                                "numpy", *cn)[:2]
    assert it == n_jax
    assert np.array_equal(got["melting"], np.asarray(want["melting"]))
    close_all([got[k] for k in SOL if k != "melting"],
              [want[k] for k in SOL if k != "melting"],
              [k for k in SOL if k != "melting"])


@pytest.mark.parametrize("layers,coeffs", [((4, 4), False), ((4, 4), True),
                                           ((7, 1), False)])
def test_bl99_wrapper_passes_what_the_kernel_takes(monkeypatch, layers,
                                                   coeffs):
    """The launch path, recorded on tensors of the meta device: the C
    signature's arguments in order, null pointers for absent coefficients,
    100 error slots, the two iterate buffers (2 (2 + nilyr) ncat N
    values), the chunk length ``BL99_CHUNK``."""
    import ctypes
    ni, ns = layers
    t = tstate.IcepackConfig(nilyr=ni, nslyr=ns)
    ncat, n = 5, 37
    dev = torch.device("meta")
    shapes = dict(hi=(ncat, n), hs=(ncat, n), Tsf0=(ncat, n),
                  Tsn0=(ncat, ns, n), Tin0=(ncat, ni, n), fswsfc=(ncat, n),
                  iabs=(ncat, ni, n), flw=(n,), Tair=(n,), shum=(n,),
                  wind=(n,), Tbot=(n,))
    x = {k: torch.empty(v, dtype=torch.float32, device=dev)
         for k, v in shapes.items()}
    co = (x["hi"], x["hs"]) if coeffs else (None, None)
    calls = []

    def record(kernel, device, *a, entry=""):
        sig = kernels._ARGTYPES[kernel + entry]
        assert len(a) + 1 == len(sig)
        for v, typ in zip(a, sig):
            if typ is ctypes.c_void_p:
                assert v is None or isinstance(v, torch.Tensor)
            else:
                assert type(v) is (int if typ is ctypes.c_int else float)
        calls.append(a)

    monkeypatch.setattr(kernels, "launch", record)
    monkeypatch.setattr(kernels, "cuda_only", lambda v, what: None)
    out = tv.temperature_solve(t, *(x[k] for k in COLS), 900.0,
                               tstate.salinity_profile(ni),
                               tstate.melt_temps(ni), *co)
    (a,) = calls
    assert (a[12] is None) == (not coeffs) and (a[13] is None) == (not coeffs)
    assert a[14].shape == (2, ni) and a[14].dtype == torch.float64
    assert [a[15 + i] is out[k] for i, k in enumerate(tv.BL99_OUTPUTS)] \
        == [True] * 11
    slots, state = a[26:28]
    assert slots.shape == (100,) and slots.dtype == torch.int64
    assert state.shape == (2 * (2 + ni) * ncat * n,)
    assert state.dtype == torch.float32
    assert a[28:35] == (ncat, n, ni, ns, t.niter_therm,
                        tv.CONDUCT[t.conduct], tv.BL99_CHUNK)
    assert 1 <= tv.BL99_CHUNK <= 16 and a[-1] == 0


def test_work_counters():
    nb, fl = tv.temperature_solve_work(5, 1000, 4, 4, 8, 6)
    cols = 5000
    assert nb == (cols * ((4 + 4 + 8) + (1 + 4 + 4 + 6)) + 5 * 1000) * 8 \
        + cols
    # 57 + 27 ni + 11 ns a sweep and 32 + 9 ni at the end (bubbly)
    assert fl == cols * (6 * 209 + 68)
    assert tv.temperature_solve_work(5, 1000, 4, 4, 8, 6, True)[1] \
        == cols * (6 * 207 + 66)
    assert tv.temperature_solve_work(5, 1000, 7, 1, 8, 6, False, "MU71")[1] \
        == cols * (6 * (57 + 25 * 7 + 11) + 32 + 7 * 7)
    nb, fl = itd.itd_remap_work(5, 12, 1000, 8, True)
    assert nb == (2 * 5 * 12 + 10) * 1000 * 8
    assert fl == (2 * 4 * (20 + 6 * 9) + 60 * 5
                  + 2 * 4 * (20 + 6 * 9 + 50)) * 1000
    assert itd.itd_remap_work(5, 12, 1000, 8, False)[0] == 120 * 1000 * 8
