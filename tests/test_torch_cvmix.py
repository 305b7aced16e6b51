"""``core/mixing/cvmix.py`` in the port against the JAX package (CPU,
float64), module by module, on the level-3 globe with 47 layers after one
ocean step of the port's CI configuration, with seeded TKE, internal-wave
energy and tidal forcing so that every branch has something to do:
``kv0_background_qiang``, ``_shear2``, ``_interface_masks``,
``_av_to_elems``, ``calc_cvmix_pp`` (its four option branches),
``calc_cvmix_tke`` (alone and with the IDEMIX coupling), ``_gofx2``,
``_hofx2``, ``_dzt_interfaces``, ``calc_cvmix_idemix`` (coupled and
standalone, with surface and bottom forcing), ``calc_cvmix_tidal``,
``calc_cvmix_ddiff``, ``calc_cvmix_convection`` (step and ramp),
``calc_cvmix_kpp`` (with and without the shortwave) and the mixing
dispatch ``model.vertical_mixing`` for every ``mix_scheme`` the port
takes.  Every output is held within 1e-12 of its largest JAX magnitude;
the JAX functions run eagerly on the same arrays.

TKE's mixing length keeps the JAX scans' order of ``min`` and ``+`` (two
loops over the levels, no ``cummin``), so its parity is that of the rest.
The TKE oracle of ``tests/test_cvmix_oracle.py`` (a line-faithful numpy
transcription of ``integrate_tke``, cvmix_tke.F90:387-918), copied here,
holds ``calc_cvmix_tke`` column by column on the code-built globe, alone
and coupled to IDEMIX, to 1e-10.
"""
import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fesom2_tpu.core.mixing import cvmix as jcv
from fesom2_tpu.core.mixing import kpp as jkpp, pp as jpp
from fesom2_tpu.core.state import OceanState as JOceanState, \
    Forcing as JForcing
from fesom2_tpu.mesh import build_mesh as jax_build_mesh

from fesom2_tpu_torch.constants import density_0
from fesom2_tpu_torch.convert import to_numpy
from fesom2_tpu_torch.core import ops, tracers
from fesom2_tpu_torch.core.mixing import cvmix
from fesom2_tpu_torch.mesh import globe
from fesom2_tpu_torch.model import (check_slice, mix_schemes, pi_config,
                                    setup_pi_model, vertical_mixing)
from fesom2_tpu_torch.run import globe_ocean_inputs, run_pi_ocean

from test_torch_dyn_menus import jax_config
from test_torch_kpp import assert_close
from test_torch_tracer_menus import Pair, to_jax

TOL = 1e-12
OUT = ("Kv", "Av", "Kv_s", "tke", "iwe", "iwe_diss", "iwe_alpha_c",
       "kpp_nonloc", "mld1")


def jarr(x):
    return jnp.asarray(to_numpy(x))


@pytest.fixture(scope="module")
def p(tmp_path_factory):
    torch.set_num_threads(1)
    q = Pair()
    path = globe.write_globe(str(tmp_path_factory.mktemp("globe")), level=3)
    cfg = pi_config()
    cfg.run.use_ice = False
    q.tcfg, q.cfg = cfg, jax_config(cfg)
    q.tm, _ = setup_pi_model(path, device="cpu", cfg=cfg)
    q.tmesh = q.tm.mesh
    q.jmesh = jax_build_mesh(path, force_rotation=True,
                             cyclic_length_deg=360.0, use_partial_cell=True,
                             partial_cell_thresh=0.0)
    ts, tf, tsw = globe_ocean_inputs(q.tm, seed=0)
    ts = run_pi_ocean(q.tm, ts, tf, tsw, 1)
    rng = np.random.default_rng(7)
    nl, N = q.tmesh.nl, q.tmesh.n_nodes
    active = torch.arange(nl)[:, None] <= (q.tmesh.nlevels_node - 1)[None, :]
    pos = lambda scale: torch.where(
        active, torch.as_tensor(np.abs(rng.standard_normal((nl, N))) * scale),
        0.0)
    q.ts = dataclasses.replace(ts, tke=pos(1e-4), iwe=pos(1e-3),
                               iwe_diss=pos(1e-9), iwe_alpha_c=pos(1e-2))
    q.tf = tf
    q.sw3, _ = tracers.shortwave_penetration(tsw, torch.zeros_like(tsw),
                                             q.ts.zbar_3d, q.tmesh,
                                             cfg.ice.albw)
    q.iw_surf = torch.as_tensor(np.abs(rng.standard_normal(N)) * 1e-6)
    q.iw_bot = torch.as_tensor(np.abs(rng.standard_normal(N)) * 1e-6)
    q.tidal = torch.as_tensor(np.abs(rng.standard_normal(N)) * 1e-2)
    q.js = to_jax(q.ts, JOceanState)
    q.jf = to_jax(q.tf, JForcing)
    return q


def cfg_with(p, **cvmix_knobs):
    tcfg = copy.deepcopy(p.tcfg)
    for k, v in cvmix_knobs.items():
        setattr(tcfg.cvmix, k, v)
    return tcfg, jax_config(tcfg)


def check_state(got, want, names=OUT, tol=TOL):
    for name in names:
        assert_close(getattr(got, name), getattr(want, name), name, tol=tol)


def test_helpers(p):
    rng = np.random.default_rng(1)
    lat = rng.uniform(-90, 90, (4, 300))
    dep = rng.uniform(0, 6000, (4, 300))
    lat[0, :3] = [80.0, 3.0, 71.0]
    dep[0, :3] = [20.0, 20.0, 60.0]
    assert_close(cvmix.kv0_background_qiang(torch.as_tensor(lat),
                                            torch.as_tensor(dep)),
                 jcv.kv0_background_qiang(jnp.asarray(lat),
                                          jnp.asarray(dep)), "qiang", tol=TOL)
    assert_close(cvmix._shear2(p.ts), jcv._shear2(p.js), "shear2", tol=TOL)
    for a, b in zip(cvmix._interface_masks(p.tmesh),
                    jcv._interface_masks(p.jmesh)):
        assert np.array_equal(to_numpy(a), np.asarray(b))
    x = p.ts.Kv + 1e-3
    assert_close(cvmix._av_to_elems(x, p.tmesh),
                 jcv._av_to_elems(jarr(x), p.jmesh), "av_to_elems", tol=TOL)
    _, nb, _, active = cvmix._interface_masks(p.tmesh)
    _, jnb, _, jactive = jcv._interface_masks(p.jmesh)
    for a, b in zip(cvmix._dzt_interfaces(p.ts, p.tmesh, nb, active),
                    jcv._dzt_interfaces(p.js, p.jmesh, jnb, jactive)):
        assert_close(a, b, "dzt", tol=TOL)
    xs = np.concatenate([np.linspace(0.0, 50.0, 501), [1e-30, 1e3, 1e6]])
    assert_close(cvmix._gofx2(torch.as_tensor(xs)), jcv._gofx2(
        jnp.asarray(xs)), "gofx2", tol=TOL)
    assert_close(cvmix._hofx2(torch.as_tensor(xs)), jcv._hofx2(
        jnp.asarray(xs)), "hofx2", tol=TOL)


@pytest.mark.parametrize("knobs", [
    {}, dict(pp_use_fesompp=False), dict(pp_use_AvbinKv=False),
    dict(pp_use_nonconstKvb=False)], ids=["fesom", "cvmix", "Av_out_of_Kv",
                                           "constant_Kvb"])
def test_cvmix_pp(p, knobs):
    tcfg, jcfg = cfg_with(p, **knobs)
    check_state(cvmix.calc_cvmix_pp(p.ts, p.tmesh, tcfg),
                jcv.calc_cvmix_pp(p.js, p.jmesh, jcfg), ("Kv", "Av"))


@pytest.mark.parametrize("coupled", [False, True], ids=["alone", "idemix"])
def test_cvmix_tke(p, coupled):
    kw, jkw = {}, {}
    if coupled:
        kw = dict(iw_diss=p.ts.iwe_diss, iwe=p.ts.iwe,
                  iwe_alpha_c=p.ts.iwe_alpha_c)
        jkw = {k: jarr(v) for k, v in kw.items()}
    got = cvmix.calc_cvmix_tke(p.ts, p.tmesh, p.tcfg, p.tf, **kw)
    want = jcv.calc_cvmix_tke(p.js, p.jmesh, p.cfg, p.jf, **jkw)
    check_state(got, want, ("tke", "Kv", "Av"))
    lev = torch.arange(p.tmesh.nl)[:, None]
    active = lev <= (p.tmesh.nlevels_node - 1)[None, :]
    assert bool((got.tke[active] > 0).all())
    if not coupled:
        assert float(got.tke[active].min()) >= p.tcfg.cvmix.tke_min


@pytest.mark.parametrize("standalone", [False, True],
                         ids=["coupled", "standalone"])
@pytest.mark.parametrize("n_iter", [5, 0], ids=["propagation", "columns"])
def test_cvmix_idemix(p, standalone, n_iter):
    tcfg, jcfg = cfg_with(p, idemix_n_hor_iwe_prop_iter=n_iter)
    got = cvmix.calc_cvmix_idemix(p.ts, p.tmesh, tcfg, p.tf,
                                  iw_surf=p.iw_surf, iw_bot=p.iw_bot,
                                  standalone=standalone)
    want = jcv.calc_cvmix_idemix(p.js, p.jmesh, jcfg, p.jf,
                                 iw_surf=jarr(p.iw_surf),
                                 iw_bot=jarr(p.iw_bot),
                                 standalone=standalone)
    check_state(got, want, ("iwe", "iwe_diss", "iwe_alpha_c", "Kv", "Av"))
    assert float(got.iwe_diss.max()) > 0.0
    # no forcing given: zeros, as the JAX package's default
    got0 = cvmix.calc_cvmix_idemix(p.ts, p.tmesh, tcfg, p.tf)
    want0 = jcv.calc_cvmix_idemix(p.js, p.jmesh, jcfg, p.jf)
    check_state(got0, want0, ("iwe", "iwe_diss"))


def test_cvmix_tidal(p):
    got = cvmix.calc_cvmix_tidal(p.ts, p.tmesh, p.tcfg, tidal_forc=p.tidal)
    want = jcv.calc_cvmix_tidal(p.js, p.jmesh, p.cfg,
                                tidal_forc=jarr(p.tidal))
    check_state(got, want, ("Kv", "Av"))
    assert float((got.Kv - p.ts.Kv).abs().max()) > 0.0
    # zero forcing (the default) adds nothing
    assert torch.equal(cvmix.calc_cvmix_tidal(p.ts, p.tmesh, p.tcfg).Kv,
                       p.ts.Kv)


def test_cvmix_ddiff(p):
    got = cvmix.calc_cvmix_ddiff(p.ts, p.tmesh, p.tcfg)
    want = jcv.calc_cvmix_ddiff(p.js, p.jmesh, p.cfg)
    check_state(got, want, ("Kv", "Kv_s"))
    assert not torch.equal(got.Kv_s, got.Kv)


@pytest.mark.parametrize("bvsqr", [0.0, -1e-6], ids=["step", "ramp"])
def test_cvmix_convection(p, bvsqr):
    tcfg, jcfg = cfg_with(p, conv_bvsqr=bvsqr)
    # some unstable interfaces
    ts = dataclasses.replace(p.ts, bvfreq=p.ts.bvfreq - 2e-7)
    got = cvmix.calc_cvmix_convection(ts, p.tmesh, tcfg)
    want = jcv.calc_cvmix_convection(to_jax(ts, JOceanState), p.jmesh, jcfg)
    check_state(got, want, ("Kv", "Av"))
    assert float((got.Kv - ts.Kv).max()) > 0.0


@pytest.mark.parametrize("sw", [False, True], ids=["no_sw", "sw"])
def test_cvmix_kpp(p, sw):
    got = cvmix.calc_cvmix_kpp(p.ts, p.tmesh, p.tcfg, p.tf,
                               sw_3d=p.sw3 if sw else None)
    want = jcv.calc_cvmix_kpp(p.js, p.jmesh, p.cfg, p.jf,
                              sw_3d=jarr(p.sw3) if sw else None)
    check_state(got, want, ("Kv", "Av", "kpp_nonloc", "mld1"))
    assert float(got.kpp_nonloc.max()) > 0.0


def jax_mixing(p, jcfg, js, sw):
    """The JAX step's mixing dispatch (``fesom2_tpu/model.py:139-183``),
    on its own."""
    schemes = [s.strip().upper() for s in jcfg.dyn.mix_scheme.split("+")]
    main = [s for s in schemes if s not in ("CVMIX_IDEMIX", "CVMIX_TIDAL",
                                            "CVMIX_DDIFF", "CVMIX_CONV")]
    main = main[0] if main else None
    jm, jf = p.jmesh, p.jf
    if "CVMIX_IDEMIX" in schemes:
        js = jcv.calc_cvmix_idemix(js, jm, jcfg, jf, standalone=main is None)
    if main == "KPP":
        js = jkpp.oce_mixing_kpp(js, jm, jcfg, jf)
    elif main == "PP":
        js = jpp.oce_mixing_pp(js, jm, jcfg)
    elif main == "CVMIX_PP":
        js = jcv.calc_cvmix_pp(js, jm, jcfg)
    elif main == "CVMIX_KPP":
        js = jcv.calc_cvmix_kpp(js, jm, jcfg, jf, sw_3d=sw)
    elif main == "CVMIX_TKE":
        kw = dict(iw_diss=js.iwe_diss, iwe=js.iwe,
                  iwe_alpha_c=js.iwe_alpha_c) \
            if "CVMIX_IDEMIX" in schemes else {}
        js = jcv.calc_cvmix_tke(js, jm, jcfg, jf, **kw)
    if main is not None:
        js = jpp.mo_convect(js, jm, jcfg, jf)
    if "CVMIX_TIDAL" in schemes:
        js = jcv.calc_cvmix_tidal(js, jm, jcfg)
    if "CVMIX_DDIFF" in schemes:
        js = jcv.calc_cvmix_ddiff(js, jm, jcfg)
    if "CVMIX_CONV" in schemes:
        js = jcv.calc_cvmix_convection(js, jm, jcfg)
    return js


SCHEMES = ["PP", "KPP", "cvmix_PP", "cvmix_KPP", "cvmix_TKE",
           "cvmix_TKE+cvmix_IDEMIX", "cvmix_IDEMIX", "KPP+cvmix_TIDAL",
           "PP+cvmix_DDIFF+cvmix_CONV", "cvmix_TKE + cvmix_IDEMIX"]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_mixing_dispatch(p, scheme):
    tcfg = copy.deepcopy(p.tcfg)
    tcfg.dyn.mix_scheme = scheme
    check_slice(tcfg)
    jcfg = jax_config(tcfg)
    got = vertical_mixing(p.ts, p.tmesh, tcfg, p.tf, sw_3d=p.sw3)
    want = jax_mixing(p, jcfg, p.js, jarr(p.sw3))
    check_state(got, want, ("Kv", "Av", "Kv_s", "tke", "iwe", "iwe_diss",
                            "mixlength"))
    main, schemes = mix_schemes(tcfg)
    assert (main is None) == (scheme == "cvmix_IDEMIX")


def test_unknown_main_scheme_raises_as_jax_does(p):
    tcfg = copy.deepcopy(p.tcfg)
    tcfg.dyn.mix_scheme = "cvmix_FOO+cvmix_IDEMIX"
    with pytest.raises(ValueError, match="unknown mix_scheme"):
        check_slice(tcfg)


# --------------------------------------------------------------------------
# the TKE oracle of tests/test_cvmix_oracle.py (a copy)
# --------------------------------------------------------------------------
def _solve_tridiag(a, b, c, d):
    n = len(d)
    cp = np.zeros(n)
    dp = np.zeros(n)
    cp[0] = c[0] / b[0]
    dp[0] = d[0] / b[0]
    for k in range(1, n):
        m = b[k] - a[k] * cp[k - 1]
        cp[k] = c[k] / m
        dp[k] = (d[k] - a[k] * dp[k - 1]) / m
    x = np.zeros(n)
    x[-1] = dp[-1]
    for k in range(n - 2, -1, -1):
        x[k] = dp[k] - cp[k] * x[k + 1]
    return x


def tke_oracle_column(tke_old, dzw, dzt, Ssqr, Nsqr, forc_tke_surf, dtime,
                      *, alpha_tke=30.0, c_eps=0.7, cd=3.75,
                      KappaM_max=100.0, mxl_min=1e-8, c_k=0.1,
                      tke_min=1e-6, only_tke=True, iw_diss=None,
                      E_iw=None, alpha_c=None):
    """integrate_tke (cvmix_tke.F90:387-918), tke_mxl_choice=2, Neumann
    surface/bottom (use_*_dirichlet=False), forc_rho_surf=bottom_fric=0."""
    nlev = len(dzw)
    # Part 1: mixing length
    sqrttke = np.sqrt(np.maximum(0.0, tke_old))
    mxl = np.sqrt(2.0) * sqrttke / np.sqrt(np.maximum(1e-12, Nsqr))
    mxl[0] = 0.0
    mxl[nlev] = 0.0
    for k in range(1, nlev):
        mxl[k] = min(mxl[k], mxl[k - 1] + dzw[k - 1])
    mxl[nlev - 1] = min(mxl[nlev - 1], mxl_min + dzw[nlev - 1])
    for k in range(nlev - 2, 0, -1):
        mxl[k] = min(mxl[k], mxl[k + 1] + dzw[k])
    mxl = np.maximum(mxl, mxl_min)
    # Part 2: diffusivities
    KappaM = np.minimum(KappaM_max, c_k * mxl * sqrttke)
    Rinum = Nsqr / np.maximum(Ssqr, 1e-12)
    if not only_tke:
        Rinum = np.minimum(Rinum, KappaM * Nsqr
                           / np.maximum(1e-12, alpha_c * E_iw ** 2))
    prandtl = np.maximum(1.0, np.minimum(10.0, 6.6 * Rinum))
    KappaH = KappaM / prandtl
    # Part 3: forcing
    forc = Ssqr * KappaM - Nsqr * KappaH
    if not only_tke:
        forc = forc + iw_diss
    # Part 4: implicit diffusion + dissipation
    ke = np.zeros(nlev + 1)
    for k in range(nlev):          # k = 0..nlev-1 (Fortran 1..nlev)
        kp1 = min(k + 1, nlev - 1)
        kk = max(k, 1)
        ke[k] = alpha_tke * 0.5 * (KappaM[kp1] + KappaM[kk])
    c_dif = np.zeros(nlev + 1)
    c_dif[:nlev] = ke[:nlev] / (dzt[:nlev] * dzw[:nlev])
    b_dif = np.zeros(nlev + 1)
    for k in range(1, nlev):
        b_dif[k] = ke[k - 1] / (dzt[k] * dzw[k - 1]) \
            + ke[k] / (dzt[k] * dzw[k])
    a_dif = np.zeros(nlev + 1)
    for k in range(1, nlev + 1):
        a_dif[k] = ke[k - 1] / (dzt[k] * dzw[k - 1])
    # Neumann BCs: wind forcing into layer 1, diffusive closure rows
    forc = forc.copy()
    forc[0] = forc[0] + (cd * forc_tke_surf ** 1.5) / dzt[0]
    b_dif[0] = ke[0] / (dzt[0] * dzw[0])
    b_dif[nlev] = ke[nlev - 1] / (dzt[nlev] * dzw[nlev - 1])
    a_tri = -dtime * a_dif
    b_tri = 1.0 + dtime * b_dif
    b_tri[1:nlev] = b_tri[1:nlev] \
        + dtime * c_eps * sqrttke[1:nlev] / mxl[1:nlev]
    c_tri = -dtime * c_dif
    d_tri = tke_old + dtime * forc
    tke_new = _solve_tridiag(a_tri, b_tri, c_tri, d_tri)
    # Part 5: bound
    if only_tke:
        tke_new = np.maximum(tke_new, tke_min)
    return tke_new, KappaM, KappaH


@pytest.mark.parametrize("coupled", [False, True], ids=["alone", "idemix"])
def test_tke_against_the_column_oracle(p, coupled):
    """calc_cvmix_tke column by column against the oracle, with the
    oracle's inputs built as the wrapper builds them
    (gen_modules_cvmix_tke.F90:269-330), on every column of the globe."""
    s, mesh, cfg = p.ts, p.tmesh, p.tcfg
    kw = dict(iw_diss=s.iwe_diss, iwe=s.iwe, iwe_alpha_c=s.iwe_alpha_c) \
        if coupled else {}
    out = cvmix.calc_cvmix_tke(s, mesh, cfg, p.tf, **kw)
    tke_new, Kv_new = out.tke.numpy(), out.Kv.numpy()
    nln = mesh.nlevels_node.numpy()
    hn, Z3, bv = s.hnode.numpy(), s.Z_3d.numpy(), s.bvfreq.numpy()
    S2 = cvmix._shear2(s).numpy()
    sxy = ops.elem_to_node_mean_flat(torch.stack([p.tf.stress_x,
                                                  p.tf.stress_y]), mesh)
    fsurf = (torch.sqrt(sxy[0] ** 2 + sxy[1] ** 2) / density_0).numpy()
    cv = cfg.cvmix
    for n in range(mesh.n_nodes):
        nlev = int(nln[n]) - 1
        dzw = hn[:nlev, n]
        dzt = np.zeros(nlev + 1)
        dzt[1:nlev] = np.abs(Z3[:nlev - 1, n] - Z3[1:nlev, n])
        dzt[0] = hn[0, n] / 2.0
        dzt[nlev] = hn[nlev - 1, n] / 2.0
        Ssqr = np.zeros(nlev + 1)
        Ssqr[1:nlev] = S2[1:nlev, n]
        Nsqr = np.zeros(nlev + 1)
        Nsqr[1:nlev] = bv[1:nlev, n]
        col = slice(0, nlev + 1)
        extra = dict(only_tke=False, iw_diss=s.iwe_diss.numpy()[col, n],
                     E_iw=s.iwe.numpy()[col, n],
                     alpha_c=s.iwe_alpha_c.numpy()[col, n]) if coupled \
            else {}
        t_new, _, KH = tke_oracle_column(
            s.tke.numpy()[col, n], dzw, dzt, Ssqr, Nsqr, fsurf[n], cfg.dt,
            alpha_tke=cv.tke_alpha, c_eps=cv.tke_c_eps, cd=cv.tke_cd,
            KappaM_max=cv.tke_kappaM_max, mxl_min=cv.tke_mxl_min,
            c_k=cv.tke_c_k, tke_min=cv.tke_min, **extra)
        scale = np.abs(t_new).max() + 1e-12
        assert np.allclose(tke_new[col, n], t_new, atol=1e-10 * scale,
                           rtol=1e-10), n
        assert np.allclose(Kv_new[1:nlev, n], KH[1:nlev], rtol=1e-10,
                           atol=1e-14), n
        assert np.all(tke_new[nlev + 1:, n] == 0.0)
