"""Standard and adaptive EVP, ``ridging_rates`` and the coupled-mode ice
thermodynamics of the port against the JAX package, on the level-3 globe
with 12 layers (CPU, float64), from the seeded inputs of
``test_torch_ice.seeded_ice_inputs``.

* ``evp_dynamics`` (whichEVP = 0) and ``aevp_dynamics`` (2), on the whole
  mesh and through ``ice_dynamics`` on the polar-cap subdomain, after 1, 8
  and 120 subcycles: every ice field within 1e-12 of its largest JAX
  magnitude (``-s`` prints the port-vs-JAX rounding).  Adaptive EVP's
  refresh of alpha and beta is held with alphas under 50 on elements
  without ice, so the rule that a padded ``nod_in_elem`` slot counts as 50
  decides some betas.
* The two kernel variants' data flow, emulated in numpy a lane per
  thread, phase by phase between the grid barriers of one launch, held
  bit for bit against the plain loops after 1, 8 and 120 subcycles in
  both dtypes, on the subdomain's tables (the plain loops take numpy's
  square root, as ``test_torch_ice.py`` does for mEVP: torch's vectorised
  CPU sqrt can be an ulp off, the card's and numpy's are correctly
  rounded).
* ``ridging_rates``, ``thermodynamics_cpl`` (both salt forms, both lead
  closings) and ``ice_timestep_cpl``: within 1e-12 of max|JAX|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fesom2_tpu.ice import evp as jevp, step as jstep, \
    thermo_cpl as jthermo_cpl

from fesom2_tpu_torch import kernels
from fesom2_tpu_torch.core import ops
from fesom2_tpu_torch.ice import evp
from fesom2_tpu_torch.ice.step import ice_timestep_cpl
from fesom2_tpu_torch.ice.thermo_cpl import (CoupledAtmFluxes,
                                             thermodynamics_cpl)
from fesom2_tpu_torch.mesh import globe
from fesom2_tpu_torch.model import pi_config

from test_torch_ice import ICE_FIELDS, ice_case, t
from test_torch_kpp import assert_close

TOL = 1e-12


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return ice_case(globe.write_globe(
        str(tmp_path_factory.mktemp("globe")), level=3, n_layers=12,
        dz_bottom=1000.0))


def rheology_config(which, n_sub):
    cfg = pi_config()
    cfg.ice.whichEVP = which
    cfg.ice.evp_rheol_steps = n_sub
    return cfg


def low_alpha(c):
    """The case's ice with alpha in [5, 40] on every element (under the
    floor of 50 that the refresh gives elements with ice), as numpy for
    JAX and as tensors for the port."""
    rng = np.random.default_rng(17)
    alpha = rng.uniform(5.0, 40.0, c.jmesh.n_elems)
    beta = rng.uniform(5.0, 40.0, c.jmesh.n_nodes)
    jice = dataclasses.replace(c.jice, alpha_aevp=jnp.asarray(alpha),
                               beta_aevp=jnp.asarray(beta))
    tice = dataclasses.replace(c.tice, alpha_aevp=t(alpha), beta_aevp=t(beta))
    return jice, tice


def rel(got, want, names):
    return max(float(np.abs(getattr(got, k).numpy()
                            - np.asarray(getattr(want, k))).max()
                     / max(np.abs(np.asarray(getattr(want, k))).max(),
                           1e-300)) for k in names)


@pytest.mark.parametrize("n_sub", [1, 8, 120])
@pytest.mark.parametrize("which", [0, 2])
@pytest.mark.parametrize("on_subdomain", [False, True])
def test_evp_and_aevp_match_jax(case, which, n_sub, on_subdomain):
    c = case
    cfg = rheology_config(which, n_sub)
    jice, tice = low_alpha(c) if which == 2 else (c.jice, c.tice)
    jsub, tsub = (c.jsub, c.tsub) if on_subdomain else (None, None)
    want = jax.jit(lambda i, f, s: jevp.ice_dynamics(
        i, c.jmesh, f, s, cfg, sub=jsub))(jice, c.jforcing, c.jsurf)
    kernels.reset_launches()
    got = evp.ice_dynamics(tice, c.tmesh, c.tforcing, c.tsurf, cfg, sub=tsub)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    print(f"whichEVP={which} {n_sub} subcycles "
          f"{'subdomain' if on_subdomain else 'whole mesh'}, port against "
          f"JAX, of max|JAX|: velocities {rel(got, want, ('u_ice', 'v_ice')):.3e}"
          f", stresses {rel(got, want, ('sigma11', 'sigma12', 'sigma22')):.3e}")
    for name in ICE_FIELDS:
        assert_close(getattr(got, name), getattr(want, name), name, tol=TOL)
    assert float(got.u_ice.abs().max()) > 1e-3
    assert float((got.sigma11 - tice.sigma11).abs().max()) > 1.0
    if which == 0:
        # no ice, no motion: the node half writes 0 under 0.01
        assert bool((got.u_ice[tice.a_ice < 0.01] == 0).all())
    else:
        alpha, beta = got.alpha_aevp, got.beta_aevp
        moved = alpha != tice.alpha_aevp
        assert bool(moved.any()) and bool((alpha[moved] >= 50.0).all())
        # an element without ice keeps its alpha
        assert float(alpha.min()) < 50.0
        if on_subdomain:
            outside = ~c.tsub.node_mask
            assert torch.equal(beta[outside], tice.beta_aevp[outside])


def test_aevp_refresh_counts_a_padded_slot_as_50(case):
    """beta of a node is the largest alpha of its elements, and a padded
    slot of ``nod_in_elem`` counts as 50: with every alpha under 50 and
    the velocities of a tenth subcycle, the nodes with a padded slot and
    no element with ice get exactly 50, the others the largest alpha of
    their elements, as in JAX."""
    c = case
    cfg = rheology_config(2, 10)
    jice, tice = low_alpha(c)
    tab = evp.aevp_setup(tice, c.tmesh, c.tforcing, c.tsurf, cfg)
    uv = torch.stack([tice.u_ice, tice.v_ice])
    alpha, beta = evp.aevp_refresh(uv, tice.alpha_aevp, tab, c.tmesh, cfg)
    nie = c.tmesh.nod_in_elem.long()
    padded = (nie < 0).any(-1)
    icy = (tab.elem_c[11] > 0)[nie.clamp_min(0)] & (nie >= 0)
    plain = padded & ~icy.any(-1)
    assert int(plain.sum()) > 0 and int((~padded).sum()) > 0
    assert bool((beta[plain] == 50.0).all())
    full = ~padded & ~icy.any(-1)
    assert torch.equal(beta[full], alpha[nie[full]].max(-1).values)
    assert bool((beta[full] < 50.0).all())
    want = jax.jit(lambda i, f, s: jevp.aevp_dynamics(
        i, c.jmesh, f, s, cfg))(jice, c.jforcing, c.jsurf)
    got = evp.aevp_dynamics(tice, c.tmesh, c.tforcing, c.tsurf, cfg)
    assert_close(got.beta_aevp, want.beta_aevp, "beta", tol=TOL)
    assert_close(got.alpha_aevp, want.alpha_aevp, "alpha", tol=TOL)


# --------------------------------------------------------------------------
# the kernel variants' data flow
# --------------------------------------------------------------------------
def _strain(e, T, ue, ve, vale):
    dx, dy, mc = e[0:3], e[3:6], e[6]
    eps11 = ((dx[0] * ue[0] + dx[1] * ue[1]) + dx[2] * ue[2]) \
        - ((ve[0] + ve[1]) + ve[2]) * mc
    eps22 = (dy[0] * ve[0] + dy[1] * ve[1]) + dy[2] * ve[2]
    eps12 = T(0.5) * ((((dy[0] * ue[0] + dy[1] * ue[1]) + dy[2] * ue[2])
                       + ((dx[0] * ve[0] + dx[1] * ve[1]) + dx[2] * ve[2]))
                      + ((ue[0] + ue[1]) + ue[2]) * mc)
    eps1, eps2 = eps11 + eps22, eps11 - eps22
    delta = np.sqrt(eps1 * eps1 + vale * (eps2 * eps2
                                          + T(4.0) * (eps12 * eps12)))
    return eps1, eps2, eps12, delta


def evp_stress_lanes(e, T, ue, ve, sg, tab):
    """The EVP kernel's element thread: strain rates, the elastic
    relaxation where the element has ice (row 9)."""
    s11, s12, s22 = sg
    vale, dmin, ti = T(tab.vale), T(tab.delta_min), T(tab.tevp_inv)
    dte, det = T(tab.dte), T(tab.det)
    eps1, eps2, eps12, delta = _strain(e, T, ue, ve, vale)
    zeta = (e[7] / np.where(delta < dmin, dmin, delta)) * ti
    r1 = zeta * eps1 - e[7] * ti
    r2, r3 = (zeta * eps2) * vale, (zeta * eps12) * vale
    si1 = det * ((s11 + s22) + dte * r1)
    si2 = det * ((s11 - s22) + dte * r2)
    has = e[9] > 0
    return (np.where(has, T(0.5) * (si1 + si2), s11),
            np.where(has, det * (s12 + dte * r3), s12),
            np.where(has, T(0.5) * (si1 - si2), s22)), 8


def aevp_stress_lanes(e, T, ue, ve, sg, tab):
    """The aEVP kernel's element thread: mEVP's update with the element's
    own det1, det2 (rows 8, 9), where it has ice (row 11)."""
    s11, s12, s22 = sg
    vale, dmin = T(tab.vale), T(tab.delta_min)
    eps1, eps2, eps12, delta = _strain(e, T, ue, ve, vale)
    p = e[7] / (delta + dmin)
    r1, r2, r3 = p * (eps1 - delta), (p * eps2) * vale, (p * eps12) * vale
    d1, d2 = e[8], e[9]
    si1 = d1 * (s11 + s22) + d2 * r1
    si2 = d1 * (s11 - s22) + d2 * r2
    has = e[11] > 0
    return (np.where(has, T(0.5) * (si1 + si2), s11),
            np.where(has, d1 * s12 + d2 * r3, s12),
            np.where(has, T(0.5) * (si1 - si2), s22)), 10


def evp_node_lanes(c, T, fu, fv, u, v, tab):
    uw, vw, iam, ra, rm, im, sx, sy, bc, cor, has = c
    dte, ax, ay = T(tab.dte), T(tab.ax), T(tab.ay)
    u_rhs, v_rhs = fu * iam + ra, fv * iam + rm
    du, dv = u - uw, v - vw
    drag = ((T(tab.cd) * np.sqrt(du * du + dv * dv)) * T(1030.0)) * im
    rhsu = u + dte * ((drag * (ax * uw - ay * vw) + im * sx) + u_rhs)
    rhsv = v + dte * ((drag * (ax * vw + ay * uw) + im * sy) + v_rhs)
    r_a = T(1.0) + (ax * drag) * dte
    r_b = dte * (cor + ay * drag)
    idet = bc / (r_a * r_a + r_b * r_b)
    return (np.where(has > 0, idet * (r_a * rhsu + r_b * rhsv), T(0.0)),
            np.where(has > 0, idet * (r_a * rhsv - r_b * rhsu), T(0.0)))


def aevp_node_lanes(c, T, fu, fv, u, v, tab):
    u0, v0, uw, vw, mass, ra, rm, ith, sx, sy, bc, fc, beta = c
    rdt = T(tab.rdt)
    u_rhs, v_rhs = fu * mass + ra, fv * mass + rm
    du, dv = u - uw, v - vw
    drag = ((T(tab.rdt_cd) * np.sqrt(du * du + dv * dv)) * T(1030.0)) * ith
    rhsu = ((u0 + drag * uw) + rdt * (ith * sx + u_rhs)) + beta * u
    rhsv = ((v0 + drag * vw) + rdt * (ith * sy + v_rhs)) + beta * v
    a = (T(1.0) + beta) + drag
    idet = bc / (a * a + fc * fc)
    return idet * (a * rhsu + fc * rhsv), idet * (a * rhsv - fc * rhsu)


def emulate_subcycles(uv, sig, tab, mesh, n, stress, node):
    """``n`` subcycles as one launch of the rheology's kernel runs them,
    a numpy lane per thread (``test_torch_ice.emulate_mevp_subcycles``'
    layout): the constants and the stresses copied once; u, v and the
    divergence passed between threads only through device-memory buffers,
    each read after a grid barrier."""
    ec, nc = tab.elem_c.numpy().copy(), tab.node_c.numpy().copy()
    T = ec.dtype.type
    en = tab.en.numpy().astype(np.int64)
    slot = ops.elem_slot_of(mesh).numpy().astype(np.int64)
    E, N, K = ec.shape[1], nc.shape[1], slot.shape[0]
    uvb, sg = uv.numpy().copy(), sig.numpy().copy()
    fuv = np.zeros((2, 3 * E), ec.dtype)
    barriers = 0
    for it in range(n):
        ue, ve = uvb[0][en], uvb[1][en]
        (s11, s12, s22), row = stress(ec, T, ue, ve, sg, tab)
        sg = np.stack([s11, s12, s22])
        neg_area, mc = -ec[row], ec[6]
        for j in range(3):
            dx, dy = ec[j], ec[3 + j]
            fuv[0, 3 * np.arange(E) + j] = neg_area * (s11 * dx
                                                       + s12 * (dy + mc))
            fuv[1, 3 * np.arange(E) + j] = neg_area * ((s12 * dx + s22 * dy)
                                                       - s11 * mc)
        barriers += 1
        fu, fv = np.zeros(N, ec.dtype), np.zeros(N, ec.dtype)
        for k in range(K):
            w = slot[k]
            ok = w >= 0
            fu = np.where(ok, fu + fuv[0][np.maximum(w, 0)], fu)
            fv = np.where(ok, fv + fuv[1][np.maximum(w, 0)], fv)
        uvb = np.stack(node(nc, T, fu, fv, uvb[0], uvb[1], tab))
        barriers += it + 1 < n
    assert barriers == evp.mevp_subcycles_barriers(n)
    return uvb, sg


VARIANTS = {
    0: (evp.evp_setup, evp.evp_subcycles_plain, evp.evp_subcycles,
        evp_stress_lanes, evp_node_lanes, "evp_subcycles"),
    2: (evp.aevp_setup, evp.aevp_subcycles_plain, evp.aevp_subcycles,
        aevp_stress_lanes, aevp_node_lanes, "aevp_subcycles")}


def subdomain_inputs(c, dtype, which):
    cast = lambda obj: dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(dtype)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)
        and getattr(obj, f.name).is_floating_point()})
    sub = cast(c.tsub)
    tice = low_alpha(c)[1] if which == 2 else c.tice
    ice, forcing, surf = evp.subdomain_inputs(
        cast(tice), sub, cast(c.tforcing), cast(c.tsurf), aevp=which == 2)
    return ice, forcing, surf, sub


@pytest.mark.parametrize("n_sub", [1, 8, 120])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("which", [0, 2])
def test_kernel_variant_data_flow_equals_the_plain_subcycles(
        case, monkeypatch, which, dtype, n_sub):
    setup, plain, wrapper, stress, node, name = VARIANTS[which]
    ice, forcing, surf, sub = subdomain_inputs(case, dtype, which)
    tab = setup(ice, sub, forcing, surf, rheology_config(which, n_sub))
    assert tab.fuv is None and tab.node_c.dtype == dtype
    uv = torch.stack([ice.u_ice, ice.v_ice])
    sig = torch.stack([ice.sigma11, ice.sigma12, ice.sigma22])
    monkeypatch.setattr(torch, "sqrt", lambda x: torch.from_numpy(
        np.sqrt(x.numpy())))
    with np.errstate(all="ignore"):
        got_uv, got_sig = emulate_subcycles(uv, sig, tab, sub, n_sub, stress,
                                            node)
    want_uv, want_sig = plain(uv, sig, tab, sub, n_sub)
    assert np.array_equal(got_sig, want_sig.numpy())
    assert np.array_equal(got_uv, want_uv.numpy())
    assert float(want_uv.abs().max()) > 1e-3
    kernels.reset_launches()
    on_cpu = wrapper(uv, sig, tab, sub, n_sub)
    assert torch.equal(on_cpu[0], want_uv) and torch.equal(on_cpu[1],
                                                           want_sig)
    assert kernels.LAUNCHES[name] == 0


def test_variant_tables_and_work():
    assert (len(evp.EVP_NODE_ROWS), len(evp.EVP_ELEM_ROWS)) == (11, 10)
    assert (len(evp.AEVP_NODE_ROWS), len(evp.AEVP_ELEM_ROWS)) == (13, 12)
    nbytes, flops = evp.evp_subcycles_work(1000, 1900, 7, 8, 120)
    assert nbytes == (15 * 1000 + 16 * 1900) * 8 + (3 * 1900 + 7 * 1000) * 4
    assert flops == 120 * (75 * 1900 + 59 * 1000)
    nbytes, flops = evp.aevp_subcycles_work(1000, 1900, 7, 8, 120)
    assert nbytes == (17 * 1000 + 18 * 1900) * 8 + (3 * 1900 + 7 * 1000) * 4
    assert flops == 120 * (72 * 1900 + 54 * 1000)
    assert set(evp.RHEOLOGY) == {"evp", "mevp", "aevp"}
    assert {"evp_subcycles", "aevp_subcycles"} <= set(kernels.KERNELS)


def test_a_cuda_tensor_never_takes_the_plain_loop(case, monkeypatch):
    """Without a card the wrappers raise for a tensor that claims a CUDA
    device: the kernel or nothing."""
    c = case
    cfg = rheology_config(0, 2)
    tab = evp.evp_setup(c.tice, c.tmesh, c.tforcing, c.tsurf, cfg)
    monkeypatch.setattr(kernels, "library", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    uv = torch.stack([c.tice.u_ice, c.tice.v_ice])
    sig = torch.stack([c.tice.sigma11, c.tice.sigma12, c.tice.sigma22])
    meta = uv.to("meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        evp.evp_subcycles(meta, sig.to("meta"), tab, c.tmesh, 2)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        evp.aevp_subcycles(meta, sig.to("meta"), tab, c.tmesh, 2)


# --------------------------------------------------------------------------
# ridging rates and the coupled-mode thermodynamics
# --------------------------------------------------------------------------
def test_ridging_rates(case):
    c = case
    want = jax.jit(lambda i: jevp.ridging_rates(i, c.jmesh, c.cfg))(c.jice)
    got = evp.ridging_rates(c.tice, c.tmesh, c.cfg)
    for name, a, b in zip(("conv", "shear"), got, want):
        assert_close(a, b, name, tol=TOL)
        assert float(a.abs().max()) > 0.0
    assert bool((got[0] >= 0).all()) and bool((got[1] >= -1e-18).all())


def coupled_fluxes(n, seed=5):
    rng = np.random.default_rng(seed)
    u = lambda lo, hi: rng.uniform(lo, hi, n)
    return dict(oce_heat_flux=u(-300.0, 100.0), ice_heat_flux=u(-150.0, 80.0),
                shortwave=u(0.0, 250.0), evap_no_ifrac=u(-5e-8, 0.0),
                sublimation=u(-1e-8, 0.0), prec_rain=u(0.0, 3e-8),
                prec_snow=u(0.0, 2e-8), runoff=u(0.0, 1e-9))


@pytest.mark.parametrize("use_virt_salt", [False, True])
@pytest.mark.parametrize("h0max", [1.5, 0.0])
def test_thermodynamics_cpl(case, use_virt_salt, h0max):
    c = case
    fx = coupled_fluxes(c.jmesh.n_nodes)
    jatm = jthermo_cpl.CoupledAtmFluxes(**{k: jnp.asarray(v)
                                           for k, v in fx.items()})
    tatm = CoupledAtmFluxes(**{k: t(v) for k, v in fx.items()})
    want = jax.jit(lambda i, a, s: jthermo_cpl.thermodynamics_cpl(
        i, a, s, c.cfg, use_virt_salt, ref_sss=34.0, ref_sss_local=True,
        h0max=h0max))(c.jice, jatm, c.jsurf)
    got = thermodynamics_cpl(c.tice, tatm, c.tsurf, c.cfg, use_virt_salt,
                             ref_sss=34.0, ref_sss_local=True, h0max=h0max)
    for name in ICE_FIELDS:
        assert_close(getattr(got, name), getattr(want, name), name, tol=TOL)
    assert float((got.m_ice - c.tice.m_ice).abs().max()) > 0.0
    assert float(got.flice.abs().max()) > 0.0


@pytest.mark.parametrize("which", [0, 1, 2])
def test_ice_timestep_cpl(case, which):
    c = case
    cfg = rheology_config(which, 8)
    fx = coupled_fluxes(c.jmesh.n_nodes, seed=6)
    jatm = jthermo_cpl.CoupledAtmFluxes(**{k: jnp.asarray(v)
                                           for k, v in fx.items()})
    tatm = CoupledAtmFluxes(**{k: t(v) for k, v in fx.items()})
    want = jax.jit(lambda i, f, a, s: jstep.ice_timestep_cpl(
        i, c.jmesh, f, a, s, cfg, False, ref_sss=34.0, ref_sss_local=True))(
        c.jice, c.jforcing, jatm, c.jsurf)
    got = ice_timestep_cpl(c.tice, c.tmesh, c.tforcing, tatm, c.tsurf, cfg,
                           False, ref_sss=34.0, ref_sss_local=True)
    for name in ICE_FIELDS:
        assert_close(getattr(got, name), getattr(want, name), name, tol=TOL)
    assert float(got.u_ice.abs().max()) > 1e-3
