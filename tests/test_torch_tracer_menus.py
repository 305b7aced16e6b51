"""The tracer menus in the port against the JAX package (CPU, float64),
module by module, on the level-3 globe with 47 layers (columns of 4 to 45
wet layers; PPM also on columns cut to 2-5) under zstar with partial cells, after one ocean step of the
port's CI configuration: the horizontal schemes (``adv_hor_upw1``, the
upwind branch of ``adv_hor_lo_ho``, ``adv_hor_muscl_r``, and
``adv_hor_muscl`` on the four components of ``fill_up_dn_grad``), the
vertical ones (``adv_ver_cdiff``; ``adv_ver_ppm`` on hnode_old !=
hnode_new, which JAX maps over the tracers one by one), the non-FCT
branch of ``solve_tracers`` with and without the w split, explicit
vertical diffusion (``i_vert_diff`` off), ``ops.edge_signed_reduce``,
the passive tracers (``bc_surface`` of id 101, the region restore on a
mask known to hold nodes, ``setup_passive_tracers``) and ``salt_plume``,
which also keeps each column's salt to rounding.

Every output is held within 1e-12 of its largest JAX magnitude; the JAX
functions run eagerly on the same arrays.
"""
import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fesom2_tpu.model as jmodel
from fesom2_tpu.core import ops as jops, tracers as jtr
from fesom2_tpu.core.state import OceanState as JOceanState, \
    Forcing as JForcing
from fesom2_tpu.core.tracer_setup import build_tracer_statics as jtst
from fesom2_tpu.mesh import build_mesh as jax_build_mesh

from fesom2_tpu_torch import model as tmodel
from fesom2_tpu_torch.convert import to_numpy
from fesom2_tpu_torch.core import ale, ops, tracers
from fesom2_tpu_torch.mesh import globe
from fesom2_tpu_torch.model import (pi_config, setup_pi_model,
                                    solve_tracers)
from fesom2_tpu_torch.run import globe_ocean_inputs, run_pi_ocean

from test_torch_dyn_menus import jax_config
from test_torch_kpp import assert_close

TOL = 1e-12


class Pair:
    """The JAX and the port side of one state."""


def to_jax(x, cls):
    return cls(**{k: jnp.asarray(v) for k, v in to_numpy(x).items()})


@pytest.fixture(scope="module")
def p(tmp_path_factory):
    torch.set_num_threads(1)
    q = Pair()
    path = q.path = globe.write_globe(str(tmp_path_factory.mktemp("globe")),
                                      level=3)
    cfg = pi_config()
    cfg.run.use_ice = False
    cfg.dyn.Fer_GM = cfg.dyn.Redi = False
    q.tcfg, q.cfg = cfg, jax_config(cfg)
    q.tm, _ = setup_pi_model(path, device="cpu", cfg=cfg)
    q.tmesh = q.tm.mesh
    q.jmesh = jax_build_mesh(path, force_rotation=True,
                             cyclic_length_deg=360.0, use_partial_cell=True,
                             partial_cell_thresh=0.0)
    q.tst = q.tm.tracer_statics
    q.jst = jtst(q.jmesh, K_hor=cfg.tra.K_hor)
    ts, tf, tsw = globe_ocean_inputs(q.tm, seed=0)
    # the state of the next step's tracer solve: after one step, its w
    # and hnode_new
    ts = run_pi_ocean(q.tm, ts, tf, tsw, 1)
    q.ts = ale.vert_vel_ale(ts, q.tmesh, cfg, tf)
    # a w split that acts: a third of w taken implicitly
    q.ts = dataclasses.replace(q.ts, w_i=q.ts.w / 3.0,
                               w_e=q.ts.w - q.ts.w / 3.0)
    lat = q.tmesh.geo_coords[:, 1]
    q.tf = dataclasses.replace(
        tf, thdgr=torch.where(lat > 0.3, 2e-7, -1e-7).to(tf.heat_flux),
        prec_rain=torch.full_like(tf.heat_flux, 3e-8))
    q.js = to_jax(q.ts, JOceanState)
    q.jf = to_jax(q.tf, JForcing)
    return q


def test_the_globe_has_columns_of_4_to_45_wet_layers(p):
    wet = p.tmesh.nlevels_node - 1
    assert int(wet.min()) == 4 and int(wet.max()) == 45
    assert float((p.ts.hnode_new - p.ts.hnode).abs().max()) > 0.0


def fields(p):
    """Two tracers and their AB interpolation, the edge transports."""
    t = p.ts.tr[:2]
    tAB = 1.6 * t - 0.6 * p.ts.tr_old[:2] + 0.01 * t.roll(1, -1)
    vflux = tracers._edge_vflux(p.ts.u, p.ts.v, p.ts.helem, p.tmesh)
    return t, tAB, vflux, jnp.asarray(to_numpy(t)), \
        jnp.asarray(to_numpy(tAB)), jnp.asarray(to_numpy(vflux))


def test_edge_vflux(p):
    assert_close(tracers._edge_vflux(p.ts.u, p.ts.v, p.ts.helem, p.tmesh),
                 jtr._edge_vflux(p.js.u, p.js.v, p.js.helem, p.jmesh),
                 "vflux", tol=TOL)


def test_upwind_horizontal_flux(p):
    t, tAB, vflux, jt, jtAB, jvflux = fields(p)
    prev = 0.1 * vflux
    got = tracers.adv_hor_upw1(t, p.ts.u, p.ts.v, p.ts.helem, p.tmesh,
                               flux_prev=prev)
    want = jtr.adv_hor_upw1(jt, p.js.u, p.js.v, p.js.helem, p.jmesh,
                            flux_prev=jnp.asarray(to_numpy(prev)))
    assert_close(got, want, "upw1", tol=TOL)
    assert_close(tracers.adv_hor_upw1(t, None, None, None, p.tmesh,
                                      vflux=vflux),
                 jtr.adv_hor_upw1(jt, None, None, None, p.jmesh,
                                  vflux=jvflux), "upw1 vflux", tol=TOL)
    lo, adf = tracers.adv_hor_lo_ho(t, tAB, vflux, p.tmesh, p.tst, None, 1.0,
                                    scheme="UPW1")
    jlo, jadf = jtr.adv_hor_lo_ho(jt, jtAB, jvflux, p.jmesh, p.jst, None,
                                  1.0, scheme="UPW1")
    assert_close(lo, jlo, "lo", tol=TOL)
    assert_close(adf, jadf, "adf", tol=TOL)
    assert float(adf.abs().max()) > 0.0


@pytest.mark.parametrize("scheme", ["MUSCL", "MFCT"])
def test_muscl_horizontal_fluxes(p, scheme):
    t, tAB, vflux, jt, jtAB, jvflux = fields(p)
    gx, gy = tracers.tracer_gradient_elements(tAB, p.tmesh)
    jgx, jgy = jtr.tracer_gradient_elements(jtAB, p.jmesh)
    fb = scheme == "MUSCL"
    eg = tracers.fill_up_dn_grad(gx, gy, p.tmesh, p.tst)
    jeg = jtr.fill_up_dn_grad(jgx, jgy, p.jmesh, p.jst)
    for k in range(4):
        assert_close(eg[k], jeg[k], f"eg{k}", tol=TOL)
    num_ord = p.tcfg.tra.tra_adv_ph
    got = tracers.adv_hor_muscl(tAB, p.ts.u, p.ts.v, p.ts.helem, p.tmesh,
                                p.tst, eg, num_ord, flux_prev=0.2 * vflux,
                                boundary_fallback=fb)
    want = jtr.adv_hor_muscl(jtAB, p.js.u, p.js.v, p.js.helem, p.jmesh,
                             p.jst, jeg, num_ord, flux_prev=0.2 * jvflux,
                             boundary_fallback=fb)
    assert_close(got, want, "muscl", tol=TOL)
    rec = tracers.fill_up_dn_grad_r(gx, gy, p.tmesh, p.tst)
    jrec = jtr.fill_up_dn_grad_r(jgx, jgy, p.jmesh, p.jst)
    got = tracers.adv_hor_muscl_r(tAB, vflux, p.tmesh, p.tst, rec, num_ord,
                                  boundary_fallback=fb)
    want = jtr.adv_hor_muscl_r(jtAB, jvflux, p.jmesh, p.jst, jrec, num_ord,
                               boundary_fallback=fb)
    assert_close(got, want, "muscl_r", tol=TOL)
    # the folded pair is the four components folded
    dx, dy = tracers._muscl_dxdy(p.tmesh)
    assert_close(rec[0], to_numpy(dx * eg[0] + dy * eg[2]), "R1", tol=1e-14)


@pytest.mark.parametrize("prev", [False, True], ids=["alone", "flux_prev"])
def test_vertical_cdiff(p, prev):
    t, tAB, _, jt, jtAB, _ = fields(p)
    fp = tracers.adv_ver_upw1(t, p.ts.w, p.tmesh) if prev else None
    got = tracers.adv_ver_cdiff(tAB, p.ts.w, p.tmesh, flux_prev=fp)
    want = jtr.adv_ver_cdiff(jtAB, p.js.w, p.jmesh, flux_prev=None if fp is
                             None else jnp.asarray(to_numpy(fp)))
    assert_close(got, want, "cdiff", tol=TOL)


@pytest.mark.parametrize("prev", [False, True], ids=["alone", "flux_prev"])
def test_vertical_ppm_per_tracer(p, prev):
    """JAX maps adv_ver_ppm over the tracers with a flux_prev each; the
    port takes the stack at once."""
    t, tAB, _, jt, jtAB, _ = fields(p)
    fp = tracers.adv_ver_upw1(t, p.ts.w, p.tmesh) if prev else None
    dt = p.tcfg.dt
    got = tracers.adv_ver_ppm(tAB, p.ts.w, p.ts.hnode, p.ts.hnode_new,
                              p.tmesh, dt, flux_prev=fp)
    assert got.shape == (2, p.tmesh.nl, p.tmesh.n_nodes)
    for i in range(2):
        want = jtr.adv_ver_ppm(jtAB[i], p.js.w, p.js.hnode, p.js.hnode_new,
                               p.jmesh, dt, flux_prev=None if fp is None
                               else jnp.asarray(to_numpy(fp[i])))
        assert_close(got[i], want, f"ppm {i}", tol=TOL)
    assert float(got.abs().max()) > 0.0


def test_vertical_ppm_on_columns_of_2_to_45_wet_layers(p):
    """PPM reaches its last layers through ``nlevels_node``: the same
    state on a mesh whose columns are cut to 2, 3, 4 and 5 wet layers in
    turn, and left as they are (up to 45) at every fifth node."""
    t, tAB, _, jt, jtAB, _ = fields(p)
    nln = p.tmesh.nlevels_node
    n = torch.arange(p.tmesh.n_nodes)
    cut = torch.where(n % 5 == 4, nln,
                      torch.minimum(nln, (n % 5 + 3).to(nln.dtype)))
    lay = torch.arange(p.tmesh.nl - 1)[:, None]
    mask = lay < (cut - 1)[None, :]
    tmesh = dataclasses.replace(p.tmesh, nlevels_node=cut,
                                node_layer_mask=mask)
    jmesh = dataclasses.replace(p.jmesh, nlevels_node=jnp.asarray(cut.numpy()),
                                node_layer_mask=jnp.asarray(mask.numpy()))
    assert set((cut - 1).tolist()) >= {2, 3, 4, 5, 45}
    got = tracers.adv_ver_ppm(tAB, p.ts.w, p.ts.hnode, p.ts.hnode_new, tmesh,
                              p.tcfg.dt)
    for i in range(2):
        want = jtr.adv_ver_ppm(jtAB[i], p.js.w, p.js.hnode, p.js.hnode_new,
                               jmesh, p.tcfg.dt)
        assert_close(got[i], want, f"ppm {i}", tol=TOL)


def test_edge_signed_reduce(p):
    _, _, vflux, _, _, jvflux = fields(p)
    for fn, jfn in ((lambda v: v.clamp_min(0.0),
                     lambda v: jnp.maximum(v, 0.0)),
                    (lambda v: v * v, lambda v: v * v)):
        assert_close(ops.edge_signed_reduce(vflux, p.tmesh, fn),
                     jops.edge_signed_reduce(jvflux, p.jmesh, jfn),
                     "edge_signed_reduce", tol=TOL)
    plus, minus = ops.edge_signed_reduce2(vflux, p.tmesh)
    assert torch.equal(plus, ops.edge_signed_reduce(
        vflux, p.tmesh, lambda v: v.clamp_min(0.0)))
    assert torch.equal(minus, ops.edge_signed_reduce(
        vflux, p.tmesh, lambda v: v.clamp_max(0.0)))


def test_bc_surface_of_the_passive_tracers(p):
    top = p.ts.tr[0, 0]
    for tid in (101, 301, 302, 303, 7):
        got = tracers.bc_surface(tid, top, p.tf, p.tcfg.dt, 1.0)
        want = jtr.bc_surface(tid, p.js.tr[0, 0], p.jf, p.tcfg.dt, 1.0)
        assert_close(got, want, f"bc {tid}", tol=0.0)
    assert float(tracers.bc_surface(101, top, p.tf, p.tcfg.dt, 1.0).min()) \
        > 0.0


def column_salt(S, h, mesh):
    return (torch.where(mesh.node_layer_mask, S * h, 0.0)
            * mesh.areasvol[:-1]).sum(0)


def test_salt_plume_matches_jax_and_keeps_each_column_s_salt(p):
    S = p.ts.tr[1]
    got = tracers.salt_plume(S, p.ts, p.tmesh, p.tf, p.tcfg)
    want = jtr.salt_plume(p.js.tr[1], p.js, p.jmesh, p.jf, p.cfg)
    assert_close(got, want, "salt_plume", tol=TOL)
    moved = (got - S).abs().amax(0) > 0
    assert int(moved.sum()) > 10
    # northern columns only, where ice grows
    lat = p.tmesh.geo_coords[:, 1]
    assert bool((lat[moved] > 0).all())
    before = column_salt(S, p.ts.hnode, p.tmesh)
    after = column_salt(got, p.ts.hnode, p.tmesh)
    rel = float(((after - before).abs() / before.abs().clamp_min(1e-300))
                .max())
    assert rel <= 8e-16, rel


def solve_pair(p, tcfg, ts=None, ptr=None):
    """solve_tracers of both packages on the same state and forcing."""
    ts = p.ts if ts is None else ts
    js = to_jax(ts, JOceanState)
    jm = [(i, jnp.asarray(to_numpy(m))) for i, m in ptr] if ptr else None
    got = solve_tracers(ts, p.tmesh, tcfg, p.tst, p.tf, 1.0, ptr_masks=ptr)
    want = jmodel.solve_tracers(js, p.jmesh, jax_config(tcfg), p.jst, p.jf,
                                1.0, ptr_masks=jm)
    for name in ("tr", "tr_old"):
        assert_close(getattr(got, name), getattr(want, name), name, tol=TOL)
    return got


MENUS = {
    "no_limiter": dict(tra_adv_lim="NONE"),
    "no_limiter_w_split": dict(tra_adv_lim="NONE", w_split=True),
    "no_limiter_upw1": dict(tra_adv_lim="NONE", tra_adv_hor="UPW1",
                            tra_adv_ver="UPW1"),
    "no_limiter_muscl_ppm": dict(tra_adv_lim="NONE", tra_adv_hor="MUSCL",
                                 tra_adv_ver="PPM"),
    "upw1_fct": dict(tra_adv_hor="UPW1"),
    "unknown_hor_is_upw1": dict(tra_adv_hor="FOO"),
    "cdiff_fct": dict(tra_adv_ver="CDIFF"),
    "ppm_fct": dict(tra_adv_ver="PPM"),
    "upw1_ver_fct": dict(tra_adv_ver="UPW1"),
    "no_vertical_diffusion": dict(i_vert_diff=False),
    "salt_plume": dict(SPP=True),
}


@pytest.mark.parametrize("menu", list(MENUS))
def test_solve_tracers_menu(p, menu):
    tcfg = copy.deepcopy(p.tcfg)
    tcfg.dyn.w_split = False
    for k, v in MENUS[menu].items():
        setattr(tcfg.dyn if hasattr(tcfg.dyn, k) else tcfg.tra, k, v)
    got = solve_pair(p, tcfg)
    assert not torch.equal(got.tr, p.ts.tr)


def test_the_w_split_reaches_the_unlimited_vertical_diffusion(p):
    """Without FCT, w_i is solved with the vertical diffusion: the split
    changes the answer."""
    tcfg = copy.deepcopy(p.tcfg)
    tcfg.tra.tra_adv_lim = "NONE"
    tcfg.dyn.w_split = True
    split = solve_tracers(p.ts, p.tmesh, tcfg, p.tst, p.tf, 1.0).tr
    tcfg.dyn.w_split = False
    whole = solve_tracers(p.ts, p.tmesh, tcfg, p.tst, p.tf, 1.0).tr
    assert float((split - whole).abs().max()) > 1e-10


def six_tracer_config(p):
    tcfg = copy.deepcopy(p.tcfg)
    tcfg.tra.num_tracers = 6
    tcfg.tra.tracer_ID = [0, 1, 101, 301, 302, 303]
    return tcfg


def test_passive_tracers_with_a_known_region(p):
    """The restore on a mask of 12 northern nodes (the strait boxes may
    hold no node of the level-3 globe), the rain tracer fed by prec_rain,
    and solve_tracers' six-tracer stack against JAX."""
    tcfg = six_tracer_config(p)
    lat = p.tmesh.geo_coords[:, 1]
    mask = torch.zeros_like(lat, dtype=torch.bool)
    mask[torch.nonzero(lat > 1.0)[:12, 0]] = True
    assert int(mask.sum()) == 12
    nmask = p.tmesh.node_layer_mask
    region = mask[None, :] & nmask
    held = torch.where(region, 1.0, 0.0).to(p.ts.tr)
    zero = torch.zeros_like(held)
    tr = torch.stack([p.ts.tr[0], p.ts.tr[1], zero, held, zero, held])
    ts = dataclasses.replace(p.ts, tr=tr, tr_old=tr)
    got = solve_pair(p, tcfg, ts, ptr=[(3, mask), (5, mask)])
    assert bool((got.tr[3][region] == 1.0).all())
    assert bool((got.tr[5][region] == 1.0).all())
    assert float(got.tr[3][nmask & ~region].abs().max()) > 0.0
    assert float(got.tr[2].sum()) > 0.0          # rain water entered
    assert float(got.tr[4].abs().max()) == 0.0   # no source, no region
    assert torch.equal(got.tr[3], got.tr[5])


def test_setup_passive_tracers_matches_jax(p):
    """The region masks and the initial passive tracers of both packages
    on the same mesh, with the strait boxes as they are and with one
    widened so that it holds nodes of the level-3 globe."""
    tcfg = six_tracer_config(p)
    jm = jmodel.Model(mesh=p.jmesh, cfg=jax_config(tcfg),
                      tracer_statics=p.jst, ssh_diag_inv=None,
                      density_ref=None)
    wide = {**tmodel.PTRACER_REGIONS, 302: (30.0, 80.0, -180.0, 180.0)}
    for reg in (dict(tmodel.PTRACER_REGIONS), wide):
        saved = (jmodel.PTRACER_REGIONS, tmodel.PTRACER_REGIONS)
        jmodel.PTRACER_REGIONS = tmodel.PTRACER_REGIONS = reg
        try:
            tm, _ = setup_pi_model(p.path, device="cpu", cfg=tcfg)
            ts = tm.initial_state()
            js = jm.initial_state()
        finally:
            jmodel.PTRACER_REGIONS, tmodel.PTRACER_REGIONS = saved
        assert tm.ptr_idx == [i for i, _ in jm.ptracer_masks] == [3, 4, 5]
        for m, (_, jmask) in zip(tm.ptr_masks, jm.ptracer_masks):
            assert np.array_equal(m.numpy(), np.asarray(jmask))
        assert_close(ts.tr, js.tr, "tr", tol=0.0)
        assert_close(ts.tr_old, js.tr_old, "tr_old", tol=0.0)
    assert int(tm.ptr_masks[1].sum()) > 10
    assert float(ts.tr[4].sum()) > 0.0
