"""Ice-shelf cavities in the port against the JAX package (CPU, float64),
on the level-3 globe with the shelf of ``globe.shelf_draft``: a draft of
250 m under the 21 of its 501 nodes south of 62S, which puts the top of
39 nodes' and 66 elements' columns below the surface.  12 layers down to
1,000 m as in the coupled tests, 47 for the mesh checks that
``tests/test_cavity.py`` makes on the pi mesh.

The mesh tables equal JAX's array for array.  Two faults of the JAX
package under a shelf are repaired in the port, each with its test: its
cavity levels can leave a node's water column with dry layers inside it
(none on the level-3 shelf, over 50 nodes on the level-6 one), which
``mesh.tables.close_column_gaps`` closes; and its ice FEM-FCT divides the
flux into a cavity node (no surface area) by 1e-30, which overflows
float32, where the port gives that node's elements no antidiffusive
flux (float64: JAX's result to 1e-12 outside the cavity).  The modules
start from the
JAX state after one coupled step and agree to 1e-12 of their largest JAX
magnitude: ``core/cavity.py`` (the UNESCO in-situ temperature, the 3- and
2-equation melt fluxes, the shelf drag, the ice clean-up),
``pressure_bv``, KPP, FCT a1-a3 and the limiter, ``elem_to_node_mean``,
the 'sergey' PGF and the other two forms linfs takes with cavity partial
cells.  FCT a1-a3 is held bit for bit against a numpy transcription of
JAX's a1-a3 (``fesom2_tpu/core/tracers.py:570-618``) on the JAX mesh.

Three coupled CI steps agree to the tolerances of
``tests/test_torch_coupled.py``: 1e-9 dense with 120 mEVP subcycles, 1e-8
with CG forced.  Kv and Av are compared on the interfaces the column
has: above a cavity's top, KPP (which both packages run from the surface
down, ``fesom2_tpu/core/mixing/kpp.py:164``) fills rows that no other
part of the step reads, from zero shear and stratification, and there
the two packages part by up to 2.4e-7 of max|Kv| within three steps while
every field the step carries agrees to 1e-12.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fesom2_tpu.model as jmodel
from fesom2_tpu.core import cavity as jcav, dynamics as jdyn, eos as jeos
from fesom2_tpu.core import ops as jops, tracers as jtr
from fesom2_tpu.core.mixing import kpp as jkpp
from fesom2_tpu.ice.state import IceState as JIceState
from fesom2_tpu.ice import fct as jfct
from fesom2_tpu.mesh import build_mesh as jax_build_mesh
from fesom2_tpu.mesh import tables as jtables

from fesom2_tpu_torch import kernels
from fesom2_tpu_torch.convert import to_numpy
from fesom2_tpu_torch.core import cavity, dynamics, eos, ops, tracers
from fesom2_tpu_torch.core.mixing import kpp
from fesom2_tpu_torch.core.state import Forcing
from fesom2_tpu_torch.ice import fct
from fesom2_tpu_torch.mesh import build_mesh, globe, read_raw_mesh
from fesom2_tpu_torch.mesh.tables import (close_column_gaps,
                                          derive_ulevels_cavity)
from fesom2_tpu_torch.model import (pi_config, pi_coupled_step_fn,
                                    setup_pi_model)

from test_torch_ci_ocean import FIELDS, to_port
from test_torch_coupled import (FLUXES, ICE_FIELDS, assert_ice_alive,
                                coupled_pair, run_both)
from test_torch_dyn_menus import jax_config
from test_torch_kpp import assert_close

TOL = 1e-12
PC = dict(force_rotation=True, cyclic_length_deg=360.0,
          use_partial_cell=True, partial_cell_thresh=0.0)
MIXING = ("Kv", "Av")


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    torch.set_num_threads(1)
    return globe.write_globe(str(tmp_path_factory.mktemp("shelf")), level=3,
                             n_layers=12, dz_bottom=1000.0, shelf=True)


@pytest.fixture(scope="module")
def path47(tmp_path_factory):
    return globe.write_globe(str(tmp_path_factory.mktemp("shelf47")),
                             level=3, shelf=True)


def cavity_config(**ice):
    cfg = pi_config()
    cfg.run.use_cavity = True
    for k, v in ice.items():
        setattr(cfg.ice, k, v)
    return cfg


@pytest.fixture(scope="module")
def pair(path):
    """The coupled pair with the shelf, and the JAX state, ice and ocean
    forcing after one coupled step (js1, jice1, jof1), with the port's
    copies (ts1, tof1)."""
    p = coupled_pair(path, cavity_config())
    jstep = jmodel.pi_coupled_step_fn(p.jm, p.jatm)
    p.js1, p.jice1, p.jof1 = jstep(p.js0, p.jice0, jnp.asarray(0))
    p.ts1 = to_port(p.js1)
    p.tof1 = Forcing(**{k: torch.tensor(np.asarray(v))
                        for k, v in dataclasses.asdict(p.jof1).items()})
    p.jmesh, p.tmesh = p.jm.mesh, p.tm.mesh
    p.cav_n = p.tmesh.ulevels_node > 1
    p.cav_e = p.tmesh.ulevels_elem > 1
    return p


def t(x):
    return torch.tensor(np.asarray(x))


# --------------------------------------------------------------------------
# the mesh
# --------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["path", "path47"])
def test_cavity_mesh_equals_jax(request, which):
    p = request.getfixturevalue(which)
    tm = build_mesh(p, device="cpu", **PC)
    jm = jax_build_mesh(p, **PC)
    for f in dataclasses.fields(jm):
        want = getattr(jm, f.name)
        if not hasattr(want, "shape"):
            continue
        got = getattr(tm, f.name).numpy()
        assert np.array_equal(got, np.asarray(want)), f.name
    uln = tm.ulevels_node.numpy()
    assert int((uln > 1).sum()) == 39 and int((tm.ulevels_elem > 1).sum()) == 66
    # the volume area of a cavity node's top layer is its lower face's
    top = tm.areasvol.numpy()[uln - 1, np.arange(tm.n_nodes)]
    assert (top > 0).all()
    assert not np.array_equal(tm.areasvol.numpy(), tm.area.numpy())


def test_mesh_checks_of_test_cavity(path47):
    """``tests/test_cavity.py::test_ulevels_derivation``'s assertions on the
    port's mesh of the 47-layer shelf globe."""
    raw = read_raw_mesh(path47, force_rotation=True)
    cd = globe.shelf_draft(raw)
    assert np.array_equal(cd, raw.cavity_depth)
    mesh = build_mesh(path47, device="cpu", **PC)
    uln = mesh.ulevels_node.numpy()
    ule = mesh.ulevels_elem.numpy()
    nle = mesh.nlevels_elem.numpy()
    assert (uln >= 1).all() and (ule >= 1).all()
    assert (ule > 1).any()
    assert (nle - ule >= 3).all()
    Z = mesh.Z.numpy()
    en = mesh.elem_nodes.numpy()
    full_draft = (cd[en] < 0).all(axis=1)
    deep = full_draft & (nle - 1 - np.searchsorted(-Z, 250.0) >= 4)
    assert deep.any()
    assert (Z[ule[deep] - 1] < -250.0).mean() > 0.6
    enb = mesh.elem_neighbors.numpy()
    has2nb = (enb >= 0).sum(1) >= 2
    for nz in range(1, int(ule.max()) + 1):
        active = (ule <= nz) & (nz < nle)
        nb_open = (enb >= 0) & active[np.clip(enb, 0, None)]
        assert (active & has2nb & (nb_open.sum(1) < 2)).sum() == 0, nz
    lm = mesh.node_layer_mask.numpy()
    nln = mesh.nlevels_node.numpy()
    for n in np.nonzero(uln > 1)[0]:
        assert not lm[:uln[n] - 1, n].any()
        assert lm[uln[n] - 1:nln[n] - 1, n].all()
    assert (mesh.area[0].numpy()[uln > 1] == 0.0).all()


def test_setup_with_a_draft_turns_the_cavities_on(path, tmp_path):
    """``setup_pi_model(cavity_depth=...)`` on the globe without its
    ``cavity_depth.out`` builds the mesh the file gives and turns
    ``use_cavity`` on; the configuration without cavities passes
    ``check_slice`` with ``use_cavity``, ``use_cavity_partial_cell`` and
    the 'sergey' PGF."""
    plain = globe.write_globe(str(tmp_path), level=3, n_layers=12,
                              dz_bottom=1000.0)
    cd = globe.shelf_draft(read_raw_mesh(plain))
    cfg = pi_config()
    assert not cfg.run.use_cavity
    tm, _ = setup_pi_model(plain, device="cpu", cfg=cfg, cavity_depth=cd)
    assert cfg.run.use_cavity and tm.cfg.run.use_cavity
    want = build_mesh(path, device="cpu", **PC)
    for name in ("ulevels_node", "ulevels_elem", "areasvol",
                 "node_layer_mask", "elem_layer_mask"):
        assert torch.equal(getattr(tm.mesh, name), getattr(want, name)), name
    off, _ = setup_pi_model(plain, device="cpu", cfg=pi_config())
    assert int(off.mesh.ulevels_node.max()) == 1
    assert not off.cfg.run.use_cavity


def column_gaps(ule, nle, elem_nodes, n_nodes):
    """Nodes whose elements' layers [ule - 1, nle - 1) are not one run."""
    L = int(nle.max())
    lay = np.arange(L)[:, None]
    wet = (lay >= ule - 1) & (lay < nle - 1)                # [L, E]
    cover = np.zeros((L, n_nodes), bool)
    for j in range(3):
        np.logical_or.at(cover.T, elem_nodes[:, j], wet.T)
    first = cover.argmax(0)
    last = L - 1 - cover[::-1].argmax(0)
    inside = (lay >= first) & (lay <= last)
    return int((inside & ~cover).any(0).sum())


def node_elements(en, n_nodes):
    """nod_in_elem [N, K] of a small element list, padded with -1."""
    lists = [[e for e in range(en.shape[0]) if n in en[e]]
             for n in range(n_nodes)]
    K = max(len(x) for x in lists)
    return np.array([x + [-1] * (K - len(x)) for x in lists])


def test_close_column_gaps_on_crafted_columns():
    """A fan of three elements around node 0, wet on [0, 3), [5, 7) and
    [9, 12) (nodes 0, 2 and 3 see gaps): each top rises to where the runs
    above it end; runs that meet stay."""
    en = np.array([[0, 1, 2], [0, 2, 3], [0, 3, 4]])
    nie = node_elements(en, 5)
    nle = np.array([4, 8, 13])
    ule = close_column_gaps(np.array([1, 6, 10]), nle, nie)
    assert ule.tolist() == [1, 4, 8]
    assert close_column_gaps(ule, nle, nie).tolist() == [1, 4, 8]
    assert column_gaps(ule, nle, en, 5) == 0
    assert column_gaps(np.array([1, 6, 10]), nle, en, 5) == 3


def test_cavity_columns_without_gaps_on_the_level6_shelf(tmp_path):
    """On the level-6 globe (47 layers) under the shelf, JAX's
    ``derive_ulevels_cavity`` leaves nodes whose water column has dry
    layers inside it (an element's cavity top below a shallow neighbour's
    bottom; the node's area is 0 there and the coupled step blows up).
    The port's ``derive_ulevels_cavity`` is JAX's, and its mesh takes
    those levels with the tops raised (``close_column_gaps``): no gap, no
    wet node-level without area, every other element as JAX has it.  The
    level-3 shelf has no gap, so there the meshes are the same
    (``test_cavity_mesh_equals_jax``)."""
    plain = globe.write_globe(str(tmp_path), level=6)
    m = build_mesh(plain, device="cpu", **PC)
    cd = globe.shelf_draft(read_raw_mesh(plain))
    en = m.elem_nodes.numpy().astype(np.int64)
    nle = m.nlevels_elem.numpy().astype(np.int64)
    args = (cd, en, m.elem_neighbors.numpy().astype(np.int64), nle,
            m.zbar.numpy())
    ju, jn = jtables.derive_ulevels_cavity(*args)
    for want, got in zip((ju, jn), derive_ulevels_cavity(*args)):
        assert np.array_equal(got, want)
    N = m.n_nodes
    nie = m.nod_in_elem.numpy().astype(np.int64)
    tu = close_column_gaps(ju, nle, nie)
    assert column_gaps(ju, nle, en, N) > 50
    assert column_gaps(tu, nle, en, N) == 0
    assert (tu <= ju).all() and 0 < int((tu != ju).sum()) < 300
    assert (nle - tu >= 3).all()
    shelf = build_mesh(plain, device="cpu", cavity_depth=cd, **PC)
    assert np.array_equal(shelf.ulevels_elem.numpy(), tu)
    tn = np.full(N, m.nl)
    for j in range(3):
        np.minimum.at(tn, en[:, j], tu)
    assert np.array_equal(shelf.ulevels_node.numpy(), tn)
    wet = shelf.node_layer_mask.numpy()
    assert (shelf.area.numpy()[:-1][wet] > 0).all()


# --------------------------------------------------------------------------
# core/cavity.py
# --------------------------------------------------------------------------
def test_in_situ_temperature_matches_jax():
    rng = np.random.default_rng(3)
    s = rng.uniform(30.0, 36.0, 200)
    pt = rng.uniform(-2.5, 4.0, 200)
    p = rng.uniform(0.0, 2000.0, 200)
    for name, args in (("adlprt", (s, pt, p)), ("pttmpr", (s, pt, p, 0.0)),
                       ("potit", (s, pt, p))):
        got = getattr(cavity, name)(*(torch.tensor(a) if isinstance(a, np.ndarray)
                                      else a for a in args))
        want = getattr(jcav, name)(*(jnp.asarray(a) for a in args))
        assert_close(got, want, name, tol=TOL)


def test_melt_fluxes_drag_and_ice_clean_match_jax(pair):
    p = pair
    s = dynamics.compute_vel_nodes(p.ts1, p.tmesh)
    js = jdyn.compute_vel_nodes(p.js1, p.jmesh)
    got = cavity.cavity_heat_water_fluxes_3eq(s, p.tmesh, p.tm.density_ref)
    want = jax.jit(lambda st: jcav.cavity_heat_water_fluxes_3eq(
        st, p.jmesh, p.jm.density_ref))(js)
    for name, a, b in zip(("heat_flux", "water_flux"), got, want):
        assert_close(a, b, name, tol=TOL)
    hf, wf = got
    assert not hf[~p.cav_n].any() and not wf[~p.cav_n].any()
    assert float(hf[p.cav_n].abs().max()) > 0.0
    assert float(wf.abs().max()) < 100.0 / (365 * 86400) * 30
    got2 = cavity.cavity_heat_water_fluxes_2eq(s, p.tmesh)
    want2 = jcav.cavity_heat_water_fluxes_2eq(js, p.jmesh)
    for name, a, b in zip(("heat_flux_2eq", "water_flux_2eq"), got2, want2):
        assert_close(a, b, name, tol=TOL)
    assert torch.equal(torch.sign(got2[1][p.cav_n]),
                       -torch.sign(got2[0][p.cav_n]))
    sx, sy = cavity.cavity_momentum_fluxes(p.ts1, p.tmesh, p.cfg)
    jsx, jsy = jcav.cavity_momentum_fluxes(p.js1, p.jmesh, p.cfg)
    assert_close(sx, jsx, "drag_x", tol=TOL)
    assert_close(sy, jsy, "drag_y", tol=TOL)
    assert float(sx[p.cav_e].abs().max()) > 0.0 and not sx[~p.cav_e].any()
    # the clean-up on an ice state with ice everywhere
    ice = dataclasses.replace(p.tice0, a_ice=torch.full_like(
        p.tice0.a_ice, 0.5), m_ice=torch.ones_like(p.tice0.m_ice))
    clean = cavity.cavity_ice_clean(ice, p.tmesh)
    jclean = jcav.cavity_ice_clean(JIceState(**{
        k: jnp.asarray(v) for k, v in to_numpy(ice).items()}), p.jmesh)
    for name in ICE_FIELDS:
        assert torch.equal(getattr(clean, name),
                           t(getattr(jclean, name))), name
    assert not clean.a_ice[p.cav_n].any() and bool(
        (clean.a_ice[~p.cav_n] == 0.5).all())


# --------------------------------------------------------------------------
# the column and cluster code of the ocean step on the shelf
# --------------------------------------------------------------------------
def test_pressure_bv_matches_jax_on_the_shelf(pair):
    p = pair
    kernels.reset_launches()
    got = eos.pressure_bv(p.ts1, p.tmesh, p.cfg, p.tm.density_ref)
    assert kernels.LAUNCHES["pressure_bv"] == 0
    want = jax.jit(lambda st: jeos.pressure_bv(st, p.jmesh, p.cfg,
                                               p.jm.density_ref))(p.js1)
    for name in ("density_m_rho0", "hpressure", "bvfreq", "dbsfc", "mld2"):
        assert_close(getattr(got, name), getattr(want, name), name, tol=TOL)
    # the pressure starts at each column's top; the top copies N^2 below
    uln0 = p.tmesh.ulevels_node.long() - 1
    n = torch.nonzero(p.cav_n)[:, 0]
    assert torch.equal(got.bvfreq[uln0[n], n], got.bvfreq[uln0[n] + 1, n])
    from fesom2_tpu_torch.constants import g
    assert not got.hpressure[0, n].any()
    assert torch.equal(got.hpressure[uln0[n], n],
                       -p.ts1.Z_3d[uln0[n], n]
                       * got.density_m_rho0[uln0[n], n] * g)


def test_kpp_matches_jax_on_the_shelf(pair):
    p = pair
    jf = p.jof1
    js = jax.jit(lambda st, f: jkpp.oce_mixing_kpp(st, p.jmesh, p.cfg, f))(
        p.js1, jf)
    kernels.reset_launches()
    ts = kpp.oce_mixing_kpp(p.ts1, p.tmesh, p.cfg, p.tof1)
    assert kernels.LAUNCHES["kpp_column"] == 0
    for name in ("Av", "Kv", "kpp_nonloc"):
        assert_close(getattr(ts, name), getattr(js, name), name, tol=TOL)


def fct_a1_a3(ttf, lo, jmesh):
    """JAX's fct_limiter steps a1-a3 (``fesom2_tpu/core/tracers.py:
    570-618``) in numpy on the JAX mesh: node, element and cluster bounds
    with the -1e3 / +1e3 filler, the +-1 layer widening on layers
    1..nlevels_node-3, the increments on wet cells."""
    big = 1e3
    nmask = np.asarray(jmesh.node_layer_mask)
    emask = np.asarray(jmesh.elem_layer_mask)
    en = np.asarray(jmesh.elem_nodes)
    nie = np.asarray(jmesh.nod_in_elem)
    tmax = np.where(nmask, np.maximum(lo, ttf), -big)
    tmin = np.where(nmask, np.minimum(lo, ttf), big)
    emax = np.where(emask, tmax[..., en].max(-1), -big)
    emin = np.where(emask, tmin[..., en].min(-1), big)
    valid = nie >= 0
    safe = np.where(valid, nie, 0)
    cmax = np.where(valid, emax[..., safe], -big).max(-1)
    cmin = np.where(valid, emin[..., safe], big).min(-1)
    up = lambda c: np.concatenate([c[..., :1, :], c[..., :-1, :]], -2)
    dn = lambda c: np.concatenate([c[..., 1:, :], c[..., -1:, :]], -2)
    lay = np.arange(nmask.shape[0])[:, None]
    interior = (lay >= 1) & (lay <= np.asarray(jmesh.nlevels_node) - 3)
    vmax = np.where(interior, np.maximum(cmax, np.maximum(up(cmax),
                                                          dn(cmax))), cmax)
    vmin = np.where(interior, np.minimum(cmin, np.minimum(up(cmin),
                                                          dn(cmin))), cmin)
    return np.where(nmask, vmax - lo, 0.0), np.where(nmask, vmin - lo, 0.0)


def test_fct_bounds_and_limiter_on_the_shelf(pair):
    p = pair
    rng = np.random.default_rng(9)
    L, N = p.tmesh.nl - 1, p.tmesh.n_nodes
    tr = to_numpy(p.ts1.tr)
    ttf = tr + rng.uniform(-0.5, 0.5, tr.shape)
    lo = tr + rng.uniform(-0.5, 0.5, tr.shape)
    got = tracers.fct_bounds_plain(t(ttf), t(lo), p.tmesh)
    want = fct_a1_a3(ttf, lo, p.jmesh)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), b)
    # the limiter as a whole
    adf_h = rng.uniform(-1e4, 1e4, (2, L, p.tmesh.n_edges))
    adf_v = rng.uniform(-1e4, 1e4, (2, L + 1, N))
    dt = p.cfg.dt
    got = tracers.fct_limiter(t(ttf), t(lo), t(adf_h), t(adf_v), p.tmesh, dt)
    want = jax.jit(lambda *a: jtr.fct_limiter(*a, p.jmesh, dt))(
        *(jnp.asarray(x) for x in (ttf, lo, adf_h, adf_v)))
    for name, a, b in zip(("adf_h", "adf_v"), got, want):
        assert_close(a, b, name, tol=TOL)


@pytest.mark.parametrize("respect_levels", [True, False])
def test_elem_to_node_mean_on_the_shelf(pair, respect_levels):
    p = pair
    x = np.stack([np.asarray(p.js1.u), np.asarray(p.js1.v)])
    got = ops.elem_to_node_mean(t(x), p.tmesh, respect_levels)
    want = jops.elem_to_node_mean(jnp.asarray(x), p.jmesh,
                                  respect_levels=respect_levels)
    assert_close(got, want, "elem_to_node_mean", tol=TOL)


def test_ice_fct_beside_the_shelf(pair):
    """The ice's FEM-FCT advection with ice on and around the cavity nodes
    (which have no surface area): float64 within 1e-12 of JAX's, which
    divides their antidiffusive flux by 1e-30; float32 finite, where that
    division overflows to inf and the JAX formula gives NaN."""
    p = pair
    rng = np.random.default_rng(12)
    N = p.tmesh.n_nodes
    fields = np.stack([rng.uniform(0.0, 2.0, N), rng.uniform(0.0, 1.0, N),
                       rng.uniform(0.0, 0.3, N)])
    uv = rng.uniform(-0.2, 0.2, (2, N))
    dt = p.cfg.dt
    got = fct.fct_advect_fields(t(uv[0]), t(uv[1]), t(fields), p.tmesh, 0.3,
                                dt)
    want = jfct.fct_advect_fields(jnp.asarray(uv[0]), jnp.asarray(uv[1]),
                                  jnp.asarray(fields), p.jmesh, 0.3, dt)
    open_n = ~p.cav_n
    assert_close(got[:, open_n], np.asarray(want)[:, open_n.numpy()],
                 "ice fields", tol=TOL)
    assert torch.isfinite(got).all()
    m32 = dataclasses.replace(p.tmesh, **{
        f.name: getattr(p.tmesh, f.name).float()
        for f in dataclasses.fields(p.tmesh)
        if isinstance(getattr(p.tmesh, f.name), torch.Tensor)
        and getattr(p.tmesh, f.name).is_floating_point()})
    got32 = fct.fct_advect_fields(t(uv[0]).float(), t(uv[1]).float(),
                                  t(fields).float(), m32, 0.3, dt)
    assert torch.isfinite(got32).all()
    assert float((got32[:, open_n].double() - got[:, open_n]).abs().max()) \
        < 1e-4 * float(got.abs().max())


def test_kernels_tables_build_on_the_shelf(pair):
    """The cluster tables of the shelf mesh hold its masks as ranges."""
    ct = pair.tmesh.cluster
    info = ct.fct_node.numpy().astype(np.int64) & 0xFFFFFFFF
    lay = np.arange(pair.tmesh.nl - 1)[:, None]
    assert np.array_equal((lay >= ((info >> 16) & 0xFF)) & (lay < info >> 24),
                          pair.tmesh.node_layer_mask.numpy())


# --------------------------------------------------------------------------
# the PGF of linfs with cavity partial cells
# --------------------------------------------------------------------------
def linfs_cavity_config(which):
    cfg = pi_config("fast")
    cfg.run.use_cavity = True
    cfg.run.use_cavity_partial_cell = True
    cfg.dyn.which_pgf = which
    return cfg


@pytest.mark.parametrize("which", ["sergey", "shchepetkin", "easypgf"])
def test_cavity_pgf_forms_match_jax(pair, which):
    p = pair
    tcfg = linfs_cavity_config(which)
    jcfg = jax_config(tcfg)
    jcfg.run.use_cavity_partial_cell = True
    ts = dynamics.pressure_force(p.ts1, p.tmesh, tcfg)
    js = jdyn.pressure_force(p.js1, p.jmesh, jcfg)
    for name in ("pgf_x", "pgf_y"):
        assert_close(getattr(ts, name), getattr(js, name), name, tol=TOL)
    if which == "sergey":
        # it departs from the hydrostatic gradient in the top layer of the
        # cavity elements and in the bottom layer only
        ref = dynamics.pressure_force_linfs(p.ts1, p.tmesh)
        lay = torch.arange(p.tmesh.nl - 1)[:, None]
        top = (lay == p.tmesh.ulevels_elem[None].long() - 1) & p.cav_e[None]
        bot = lay == p.tmesh.nlevels_elem[None].long() - 2
        diff = ts.pgf_x != ref.pgf_x
        assert bool(diff[top].any()) and bool(diff[bot].any())
        assert not bool(diff[~(top | bot)].any())


@pytest.mark.parametrize("which", ["nemo", "cubicspline", "bogus"])
def test_cavity_pgf_menu_raises_where_jax_does(pair, which):
    p = pair
    tcfg = linfs_cavity_config(which)
    jcfg = jax_config(tcfg)
    jcfg.run.use_cavity_partial_cell = True
    with pytest.raises(ValueError, match="cavity partial cells"):
        jdyn.pressure_force(p.js1, p.jmesh, jcfg)
    with pytest.raises(ValueError, match="cavity partial cells"):
        dynamics.pressure_force(p.ts1, p.tmesh, tcfg)


# --------------------------------------------------------------------------
# the coupled step
# --------------------------------------------------------------------------
def assert_cavity_steps_close(p, jax_out, port_out, tol):
    (js, jice, jof), (ts, tice, tof) = jax_out, port_out
    mesh = p.tmesh
    lev = torch.arange(mesh.nl)[:, None]
    active = {"Kv": mesh.node_level_mask,
              "Av": (lev >= mesh.ulevels_elem[None] - 1)
              & (lev < mesh.nlevels_elem[None])}
    for name in FIELDS:
        got, want = getattr(ts, name), np.asarray(getattr(js, name))
        if not want.size:           # no GM fields without Fer_GM
            assert got.numel() == 0, name
            continue
        if name in MIXING:
            got = torch.where(active[name], got, 0.0)
            want = np.where(active[name].numpy(), want, 0.0)
        assert_close(got, want, name, tol=tol)
    for name in ICE_FIELDS:
        assert_close(getattr(tice, name), getattr(jice, name), name, tol=tol)
    for name in FLUXES:
        assert_close(getattr(tof, name), getattr(jof, name), name, tol=tol)


def assert_cavity_gates(p, port_out):
    """No ice under the shelf, melt under it, nothing above each top."""
    ts, tice, tof = port_out
    cav = p.tmesh.ulevels_node > 1
    assert not tice.a_ice[cav].any() and not tice.m_ice[cav].any()
    assert float(tof.heat_flux[cav].abs().max()) > 0.0
    assert not tof.virtual_salt[cav].any() and not tof.relax_salt[cav].any()
    above = torch.arange(p.tmesh.nl - 1)[:, None] \
        < (p.tmesh.ulevels_node[None] - 1)
    for f in (ts.tr[0], ts.tr[1], ts.density_m_rho0, ts.hpressure):
        assert not f[above].any()
    above_e = torch.arange(p.tmesh.nl - 1)[:, None] \
        < (p.tmesh.ulevels_elem[None] - 1)
    assert not ts.u[above_e].any() and not ts.v[above_e].any()


def test_three_coupled_steps_with_the_shelf_match_jax_dense(pair):
    p = pair
    assert p.tm.ssh_dense_inv is not None and p.cfg.run.use_cavity
    kernels.reset_launches()
    jax_out, port_out = run_both(p, 3)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    assert_cavity_steps_close(p, jax_out, port_out, tol=1e-9)
    assert_cavity_gates(p, port_out)
    assert_ice_alive(port_out[1], p.tice0)


def test_three_coupled_steps_with_the_shelf_match_jax_cg_forced(path):
    p = coupled_pair(path, cavity_config(evp_rheol_steps=8), dense_limit=0)
    p.tmesh = p.tm.mesh
    assert p.tm.ssh_dense_inv is None and p.tm.ssh_block_pc is not None
    jax_out, port_out = run_both(p, 3)
    assert p.tm.ssh_iters > 0
    assert_cavity_steps_close(p, jax_out, port_out, tol=1e-8)
    assert_cavity_gates(p, port_out)


def test_shelf_steps_without_the_cavity_branches_differ(pair):
    """The branches act: the same mesh stepped with ``use_cavity`` off
    gives other fluxes under the shelf."""
    p = pair
    _, _, tof = pi_coupled_step_fn(p.tm, p.tatm)(p.ts0, p.tice0, 0)
    cfg = cavity_config()
    cfg.run.use_cavity = False
    tm, tatm = setup_pi_model(p.path, device="cpu", cfg=cfg, atm_seed=4)
    tm.Ssurf = p.tm.Ssurf
    _, _, off = pi_coupled_step_fn(tm, tatm)(p.ts0, p.tice0, 0)
    cav = p.tmesh.ulevels_node > 1
    assert not torch.equal(off.heat_flux[cav], tof.heat_flux[cav])
