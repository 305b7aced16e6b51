"""Uniform mesh refinement (``mesh/refine.py``) in the port against the JAX
package (CPU, float64).

``subdivide_raw`` on the level-2 and level-3 globes' RawMesh (read with
``force_rotation``, with the shelf draft of ``cavity_depth.out``) gives
every array JAX's gives, bit for bit, once and twice over; the refined
mesh's tables equal those of JAX's ``refined_mesh``; every refined
triangle stays clockwise seen from outside the sphere (the order of the
mesh files; the other would make the SSH operator indefinite); and two
coupled CI steps of ``setup_pi_model(n_refine=1)`` on the level-2 globe
(140 nodes, 12 layers, refined to 503) agree with JAX's coupled step on
its refined mesh to 1e-10 of each field's largest JAX magnitude, with the
dense SSH solve and 8 mEVP subcycles.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fesom2_tpu.model as jmodel
from fesom2_tpu.core import eos as jeos, ssh as jssh
from fesom2_tpu.core.state import initial_z3d as jz3d
from fesom2_tpu.core.tracer_setup import build_tracer_statics as jtst
from fesom2_tpu.forcing.atmos import AtmData as JAtmData
from fesom2_tpu.ice.state import IceState as JIceState
from fesom2_tpu.ice.subdomain import build_ice_subdomain as jbuild_sub
from fesom2_tpu.mesh import io as jio
from fesom2_tpu.mesh import refine as jrefine

from fesom2_tpu_torch.convert import to_numpy
from fesom2_tpu_torch.mesh import globe, read_raw_mesh, refine
from fesom2_tpu_torch.model import (pi_config, pi_coupled_step_fn,
                                    pi_initial_state, setup_pi_model)

from test_torch_coupled import FLUXES, ICE_FIELDS
from test_torch_ci_ocean import FIELDS
from test_torch_kpp import assert_close

PC = dict(use_partial_cell=True, partial_cell_thresh=0.0)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    torch.set_num_threads(1)
    return {lev: globe.write_globe(str(tmp_path_factory.mktemp(f"g{lev}")),
                                   level=lev, n_layers=12, dz_bottom=1000.0,
                                   shelf=True)
            for lev in (2, 3)}


@pytest.fixture(scope="module")
def plain2(tmp_path_factory):
    return globe.write_globe(str(tmp_path_factory.mktemp("plain2")), level=2,
                             n_layers=12, dz_bottom=1000.0)


def raw_arrays(raw):
    return {f.name: getattr(raw, f.name) for f in dataclasses.fields(raw)}


@pytest.mark.parametrize("times", [1, 2])
@pytest.mark.parametrize("level", [2, 3])
def test_subdivide_raw_equals_jax(paths, level, times):
    t = read_raw_mesh(paths[level], force_rotation=True)
    j = jio.read_raw_mesh(paths[level], force_rotation=True)
    assert t.cavity_depth is not None and (t.cavity_depth < 0).any()
    for _ in range(times):
        t = refine.subdivide_raw(t)
        j = jrefine.subdivide_raw(j)
    got, want = raw_arrays(t), raw_arrays(j)
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), name
        else:
            assert g == w, name
    # the old nodes first, then one midpoint per edge, under the shelf
    # only where both ends are
    n0 = read_raw_mesh(paths[level]).n_nodes
    if times == 1:
        assert np.array_equal(t.coords[:n0], read_raw_mesh(
            paths[level], force_rotation=True).coords)
        assert (t.cavity_depth[n0:] < 0).sum() < (t.cavity_depth < 0).sum()


def clockwise(raw):
    """True per triangle where it is clockwise seen from outside, in the
    model frame (``coords``), whose coordinates the tables are built from.
    (The geographic ``coords_deg`` of a midpoint are a lon/lat mean too,
    which is off for an edge at the geographic North Pole, ocean on the
    globe; nothing reads them after the mesh is read.)"""
    lon, lat = raw.coords[:, 0], raw.coords[:, 1]
    v = np.stack([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
                  np.sin(lat)], 1)
    a, b, c = (v[raw.elem_nodes[:, j]] for j in range(3))
    return (np.cross(b - a, c - a) * a).sum(1) < 0


@pytest.mark.parametrize("level", [2, 3])
def test_refined_triangles_stay_clockwise(paths, level):
    raw = read_raw_mesh(paths[level], force_rotation=True)
    assert clockwise(raw).all()
    for _ in range(2):
        raw = refine.subdivide_raw(raw)
        assert clockwise(raw).all()
        # as build_edges decides it, in (lon, lat) across the seam
        c, en = raw.coords, raw.elem_nodes
        trim = lambda d: (d + np.pi) % (2 * np.pi) - np.pi
        ax, bx = (trim(c[en[:, j], 0] - c[en[:, 0], 0]) for j in (1, 2))
        ay, by = (c[en[:, j], 1] - c[en[:, 0], 1] for j in (1, 2))
        assert ((ax * by - bx * ay) < 0).all()
    assert raw.n_elems == 16 * read_raw_mesh(paths[level]).n_elems


@pytest.mark.parametrize("level", [2, 3])
def test_refined_tables_equal_jax(paths, level):
    kw = dict(force_rotation=True, cyclic_length_deg=360.0, **PC)
    tm = refine.refined_mesh(paths[level], 1, device="cpu", **kw)
    jm = jrefine.refined_mesh(paths[level], 1, **kw)
    for f in dataclasses.fields(jm):
        want = getattr(jm, f.name)
        if hasattr(want, "shape"):
            assert np.array_equal(getattr(tm, f.name).numpy(),
                                  np.asarray(want)), f.name
        else:
            assert getattr(tm, f.name) == want, f.name
    # the drafts came through: cavities on the refined mesh
    assert int(tm.ulevels_node.max()) > 1


def test_setup_refines_and_keeps_jax_s_cavity_switch(plain2):
    """``n_refine=1`` refines; a ``cavity_depth`` given with it turns
    ``use_cavity`` on but, as in the JAX package, does not reach the
    refined mesh."""
    cfg = pi_config()
    tm, _ = setup_pi_model(plain2, device="cpu", cfg=cfg, n_refine=1)
    n = read_raw_mesh(plain2).n_nodes
    assert tm.mesh.n_nodes > 3 * n and not cfg.run.use_cavity
    draft = globe.shelf_draft(read_raw_mesh(plain2))
    cfg = pi_config()
    tm, _ = setup_pi_model(plain2, device="cpu", cfg=cfg, n_refine=1,
                           cavity_depth=draft)
    assert cfg.run.use_cavity and int(tm.mesh.ulevels_node.max()) == 1


def jax_refined_model(path, cfg):
    """The JAX model of ``_finish_pi_setup`` with ``n_refine=1``, without
    forcing files (``test_torch_ci_ocean.jax_ci_model`` on the refined
    mesh), with its ice subdomain."""
    m = jrefine.refined_mesh(path, 1, force_rotation=True,
                             cyclic_length_deg=360.0, **PC)
    _, Z3 = jz3d(m, jnp.float64)
    jm = jmodel.Model(
        mesh=m, cfg=cfg, tracer_statics=jtst(m, K_hor=cfg.tra.K_hor),
        ssh_diag_inv=None, ssh_dense_inv=jssh.ssh_dense_inverse(m, cfg),
        density_ref=jeos.reference_density(m, Z3, cfg.dyn.state_equation))
    jm.ice_submesh = jbuild_sub(m, lat_deg=cfg.ice.evp_subdomain_lat)
    return jm


def test_two_refined_coupled_steps_match_jax(plain2):
    cfg = pi_config()
    cfg.ice.evp_rheol_steps = 8
    tm, tatm = setup_pi_model(plain2, device="cpu", cfg=cfg, n_refine=1,
                              atm_seed=4)
    assert tm.mesh.n_nodes == 503 and tm.ssh_dense_inv is not None
    jm = jax_refined_model(plain2, cfg)
    fx = globe.globe_atm_fixtures(np.asarray(jm.mesh.geo_coords[:, 1]),
                                  seed=4, n_records=4)
    jatm = JAtmData(**{k: jnp.asarray(v) for k, v in fx.items()})
    ts, tice = pi_initial_state(tm, seed=0)
    js = jm.initial_state()
    js = dataclasses.replace(js, tr=jnp.asarray(to_numpy(ts.tr)),
                             tr_old=jnp.asarray(to_numpy(ts.tr_old)))
    jm.Ssurf = js.tr[1, 0]
    jice = JIceState(**{k: jnp.asarray(v) for k, v in to_numpy(tice).items()})
    jstep = jmodel.pi_coupled_step_fn(jm, jatm)
    tstep = pi_coupled_step_fn(tm, tatm)
    for k in range(2):
        js, jice, jof = jstep(js, jice, jnp.asarray(k))
        ts, tice, tof = tstep(ts, tice, k)
    for name in FIELDS:
        assert_close(getattr(ts, name), getattr(js, name), name, tol=1e-10)
    for name in ICE_FIELDS:
        assert_close(getattr(tice, name), getattr(jice, name), name,
                     tol=1e-10)
    for name in FLUXES:
        assert_close(getattr(tof, name), getattr(jof, name), name, tol=1e-10)
    assert float(tice.a_ice.max()) > 0.5
    assert float(ts.u.abs().max()) > 1e-4
