"""The data flow of the two column kernels, ``csrc/pressure_bv.cu`` and
``csrc/tridiag_solve.cu``, walked in numpy on the CPU and held bit for bit
against the plain torch versions (``eos.pressure_bv_plain``,
``ops.tridiag_solve_plain``); the plain versions against the JAX
functions (``fesom2_tpu.core.eos.pressure_bv`` jitted,
``fesom2_tpu.core.ops.tridiag_solve``) to 1e-12 of max|JAX|.

The level-3 globe with 20 layers and partial cells, float64 (501 nodes,
so the last 32-node tile is ragged), with columns recut to one wet layer
(``nlevels - 1 == 1``) and to full depth (``nlevels - 1 == L``) beside the
globe's own depths.  The walks follow the kernels: ``pressure_bv`` on
32-node tiles, runs of ``CELLS`` levels a thread, only the cells the
kernel stages (the others NaN, so a read of one shows), pass 1 writing
over its inputs, the pressure summed down the column, pass 2 with each
output row written by one thread (the outputs start as NaN, so a missed
row shows); ``tridiag_solve`` on 32-column tiles with the pivots m and
cp = c / m computed once and kept per tile, each right-hand side's dp
over its d, and the backward sweep.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fesom2_tpu.core import eos as jeos
from fesom2_tpu.core import ops as jops
from fesom2_tpu.core.state import (allocate_state as jalloc,
                                   init_thickness_linfs as jinit,
                                   initial_z3d as jz3d)
from fesom2_tpu.mesh import build_mesh as jax_build_mesh

from fesom2_tpu_torch import kernels
from fesom2_tpu_torch.constants import density_0, g
from fesom2_tpu_torch.convert import state_from_numpy
from fesom2_tpu_torch.core import eos, ops
from fesom2_tpu_torch.mesh import build_mesh, globe
from fesom2_tpu_torch.model import pi_config, soufflet_config

TILE = 32       # nodes (columns) per block of both kernels
CELLS = 4       # levels per thread of pressure_bv (kCells)
TOL = 1e-12
PC = dict(force_rotation=True, cyclic_length_deg=360.0,
          use_partial_cell=True, partial_cell_thresh=0.0)
FIELDS = ("density_m_rho0", "hpressure", "bvfreq", "dbsfc", "mld2")


class Case:
    """Both packages' meshes and states on one globe."""


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    torch.set_num_threads(1)
    path = globe.write_globe(str(tmp_path_factory.mktemp("globe")), level=3,
                             n_layers=20, dz_bottom=600.0)
    c = Case()
    jm = jax_build_mesh(path, **PC)
    tm = build_mesh(path, device="cpu", **PC)
    fx = globe.globe_fixtures(np.asarray(jm.geo_coords[:, 1]),
                              np.asarray(jm.elem_nodes), np.asarray(jm.Z),
                              np.asarray(jm.nlevels_node),
                              np.asarray(jm.area[0]), seed=3)
    js = jinit(jalloc(jm, 2, jnp.float64), jm)
    c.nl = jm.nl
    nlev, mask, cut = globe.recut_columns(
        jm.nlevels_node, jm.nl, jm.zbar, jm.Z,
        {k: np.asarray(getattr(js, k)) for k in ("Z_3d", "zbar_3d", "hnode")})
    js = dataclasses.replace(js, tr=jnp.asarray(np.stack([fx["T"], fx["S"]])),
                             **{k: jnp.asarray(v) for k, v in cut.items()})
    c.ts = state_from_numpy({f.name: np.asarray(getattr(js, f.name))
                             for f in dataclasses.fields(js)}, "cpu")
    c.js = js
    c.jdref = jeos.reference_density(jm, jz3d(jm, jnp.float64)[1], 1)
    c.tdref = torch.tensor(np.asarray(c.jdref))
    c.nlev = nlev
    c.jmesh = dataclasses.replace(jm, nlevels_node=jnp.asarray(
        nlev, dtype=jm.nlevels_node.dtype), node_layer_mask=jnp.asarray(mask))
    c.tmesh = dataclasses.replace(tm, nlevels_node=torch.as_tensor(
        nlev, dtype=tm.nlevels_node.dtype), node_layer_mask=torch.as_tensor(
        mask))
    c.nlevels_elem = tm.nlevels_elem.numpy()
    return c


def _cfg(kind):
    """pi_config with the JM EoS (kind 1), the linear EoS (0), or the
    soufflet channel's (2)."""
    cfg = soufflet_config() if kind == 2 else pi_config()
    cfg.dyn.state_equation = 1 if kind == 1 else 0
    return cfg


# --------------------------------------------------------------------------
# pressure_bv: numpy walk of the kernel
# --------------------------------------------------------------------------
def _eos(t, s, kind, rho0):
    """eos_components of csrc/pressure_bv.cu, term by term."""
    if kind == 1:
        ss = np.sqrt(np.where(s < 0.0, 0.0, s))
        b0 = (19092.56 + t * (209.8925 + t * (-3.041638 + t * (
            -1.852732e-3 + t * -1.361629e-5))))
        b0 = b0 + s * ((104.4077 + t * (-6.500517 + t * (
            0.1553190 + t * 2.326469e-4)))
            + ss * (-5.587545 + t * (0.7390729 + t * -1.909078e-2)))
        bpz = (-4.721788e-1 + t * (-1.028859e-2 + t * (
            2.512549e-4 + t * 5.939910e-7)))
        bpz = bpz + s * ((1.571896e-2 + t * (2.598241e-4
                                             + t * -7.267926e-6))
                         + ss * -2.042967e-3)
        bpz2 = (1.045941e-5 + t * (-5.782165e-10 + t * 1.296821e-7)) \
            + s * (-2.595994e-7 + t * (-1.248266e-9 + t * -3.508914e-9))
        rhopot = (999.842594 + t * (6.793952e-2 + t * (-9.095290e-3 + t * (
            1.001685e-4 + t * (-1.120083e-6 + t * 6.536332e-9)))))
        rhopot = rhopot + s * (((0.824493 + t * (-4.08990e-3 + t * (
            7.64380e-5 + t * (-8.24670e-7 + t * 5.38750e-9))))
            + ss * (-5.72466e-3 + t * (1.02270e-4 + t * -1.65460e-6)))
            + s * 4.8314e-4)
        return b0, bpz, bpz2, rhopot
    one, zero = np.ones_like(t), np.zeros_like(t)
    if kind == 2:
        rhopot = rho0 - (0.00025 * (t - 10.0)) * rho0
    else:
        rhopot = (rho0 + 0.8 * (s - 34.0)) - 0.2 * (t - 20.0)
    return one, zero, zero, rhopot


def _insitu(e, z, sef):
    bulk = e[0] + z * (e[1] + z * e[2])
    return bulk * e[3] / (bulk + 0.1 * z * sef)


def pressure_bv_walk(t, s, Z3, zb3, h, dref, nlev, kind, g_, rho0,
                     ulev=None):
    """The kernel's data flow on numpy [L, N] arrays, with each column's
    top row at ``ulev - 1`` (None: 0); returns (rho, hp, bvfreq, dbsfc,
    mld2)."""
    L, N = t.shape
    sef = 1.0 if kind == 1 else 0.0
    mg, half_g = -g_, 0.5 * g_
    nan = np.nan
    rho_out, hp_out = np.full((L, N), nan), np.full((L, N), nan)
    bv_out, db_out = np.full((L + 1, N), nan), np.full((L + 1, N), nan)
    mld2 = np.full(N, nan)
    runs = -(-L // CELLS)
    if ulev is None:
        ulev = np.ones_like(nlev)
    with np.errstate(all="ignore"):
        for n0 in range(0, N, TILE):
            cols = slice(n0, min(N, n0 + TILE))
            nl1 = nlev[cols] - 1
            u = ulev[cols] - 1
            w = nl1.shape[0]
            sT, sS, sZ, sH, sR, sZb = (np.full((L, w), nan) for _ in range(6))
            # staging: the cells each thread needs
            for k in range(L):
                wet = (k >= u) & (k < nl1)
                need = wet | (k == u + 1)
                sT[k] = np.where(need, t[k, cols], nan)
                sS[k] = np.where(need, s[k, cols], nan)
                sZ[k] = np.where(need, Z3[k, cols], nan)
                sZb[k] = np.where(need & (k > u), zb3[k, cols], nan)
                sH[k] = np.where(wet, h[k, cols], nan)
                sR[k] = np.where(wet, dref[k, cols], nan)
            # pass 1
            rhopot = np.full((L, w), nan)
            e0 = [np.full(w, nan) for _ in range(4)]
            base = np.full(w, nan)
            for k in range(L):
                wet = (k >= u) & (k < nl1)
                need = wet | (k == u + 1)
                z = sZ[k]
                e = _eos(sT[k], sS[k], kind, rho0)
                rhopot[k] = np.where(need, e[3], 0.0)
                rho = np.where(wet, _insitu(e, z, sef) - sR[k], 0.0)
                sH[k] = np.where(need, np.where(wet, rho * sH[k], 0.0), sH[k])
                sR[k] = np.where(wet, rho + sR[k], sR[k])
                sT[k] = np.where(need & (k > u), _insitu(e, sZb[k], sef),
                                 sT[k])
                if k + 1 < L:
                    up = need & (k >= u) & ((k + 1 < nl1) | (k == u))
                    sS[k] = np.where(up, _insitu(e, sZb[k + 1], sef), sS[k])
                top = k == u
                e0 = [np.where(top, a, b) for a, b in zip(e, e0)]
                base = np.where(top, ((-z) * rho) * g_, base)
                rho_out[k, cols] = rho
            # the pressure, summed down the column by one thread
            hsum = np.zeros(w)
            for k in range(L):
                wet = (k >= u) & (k < nl1)
                if k >= 1:
                    hsum = np.where(wet & (k > u),
                                    hsum + half_g * (sH[k - 1] + sH[k]), hsum)
                hp_out[k, cols] = np.where(wet, base + hsum, 0.0)
            # pass 2: each output row has one writer
            first = np.full((runs, w), -1)
            for k in range(L):
                wet = (k >= u) & (k < nl1)
                rho_full = sR[k]
                db = np.where(wet, mg * (_insitu(e0, sZ[k], sef) - rho_full)
                              / np.where(rho_full == 0.0, 1.0, rho_full), 0.0)
                bottom = k + 1 == nl1
                row = db_out[:, cols]
                row[k] = np.where(k != nl1, db, row[k])
                row[k + 1] = np.where(bottom, db, 0.0 if k == L - 1
                                      else row[k + 1])
                db_out[:, cols] = row
                bv = np.zeros(w)
                if k >= 1:
                    bv = np.where((k > u) & (wet | (k == u + 1)), mg * (
                        1.0 / (sZ[k - 1] - sZ[k])) * (sS[k - 1] - sT[k])
                        / rho0, 0.0)
                row = bv_out[:, cols]
                ar = np.arange(w)
                # the top row u copies interface u + 1
                hit = k == u + 1
                row[u[hit], ar[hit]] = bv[hit]
                if k == L - 1:
                    hit = u == L - 1
                    row[u[hit], ar[hit]] = 0.0
                row[k] = np.where((k != u) & ((k != nl1) | (k == u + 1)), bv,
                                  row[k])
                row[k + 1] = np.where(bottom & (k > u), bv,
                                      0.0 if k == L - 1 else row[k + 1])
                bv_out[:, cols] = row
                r = k // CELLS
                hit = (k > u) & (first[r] < 0) & (
                    ~wet | ((rhopot[k] - e0[3]) > 0.125))
                first[r] = np.where(hit, k, first[r])
            idx = np.zeros(w, dtype=np.int64)
            for r in range(runs - 1, -1, -1):
                idx = np.where(first[r] >= 0, first[r], idx)
            mld2[cols] = Z3[np.maximum(idx, u + 1), np.arange(n0, n0 + w)]
    return rho_out, hp_out, bv_out, db_out, mld2


def test_recut_columns_cover_the_cases(case):
    L = case.nl - 1
    assert int((case.nlev - 1 == 1).sum()) > 5
    assert int((case.nlev - 1 == L).sum()) > 5
    assert int(((case.nlev - 1 > 1) & (case.nlev - 1 < L)).sum()) > 100
    assert case.nlev.shape[0] % TILE != 0
    assert case.nlevels_elem.shape[0] % TILE != 0


@pytest.mark.parametrize("kind", [1, 0, 2], ids=["jm", "linear", "soufflet"])
def test_pressure_bv_walk_equals_plain(case, kind):
    cfg = _cfg(kind)
    st = case.ts
    want = eos.pressure_bv_plain(st, case.tmesh, cfg, case.tdref)
    rho0 = density_0
    got = pressure_bv_walk(*(x.numpy() for x in (
        st.tr[0], st.tr[1], st.Z_3d, st.zbar_3d, st.hnode, case.tdref)),
        case.nlev, kind, g, rho0)
    for name, gv in zip(FIELDS, got):
        wv = getattr(want, name).numpy()
        assert np.isfinite(wv).all() and np.array_equal(gv, wv), name
    assert kernels.LAUNCHES["pressure_bv"] == 0


@pytest.mark.parametrize("kind", [1, 0], ids=["jm", "linear"])
def test_pressure_bv_plain_matches_jax(case, kind):
    cfg = _cfg(kind)
    got = eos.pressure_bv(case.ts, case.tmesh, cfg, case.tdref)
    want = jax.jit(lambda s: jeos.pressure_bv(s, case.jmesh, cfg,
                                              case.jdref))(case.js)
    for name in FIELDS:
        gv = getattr(got, name).numpy()
        wv = np.asarray(getattr(want, name))
        scale = max(float(np.abs(wv).max()), 1e-300)
        assert float(np.abs(gv - wv).max()) <= TOL * scale, name
    one = case.nlev - 1 == 1
    bv = got.bvfreq.numpy()
    assert np.array_equal(bv[0, one], bv[1, one])   # the surface copy


def _cavity_columns(case):
    """The recut globe with ice-shelf cavities over some columns: every
    13th node from the 3rd has its top at row min(3, nlevels - 3) (two wet
    layers or more), every 31st from the 7th keeps its two bottom layers
    (top at nlevels - 3: the top copies N^2 from the bottom interface).
    A cavity keeps at least three layers (``derive_ulevels_cavity``); one
    wet layer under a top, where the surface copy would read the layer
    below the bottom, does not occur.  Returns (ulevels [N], the port's
    and the JAX mesh with them, the JAX configuration flag set)."""
    nlev = case.nlev
    L = case.nl - 1
    ulev = np.ones_like(nlev)
    ulev[3::13] = np.maximum(1, np.minimum(4, nlev[3::13] - 2))
    ulev[7::31] = np.maximum(1, nlev[7::31] - 2)
    lay = np.arange(L)[:, None]
    mask = (lay >= (ulev - 1)[None, :]) & (lay < (nlev - 1)[None, :])
    tmesh = dataclasses.replace(
        case.tmesh, ulevels_node=torch.as_tensor(ulev, dtype=torch.int32),
        node_layer_mask=torch.as_tensor(mask))
    jmesh = dataclasses.replace(
        case.jmesh, ulevels_node=jnp.asarray(ulev, dtype=jnp.int32),
        node_layer_mask=jnp.asarray(mask))
    return ulev, tmesh, jmesh


def test_cavity_columns_cover_the_cases(case):
    ulev, _, _ = _cavity_columns(case)
    L = case.nl - 1
    wet = case.nlev - ulev
    assert int((ulev > 1).sum()) > 40
    assert int(((ulev > 1) & (wet == 2)).sum()) > 5       # two wet layers
    assert int(((ulev > 1) & (wet >= 3)).sum()) > 20
    assert int(((ulev > 1) & (case.nlev - 1 == L)).sum()) >= 1  # full depth


@pytest.mark.parametrize("kind", [1, 0, 2], ids=["jm", "linear", "soufflet"])
def test_pressure_bv_walk_equals_plain_under_cavities(case, kind):
    """Columns whose top lies below the surface: the kernel's data flow
    with the top row u = ulevels - 1, bitwise against the plain version."""
    cfg = _cfg(kind)
    cfg.run.use_cavity = True
    ulev, tmesh, _ = _cavity_columns(case)
    st = case.ts
    want = eos.pressure_bv_plain(st, tmesh, cfg, case.tdref)
    got = pressure_bv_walk(*(x.numpy() for x in (
        st.tr[0], st.tr[1], st.Z_3d, st.zbar_3d, st.hnode, case.tdref)),
        case.nlev, kind, g, density_0, ulev)
    for name, gv in zip(FIELDS, got):
        wv = getattr(want, name).numpy()
        assert np.isfinite(wv).all() and np.array_equal(gv, wv), name
    # the rows above each top are 0, the top copies interface u + 1
    cav = ulev > 1
    lay = np.arange(case.nl - 1)[:, None]
    above = lay < (ulev - 1)[None, :]
    for name in ("density_m_rho0", "hpressure"):
        v = getattr(want, name).numpy()
        assert not v[above].any() and v[~above & (lay < case.nlev - 1)][
            :].any(), name
    bv = want.bvfreq.numpy()
    n = np.nonzero(cav & (case.nlev - ulev >= 3))[0]
    assert np.array_equal(bv[ulev[n] - 1, n], bv[ulev[n], n])
    assert not bv[:-1][above].any()


@pytest.mark.parametrize("kind", [1, 0], ids=["jm", "linear"])
def test_pressure_bv_plain_matches_jax_under_cavities(case, kind):
    cfg = _cfg(kind)
    cfg.run.use_cavity = True
    _, tmesh, jmesh = _cavity_columns(case)
    got = eos.pressure_bv(case.ts, tmesh, cfg, case.tdref)
    want = jax.jit(lambda s: jeos.pressure_bv(s, jmesh, cfg,
                                              case.jdref))(case.js)
    for name in FIELDS:
        gv = getattr(got, name).numpy()
        wv = np.asarray(getattr(want, name))
        scale = max(float(np.abs(wv).max()), 1e-300)
        assert float(np.abs(gv - wv).max()) <= TOL * scale, name


# --------------------------------------------------------------------------
# tridiag_solve: numpy walk of the kernel
# --------------------------------------------------------------------------
def tridiag_walk(a, b, c, d):
    """The kernel's data flow: per 32-column tile, the pivots m and
    cp = c / m once (over b and c), each right-hand side's dp over its d,
    then x = dp - cp * x_next back up."""
    B, L, X = d.shape
    x = np.full(d.shape, np.nan)
    for x0 in range(0, X, TILE):
        cols = slice(x0, min(X, x0 + TILE))
        sa, sb, sc = (v[:, cols].copy() for v in (a, b, c))
        sd = d[:, :, cols].copy()
        cp_prev = np.zeros(sa.shape[1])
        for l in range(L):
            m = sb[l] - cp_prev * sa[l]
            cpl = sc[l] / m
            sb[l], sc[l] = m, cpl
            cp_prev = cpl
        for j in range(B):
            dp_prev = np.zeros(sa.shape[1])
            for l in range(L):
                dpl = (sd[j, l] - dp_prev * sa[l]) / sb[l]
                sd[j, l] = dpl
                dp_prev = dpl
            x_next = np.zeros(sa.shape[1])
            for l in range(L - 1, -1, -1):
                xl = sd[j, l] - sc[l] * x_next
                x[j, l, cols] = xl
                x_next = xl
    return x


def _system(case, rows, on, B, seed):
    """A diagonally dominant system [rows, X] with identity rows below
    each column's bottom (a = c = 0, b = 1, d = 0), as the step builds
    them; ``rows`` is nl - 1 or nl (gm_redi's interfaces)."""
    nlev = case.nlev if on == "nodes" else case.nlevels_elem
    X = nlev.shape[0]
    rng = np.random.default_rng(seed)
    active = np.arange(rows)[:, None] < (nlev - 1)[None, :]
    a = np.where(active, rng.uniform(-0.4, 0.0, (rows, X)), 0.0)
    c = np.where(active, rng.uniform(-0.4, 0.0, (rows, X)), 0.0)
    b = np.where(active, rng.uniform(1.0, 2.0, (rows, X)), 1.0)
    d = np.where(active, rng.uniform(-1.0, 1.0, (B, rows, X)), 0.0)
    return a, b, c, d


SHAPES = [("nodes", 0), ("elements", 0), ("nodes", 1)]


@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("on,extra", SHAPES,
                         ids=["nodes_L", "elements_L", "nodes_nl"])
def test_tridiag_walk_equals_plain(case, B, on, extra):
    a, b, c, d = _system(case, case.nl - 1 + extra, on, B, seed=B + extra)
    want = ops.tridiag_solve(*(torch.as_tensor(v) for v in (a, b, c, d)))
    assert np.array_equal(tridiag_walk(a, b, c, d), want.numpy())
    assert kernels.LAUNCHES["tridiag_solve"] == 0


@pytest.mark.parametrize("B", [1, 2, 3])
def test_tridiag_plain_matches_jax(case, B):
    a, b, c, d = _system(case, case.nl, "nodes", B, seed=10 + B)
    got = ops.tridiag_solve_plain(*(torch.as_tensor(v)
                                    for v in (a, b, c, d))).numpy()
    for j in range(B):
        want = np.asarray(jops.tridiag_solve(*(jnp.asarray(v) for v in (
            a, b, c, d[j]))))
        scale = float(np.abs(want).max())
        assert float(np.abs(got[j] - want).max()) <= TOL * scale
        # below each column's bottom the identity rows give 0
        below = np.arange(case.nl)[:, None] >= (case.nlev - 1)[None, :]
        assert not got[j][below].any()
