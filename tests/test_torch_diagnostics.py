"""The port's diagnostics (``core/diag.py``, ``core/diagnostics.py``) and
the DVD diagnostic of its tracer step, against the JAX package's on the
CPU.

The state is the port's after two coupled CI steps on the level-3 globe
with 12 layers (8 mEVP subcycles), every &diag_list flag on; it is handed
to the JAX functions through numpy, on the JAX package's own mesh of the
same files, and each function's outputs must agree within 1e-12 of their
largest JAX magnitude (JAX run eagerly: no jit).  ``check_blowup`` is held
to JAX's on a sane state, a NaN, out-of-range fields and ice outside the
EVP subdomain.  The density-class binning: its plain version against
JAX's chain, a numpy walk of ``csrc/dens_moc_bin.cu``'s data flow against
the plain version (1e-12: only the sum over layers runs in another order),
the wrapper's argument list against the kernel's C signature, and the
invariants of ``tests/test_diagnostics.py:62-88`` (the binned volume is
the ocean volume, the binned transport the summed transport, the weights
of an active layer add to 1).  The DVD: the two checks of
``tests/test_diagnostics.py:100-144`` on the code-built channel (a
uniform tracer has none; the vertical T DVD is positive after 5 steps).
``tests/test_torch_soufflet.py`` and ``tests/test_torch_coupled.py`` hold
``dvd_h`` and ``dvd_v`` against JAX's (1e-10).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fesom2_tpu.core import diag as jdiag, diagnostics as jdg, eos as jeos
from fesom2_tpu.core.state import Forcing as JForcing
from fesom2_tpu.core.state import OceanState as JOceanState
from fesom2_tpu.ice.state import IceState as JIceState
from fesom2_tpu.ice.subdomain import build_ice_subdomain as jbuild_sub
from fesom2_tpu.mesh import build_mesh as jax_build_mesh

from fesom2_tpu_torch import kernels
from fesom2_tpu_torch.convert import to_numpy
from fesom2_tpu_torch.core import diag, diagnostics as dg, eos
from fesom2_tpu_torch.core.state import zero_forcing
from fesom2_tpu_torch.mesh import globe
from fesom2_tpu_torch.mesh.channel import channel_raw_mesh, write_mesh
from fesom2_tpu_torch.model import (pi_config, pi_coupled_step_fn,
                                    pi_initial_state, setup_pi_model,
                                    setup_soufflet_model)

from test_torch_kpp import assert_close

TOL = 1e-12
DIAG_FLAGS = ("lcurt_stress_surf", "ldiag_curl_vel3", "ldiag_energy",
              "ldiag_salt3D", "ldiag_dMOC", "ldiag_DVD")


def diag_config():
    """The CI configuration with 8 subcycles and every &diag_list flag."""
    cfg = pi_config()
    cfg.ice.evp_rheol_steps = 8
    for flag in DIAG_FLAGS:
        setattr(cfg.diag, flag, True)
    return cfg


def to_jax(cls, obj):
    """An instance of the JAX package's dataclass ``cls`` from the port's
    ``obj``, field for field, through numpy."""
    return cls(**{f.name: jnp.asarray(to_numpy(getattr(obj, f.name)))
                  for f in dataclasses.fields(cls)})


class GlobeRun:
    """The port's model and its state, ice and forcing after ``n`` coupled
    steps, with the JAX package's mesh of the same files and the JAX
    copies of the three."""


def globe_run(path, cfg, n_steps=2, atm_seed=4):
    r = GlobeRun()
    r.cfg = cfg
    r.tm, r.tatm = setup_pi_model(path, device="cpu", cfg=cfg,
                                  atm_seed=atm_seed)
    r.mesh = r.tm.mesh
    ts, tice = pi_initial_state(r.tm)
    step = pi_coupled_step_fn(r.tm, r.tatm)
    r.states = []
    for k in range(n_steps):
        ts, tice, tof = step(ts, tice, k)
        r.states.append((ts, tice, tof))
    r.ts, r.tice, r.tof = ts, tice, tof
    r.jmesh = jax_build_mesh(path, force_rotation=True,
                             cyclic_length_deg=360.0,
                             use_partial_cell=cfg.ale.use_partial_cell,
                             partial_cell_thresh=cfg.ale.partial_cell_thresh)
    r.js, r.jice, r.jf = (to_jax(JOceanState, ts), to_jax(JIceState, tice),
                          to_jax(JForcing, tof))
    return r


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    torch.set_num_threads(1)
    return globe.write_globe(str(tmp_path_factory.mktemp("globe")), level=3,
                             n_layers=12, dz_bottom=1000.0)


@pytest.fixture(scope="module")
def run(path):
    return globe_run(path, diag_config())


def assert_dict_close(port: dict, ref: dict, tol=TOL):
    assert set(port) == set(ref)
    for k in ref:
        assert_close(port[k], ref[k], k, tol=tol)


def test_curl_and_vorticity_match_jax(run):
    r = run
    assert_close(dg.curl_stress_surf(r.tof, r.mesh),
                 jdg.curl_stress_surf(r.jf, r.jmesh), "curl_stress_surf")
    assert_close(dg.curl_vel3(r.ts, r.mesh), jdg.curl_vel3(r.js, r.jmesh),
                 "curl_vel3")
    assert float(dg.curl_stress_surf(r.tof, r.mesh).abs().max()) > 0.0


def test_diag_energy_matches_jax(run):
    r = run
    got = dg.diag_energy(r.ts, r.mesh, r.tof, r.cfg)
    assert_dict_close(got, jdg.diag_energy(r.js, r.jmesh, r.jf, r.cfg))
    assert float(got["av_dudz_sq"].min()) >= 0.0
    assert float(got["dudx"].abs().max()) > 0.0


def test_density_dmoc_and_salt_integral_match_jax(run):
    r = run
    assert_close(dg.density_dmoc(r.ts, r.cfg),
                 jdg.density_dmoc(r.js, r.cfg), "density_dmoc")
    assert_close(dg.salt3d_integral(r.ts, r.mesh),
                 jdg.salt3d_integral(r.js, r.jmesh), "salt3D_int")


def test_diag_dens_moc_matches_jax(run):
    r = run
    al, be = eos.sw_alpha_beta(r.ts.tr[0], r.ts.tr[1], r.ts.Z_3d)
    jal, jbe = jeos.sw_alpha_beta(r.js.tr[0], r.js.tr[1], r.js.Z_3d)
    got = dg.diag_dens_moc(r.ts, r.mesh, r.cfg, forcing=r.tof, sw_alpha=al,
                           sw_beta=be)
    want = jdg.diag_dens_moc(r.js, r.jmesh, r.cfg, forcing=r.jf,
                             sw_alpha=jal, sw_beta=jbe)
    assert_dict_close(got, want)
    # without the surface coefficients (the streams' bundle): no flux rows
    assert_dict_close(dg.diag_dens_moc(r.ts, r.mesh, r.cfg, forcing=r.tof),
                      jdg.diag_dens_moc(r.js, r.jmesh, r.cfg, forcing=r.jf))
    # with the bolus velocities
    fu, fv = r.ts.fer_u, r.ts.fer_v
    assert float(fu.abs().max()) > 0.0
    assert_dict_close(
        dg.diag_dens_moc(r.ts, r.mesh, r.cfg, fer_u=fu, fer_v=fv),
        jdg.diag_dens_moc(r.js, r.jmesh, r.cfg, fer_u=r.js.fer_u,
                          fer_v=r.js.fer_v))


def test_compute_diagnostics_matches_jax(run):
    r = run
    got = dg.compute_diagnostics(r.ts, r.mesh, r.cfg, r.tof)
    want = jdg.compute_diagnostics(r.js, r.jmesh, r.cfg, r.jf)
    assert_dict_close(got, want)
    for k in ("tr_dvd_horiz_T", "tr_dvd_vert_S", "std_dens_flux_W",
              "salt3D_int", "curl_vel3", "wrhof"):
        assert k in got
    assert r.ts.dvd_h.shape == (2, r.mesh.nl - 1, r.mesh.n_nodes)
    assert float(r.ts.dvd_v.abs().max()) > 0.0


def test_step_info_and_format_match_jax(run):
    r = run
    got = diag.step_info(r.ts, r.mesh, r.tice)
    want = jdiag.step_info(r.js, r.jmesh, r.jice)
    assert set(want) <= set(got)
    assert set(got) - set(want) == {"ice_area", "ice_volume"}
    for k, v in want.items():
        assert abs(got[k] - float(v)) <= TOL * max(abs(float(v)), 1e-300), k
    sub = {k: got[k] for k in want}
    assert diag.format_step_info(sub, 7) == jdiag.format_step_info(
        {k: float(v) for k, v in want.items()}, 7)
    assert "ice_area=" in diag.format_step_info(got, 7)


def blowup_cases(r):
    """(label, port state, port ice, JAX state, JAX ice) of each case."""
    lat = r.mesh.geo_coords[:, 1].abs()
    nan_eta = r.ts.eta.clone()
    nan_eta[3] = float("nan")
    hot = r.ts.tr.clone()
    hot[0, 0, 5] = 61.0
    stray = dataclasses.replace(
        r.tice, a_ice=torch.where(lat < 0.1, torch.full_like(r.tice.a_ice,
                                                             0.5),
                                  r.tice.a_ice))
    bad_ice = dataclasses.replace(r.tice, m_ice=r.tice.m_ice.clone())
    bad_ice.m_ice[0] = float("inf")
    inf_w = r.ts.w.clone()
    inf_w[1, 2] = float("inf")
    fresh = r.ts.tr.clone()
    fresh[1, 0, 4] = -0.5
    cases = [("sane", r.ts, r.tice),
             ("w not finite", dataclasses.replace(r.ts, w=inf_w), r.tice),
             ("S < 0", dataclasses.replace(r.ts, tr=fresh), r.tice),
             ("nan eta", dataclasses.replace(r.ts, eta=nan_eta), r.tice),
             ("T > 60", dataclasses.replace(r.ts, tr=hot), r.tice),
             ("ice outside the subdomain", r.ts, stray),
             ("m_ice not finite", r.ts, bad_ice)]
    return [(label, ts, ti, to_jax(JOceanState, ts), to_jax(JIceState, ti))
            for label, ts, ti in cases]


def test_check_blowup_matches_jax(run):
    r = run
    jsub = jbuild_sub(r.jmesh, lat_deg=r.cfg.ice.evp_subdomain_lat)
    flags = {}
    for label, ts, ti, js, ji in blowup_cases(r):
        got = diag.check_blowup(ts, r.mesh, ti, ice_sub=r.tm.ice_sub)
        assert got.dtype == torch.int32 and got.dim() == 0
        want = int(jdiag.check_blowup(js, r.jmesh, ji, ice_sub=jsub))
        assert int(got) == want, label
        flags[label] = want
        # without the subdomain guard
        assert int(diag.check_blowup(ts, r.mesh, ti)) == int(
            jdiag.check_blowup(js, r.jmesh, ji)), label
        if want:
            assert "no condition" not in diag.blowup_reasons(
                ts, r.mesh, ti, r.tm.ice_sub), label
    assert flags == {"sane": 0, "w not finite": 1, "S < 0": 1,
                     "nan eta": 1, "T > 60": 1,
                     "ice outside the subdomain": 1, "m_ice not finite": 1}
    stray = {c[0]: c[2] for c in blowup_cases(r)}["ice outside the subdomain"]
    assert "outside the EVP subdomain" in diag.blowup_reasons(
        r.ts, r.mesh, stray, r.tm.ice_sub)


def test_first_bad_step_is_sticky():
    first = torch.full((), -1, dtype=torch.int32)
    for step, flag in ((1, 0), (2, 0), (3, 1), (4, 0), (5, 1)):
        first = diag.first_bad_step(torch.tensor(flag, dtype=torch.int32),
                                    first, step)
    assert int(first) == 3


# --------------------------------------------------------------------------
# the density-class binning
# --------------------------------------------------------------------------
def binning_inputs(r, dtype=torch.float64):
    ts = r.ts
    dens = dg.interface_density(ts, r.mesh, r.cfg)
    bins = torch.as_tensor(dg.STD_DENS).to(dtype)
    return (dens.to(dtype), ts.helem.to(dtype), ts.u.to(dtype),
            ts.v.to(dtype), r.mesh.elem_area.to(dtype), r.mesh.ulevels_elem,
            r.mesh.nlevels_elem, bins)


def kernel_walk(dens, helem, u, v, area, ule, nle, bins, fer_u=None,
                fer_v=None):
    """csrc/dens_moc_bin.cu's data flow in numpy, one element at a time:
    the class edges, the bisection for the first class above dmin, the
    run of classes below dmax, the weight sum in class order, the nearest
    class by a first-minimum scan; sums over the layers in ascending
    order.  Returns [5, S, E]."""
    dens, helem, u, v, area, bins = (to_numpy(x) for x in (dens, helem, u,
                                                           v, area, bins))
    ule, nle = to_numpy(ule), to_numpy(nle)
    if fer_u is not None:
        fer_u, fer_v = to_numpy(fer_u), to_numpy(fer_v)
    T = bins.dtype.type
    nl, E = dens.shape
    S = bins.shape[0]
    lo = np.array([T(-1e30)] + [T(0.5) * (bins[s - 1] + bins[s])
                                for s in range(1, S)], bins.dtype)
    hi = np.array([T(0.5) * (bins[s] + bins[s + 1]) for s in range(S - 1)]
                  + [T(1e30)], bins.dtype)
    out = np.zeros((5, S, E), bins.dtype)
    for e in range(E):
        l0, l1 = max(int(ule[e]) - 1, 0), min(int(nle[e]) - 1, nl - 1)
        depth = T(0)
        for lay in range(l0, l1):
            h = helem[lay, e]
            depth = T(depth + h)
            zmid = T(depth - h / T(2))
            uu = u[lay, e] + (fer_u[lay, e] if fer_u is not None else T(0))
            vv = v[lay, e] + (fer_v[lay, e] if fer_v is not None else T(0))
            x = (T(uu * h), T(vv * h), T(h * area[e]), T(-zmid))
            # NaN-propagating, as torch.minimum / maximum and the kernel
            dmin = np.minimum(dens[lay, e], dens[lay + 1, e])
            dmax = np.maximum(dens[lay, e], dens[lay + 1, e])
            a, top = 0, S
            while a < top:
                m = (a + top) >> 1
                if hi[m] > dmin:
                    top = m
                else:
                    a = m + 1
            b = a
            while b < S and lo[b] < dmax:
                b += 1
            ov = [max(T(np.minimum(dmax, hi[s]) - np.maximum(dmin, lo[s])),
                      T(0)) for s in range(a, b)]
            wsum = T(0)
            for o in ov:
                wsum = T(wsum + o)
            if b > a and wsum > T(1e-10):
                for s, o in zip(range(a, b), ov):
                    w = T(o / wsum)
                    for k in range(4):
                        out[k, s, e] += T(w * x[k])
                    out[4, s, e] += w
            else:
                dmid = T(T(0.5) * T(dmin + dmax))
                best = int(np.argmin(np.abs(bins - dmid)))
                for k in range(4):
                    out[k, best, e] += x[k]
                out[4, best, e] += T(1)
    return out


def chunked_walk(dens, helem, u, v, area, ule, nle, bins, fer_u=None,
                 fer_v=None, chunk=4):
    """csrc/dens_moc_bin.cu's data flow as it stands, in numpy, one element
    at a time: the span pass finds each layer's classes (the run from the
    first class whose upper edge lies above dmin, found by a walk from the
    layer above's, to the first whose lower edge does not lie below dmax;
    wide where dmax - dmin > 1e-9, else where the overlaps' sum exceeds
    1e-10; the nearest class where not wide) and records for each chunk of
    ``chunk`` classes the first and last layer sending weight into it and
    the running depth before the first; then, for every chunk, the walk of
    those layers sums the chunk's 5 x ``chunk`` values from 0 in ascending
    layer order (the overlaps' sum taken where a wide layer meets the
    chunk), and every output is stored once (zeros where no layer meets
    the chunk).  Returns ([5, S, E], the chunks the layers' classes meet,
    summed)."""
    dens, helem, u, v, area, bins = (to_numpy(x) for x in (dens, helem, u,
                                                           v, area, bins))
    ule, nle = to_numpy(ule), to_numpy(nle)
    if fer_u is not None:
        fer_u, fer_v = to_numpy(fer_u), to_numpy(fer_v)
    T = bins.dtype.type
    nl, E = dens.shape
    S = bins.shape[0]
    lo = np.array([T(-1e30)] + [T(0.5) * (bins[s - 1] + bins[s])
                                for s in range(1, S)], bins.dtype)
    hi = np.array([T(0.5) * (bins[s] + bins[s + 1]) for s in range(S - 1)]
                  + [T(1e30)], bins.dtype)
    ov = lambda dmin, dmax, s: max(T(np.minimum(dmax, hi[s])
                                     - np.maximum(dmin, lo[s])), T(0))

    def wsum_of(dmin, dmax, a, b):
        wsum = T(0)
        for s in range(a, b):
            wsum = T(wsum + ov(dmin, dmax, s))
        return wsum

    def classes_of(dmin, dmax, hint):
        a, b = 0, 0
        if dmin == dmin and dmax == dmax:
            a = hint[0]
            while a > 0 and hi[a - 1] > dmin:
                a -= 1
            while a < S and not hi[a] > dmin:
                a += 1
            b = a
            while b < S and lo[b] < dmax:
                b += 1
            hint[0] = min(a, S - 1)
        wide = b > a and T(dmax - dmin) > T(1e-9)
        if not wide:
            wide = b > a and wsum_of(dmin, dmax, a, b) > T(1e-10)
        if wide:
            return a, b, True
        best = int(np.argmin(np.abs(bins - T(T(0.5) * T(dmin + dmax)))))
        return best, best + 1, False

    Q = -(-S // chunk)
    out = np.empty((5, S, E), bins.dtype)
    visits = 0
    with np.errstate(invalid="ignore"):
        for e in range(E):
            l0, l1 = max(int(ule[e]) - 1, 0), min(int(nle[e]) - 1, nl - 1)
            first, last, before = [None] * Q, [None] * Q, [None] * Q
            depth, hint = T(0), [0]
            for lay in range(l0, l1):
                a, b, _ = classes_of(
                    np.minimum(dens[lay, e], dens[lay + 1, e]),
                    np.maximum(dens[lay, e], dens[lay + 1, e]), hint)
                for q in range(a // chunk, (b - 1) // chunk + 1):
                    if first[q] is None:
                        first[q], before[q] = lay, depth
                    last[q] = lay
                    visits += 1
                depth = T(depth + helem[lay, e])
            for q in range(Q):
                c0 = q * chunk
                acc = np.zeros((5, chunk), bins.dtype)
                if first[q] is not None:
                    depth, hint = before[q], [min(c0, S - 1)]
                    for lay in range(first[q], last[q] + 1):
                        h = helem[lay, e]
                        depth = T(depth + h)
                        dmin = np.minimum(dens[lay, e], dens[lay + 1, e])
                        dmax = np.maximum(dens[lay, e], dens[lay + 1, e])
                        a, b, wide = classes_of(dmin, dmax, hint)
                        if b <= c0 or a >= c0 + chunk:
                            continue
                        zmid = T(depth - h / T(2))
                        uu = u[lay, e] + (fer_u[lay, e] if fer_u is not None
                                          else T(0))
                        vv = v[lay, e] + (fer_v[lay, e] if fer_v is not None
                                          else T(0))
                        x = (T(uu * h), T(vv * h), T(h * area[e]), T(-zmid))
                        if wide:
                            den = np.maximum(wsum_of(dmin, dmax, a, b),
                                             T(1e-30))
                            for s in range(max(a, c0), min(b, c0 + chunk)):
                                w = T(ov(dmin, dmax, s) / den)
                                for k in range(4):
                                    acc[k, s - c0] += T(w * x[k])
                                acc[4, s - c0] += w
                        else:
                            for k in range(4):
                                acc[k, a - c0] += x[k]
                            acc[4, a - c0] += T(1)
                n = min(chunk, S - c0)
                out[:, c0:c0 + n, e] = acc[:, :n]
    return out, visits


WALKS = {"chunked": lambda *a, **k: chunked_walk(*a, **k)[0],
         "per_layer": kernel_walk}


@pytest.mark.parametrize("design", list(WALKS))
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_dens_moc_bin_walk_matches_plain(run, dtype, tol, design):
    """The kernel's walk (``chunked``) and the first design's (one
    read-modify-write a layer and class after a zero fill, ``per_layer``)
    against the plain version, without and with the bolus velocities."""
    r = run
    walk = WALKS[design]
    args = binning_inputs(r, dtype)
    want = dg.dens_moc_bin_plain(*args)
    got = walk(*args)
    for k, name in enumerate(dg.DMOC_BINNED):
        assert_close(got[k], to_numpy(want[k]), name, tol=tol)
    fu, fv = r.ts.fer_u.to(dtype), r.ts.fer_v.to(dtype)
    want = dg.dens_moc_bin_plain(*args, fer_u=fu, fer_v=fv)
    got = walk(*args, fer_u=fu, fer_v=fv)
    for k, name in enumerate(dg.DMOC_BINNED):
        assert_close(got[k], to_numpy(want[k]), name, tol=tol)


def odd_binning_inputs(r, dtype=torch.float64):
    """binning_inputs with a layer of no spread, a tie between two
    classes, a NaN interval, and element 9's densities reset to rise from
    31.2 to 33.5, a span across the edge between the chunks of classes 0-7
    and 8-15."""
    dens, *rest = binning_inputs(r, dtype)
    dens = dens.clone()
    dens[2] = dens[1]                          # layer 1: degenerate
    mid = 0.5 * (dg.STD_DENS[40] + dg.STD_DENS[41])
    dens[3:5, :4] = mid                        # a tie between two classes
    dens[6, 7] = float("nan")
    dens[:, 9] = torch.linspace(31.2, 33.5, dens.shape[0]).to(dtype)
    # spreads about the thresholds of the weight sum (1e-10) and of the
    # sure run (1e-9): elements 10-14, layers 2 and 3
    for e, gap in zip(range(10, 15), (5e-11, 1e-10, 2e-10, 9e-10, 2e-9)):
        dens[3, e] = dens[2, e] + gap
        dens[4, e] = dens[3, e] - gap / 2
    return (dens, *rest)


@pytest.mark.parametrize("chunk", [3, 4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dens_moc_bin_chunked_walk_equals_the_first_design(run, dtype,
                                                           chunk):
    """The kernel's walk equals the first design's bit for bit at any chunk
    width, on the state's layers and on layers of no spread, a tie, a NaN
    interval and an element whose span crosses chunk edges (the first 256
    elements); a layer meets at least one chunk and at most one a class of
    its run."""
    r = run
    cut = lambda x: x[..., :256].contiguous()   # the first 256 elements
    for args in (binning_inputs(r, dtype), odd_binning_inputs(r, dtype)):
        args = (*(cut(a) for a in args[:7]), args[7])
        for fer in ((None, None), (cut(r.ts.fer_u.to(dtype)),
                                   cut(r.ts.fer_v.to(dtype)))):
            got, visits = chunked_walk(*args, *fer, chunk=chunk)
            want = kernel_walk(*args, *fer)
            assert np.array_equal(np.isnan(got), np.isnan(want))
            assert np.array_equal(np.nan_to_num(got), np.nan_to_num(want))
    active, runs, _, _, _ = dg.dens_moc_bin_counts(*args[:1], *args[5:])
    assert active <= visits <= active + runs
    # element 9's span crosses chunk edges (classes 7|8 among them)
    e9 = got[4, :, 9]
    assert e9[:8].sum() > 0 and e9[8:16].sum() > 0


def test_dens_moc_bin_chunked_walk_matches_jax(run):
    """The kernel's walk against the JAX package's diag_dens_moc
    (``fesom2_tpu/core/diagnostics.py:159``) run eagerly on the same
    state, without and with the bolus velocities: each of the five fields
    within 1e-12 of its largest magnitude."""
    r = run
    args = binning_inputs(r)
    for fer, jfer in (((None, None), (None, None)),
                      ((r.ts.fer_u, r.ts.fer_v), (r.js.fer_u, r.js.fer_v))):
        got, _ = chunked_walk(*args, *fer)
        want = jdg.diag_dens_moc(r.js, r.jmesh, r.cfg, fer_u=jfer[0],
                                 fer_v=jfer[1])
        for k, name in enumerate(dg.DMOC_BINNED):
            assert_close(got[k], np.asarray(want[name]), name, tol=TOL)


def test_dens_moc_bin_degenerate_and_nan_layers(run):
    """Layers with no density spread go whole to the nearest class (the
    first on a tie), a NaN interval to class 0: the walk and the plain
    version agree; chunks of elements change nothing."""
    r = run
    dens, *rest = binning_inputs(r)
    dens = dens.clone()
    dens[2] = dens[1]                          # layer 1: degenerate
    mid = 0.5 * (dg.STD_DENS[40] + dg.STD_DENS[41])
    dens[3:5, :4] = mid                        # a tie between two classes
    dens[6, 7] = float("nan")
    want = dg.dens_moc_bin_plain(dens, *rest)
    got = kernel_walk(dens, *rest)
    finite = np.isfinite(to_numpy(want)).all(axis=(0, 1))
    for k, name in enumerate(dg.DMOC_BINNED):
        assert_close(got[k][:, finite], to_numpy(want[k])[:, finite], name,
                     tol=TOL)
    # the NaN interval's weight lands in class 0
    assert float(want[4, 0, 7]) >= 1.0 and got[4, 0, 7] >= 1.0
    chunked = dg.dens_moc_bin_plain(dens, *rest, chunk=5)
    assert torch.equal(chunked[:, :, finite], want[:, :, finite])


def test_dens_moc_bin_counts_and_work(run):
    r = run
    dens, _, _, _, _, ule, nle, bins = binning_inputs(r)
    active, runs, nearest, columns, widths = dg.dens_moc_bin_counts(
        dens, ule, nle, bins)
    assert len(widths) == bins.shape[0] + 1
    assert sum(widths) == r.mesh.n_elems
    assert active == int(r.mesh.elem_layer_mask.sum())
    assert columns == int(r.mesh.elem_layer_mask.any(0).sum())
    assert runs >= active - nearest > 0
    E, S = r.mesh.n_elems, bins.shape[0]
    assert active < (r.mesh.nl - 1) * E
    nbytes, flops = dg.dens_moc_bin_work(E, S, 8, active, runs, nearest,
                                         columns, False)
    assert nbytes == (4 * active + columns + (1 + 5 * S) * E + S) * 8 \
        + 8 * E
    assert flops == 6 * active + 13 * runs + (S + 7) * nearest
    assert dg.dens_moc_bin_work(E, S, 8, active, runs, nearest, columns,
                                True)[0] == nbytes + 2 * active * 8


@pytest.mark.parametrize("odd", [False, True])
def test_dens_moc_bin_span_widths_against_numpy(run, odd):
    """The span widths of dens_moc_bin_counts against a direct count, an
    element and a layer at a time: a layer of spread above 1e-10 sends
    weight to the classes whose lower edge lies below dmax and upper edge
    above dmin, another to the class nearest its mid point (class 0 for a
    NaN interval); an element's span runs from its first such class to its
    last."""
    r = run
    args = odd_binning_inputs(r) if odd else binning_inputs(r)
    dens, _, _, _, _, ule, nle, bins = (to_numpy(a) for a in args)
    S = bins.shape[0]
    lo = np.r_[-1e30, 0.5 * (bins[:-1] + bins[1:])]
    hi = np.r_[0.5 * (bins[:-1] + bins[1:]), 1e30]
    want = np.zeros(S + 1, int)
    for e in range(dens.shape[1]):
        classes = []
        for lay in range(int(ule[e]) - 1, int(nle[e]) - 1):
            d0, d1 = dens[lay, e], dens[lay + 1, e]
            dmin, dmax = min(d0, d1), max(d0, d1)
            if np.isnan(d0) or np.isnan(d1):
                classes.append(0)
            elif dmax - dmin > 1e-10:
                classes += [s for s in range(S)
                            if lo[s] < dmax and hi[s] > dmin]
            else:
                classes.append(int(np.argmin(np.abs(bins - 0.5 * (dmin
                                                                  + dmax)))))
        want[max(classes) + 1 - min(classes) if classes else 0] += 1
    got = dg.dens_moc_bin_counts(args[0], *args[5:])[4]
    assert got == want.tolist()
    assert sum(w * n for w, n in enumerate(got)) > 0


def test_dens_moc_bin_wrapper_passes_what_the_kernel_takes(run, monkeypatch):
    """The launch path, recorded on tensors of the meta device: the C
    signature's arguments in order, a null pointer for absent bolus
    velocities, int32 levels."""
    r = run
    args = [a.to("meta") for a in binning_inputs(r)]
    calls = []

    def record(kernel, device, *a, entry=""):
        sig = kernels._ARGTYPES[kernel + entry]
        assert len(a) + 1 == len(sig)
        calls.append(a)

    monkeypatch.setattr(kernels, "launch", record)
    monkeypatch.setattr(kernels, "cuda_only", lambda x, what: None)
    out = dg.dens_moc_bin(*args)
    nl, E = args[0].shape
    S = args[-1].shape[0]
    assert out.shape == (5, S, E) and out.device.type == "meta"
    (a,) = calls
    assert a[4] is None and a[5] is None
    assert a[7].dtype == torch.int32 and a[8].dtype == torch.int32
    assert a[11:] == (nl, E, S, 1)
    dg.dens_moc_bin(*args[:4], *args[4:], fer_u=args[2], fer_v=args[3])
    assert calls[1][4] is args[2]
    with pytest.raises(ValueError, match="dtype"):
        dg.dens_moc_bin(args[0], args[1].float(), *args[2:])


def test_dmoc_invariants(run):
    """``tests/test_diagnostics.py:62-88`` on the port: the binned volume
    is the ocean volume, the binned transport the summed transport, most
    volume lies in the sigma_2 classes 30-40, the surface heat-flux
    binning sums to its domain total; each active layer's weights add to
    1."""
    r = run
    mesh, ts = r.mesh, r.ts
    al, be = eos.sw_alpha_beta(ts.tr[0], ts.tr[1], ts.Z_3d)
    out = dg.diag_dens_moc(ts, mesh, r.cfg, forcing=r.tof, sw_alpha=al,
                           sw_beta=be)
    lmask = mesh.elem_layer_mask
    VOL = out["std_dens_VOL"]
    vol = (torch.where(lmask, ts.helem, 0.0) * mesh.elem_area).sum()
    assert float(VOL.sum()) == pytest.approx(float(vol), rel=1e-10)
    udz = torch.where(lmask, ts.u * ts.helem, 0.0).sum()
    assert float(out["std_dens_UDZ"].sum()) == pytest.approx(
        float(udz), rel=1e-8, abs=1e-10)
    s = dg.STD_DENS
    mid = torch.as_tensor((s >= 30.0) & (s <= 40.0))
    assert float(VOL[mid].sum() / VOL.sum()) > 0.99
    hf = ((al[0] * r.tof.heat_flux)[mesh.elem_nodes].mean(-1) / 4.2e6
          * mesh.elem_area).sum()
    assert float(out["std_dens_flux_H"].sum()) == pytest.approx(
        float(hf), rel=1e-8)
    W = out["std_dens_W"].sum(0)
    assert float((W - lmask.sum(0)).abs().max()) <= 1e-12 * mesh.nl


# --------------------------------------------------------------------------
# the DVD diagnostic on the channel (tests/test_diagnostics.py:100-144)
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def channel(tmp_path_factory):
    d = write_mesh(channel_raw_mesh(8, 24, 10, dz=400.0),
                   str(tmp_path_factory.mktemp("channel")))
    m = setup_soufflet_model(d, device="cpu")
    m.cfg.diag.ldiag_DVD = True
    return m


def test_dvd_uniform_tracer_vanishes(channel):
    """A spatially uniform tracer has no discrete variance decay:
    advecting phi and phi^2 consistently gives target2 == adv1^2."""
    m = channel
    s = m.initial_state()
    mesh = m.mesh
    tr = s.tr.clone()
    tr[0] = torch.where(mesh.node_layer_mask, 10.0, 0.0)
    s = dataclasses.replace(s, tr=tr, tr_old=tr)
    s = m.step_fn()(s, zero_forcing(mesh))
    assert s.dvd_h.shape[0] == 2
    assert bool(torch.isfinite(s.dvd_h).all() & torch.isfinite(s.dvd_v).all())
    assert float(s.dvd_h[0].abs().max()) < 1e-8
    assert float(s.dvd_v[0].abs().max()) < 1e-8


def test_dvd_real_field_decays_variance(channel):
    """On the stratified channel the volume-weighted vertical DVD of T is
    positive after 5 steps; ``compute_diagnostics`` exposes the fields."""
    m = channel
    s = m.initial_state()
    f = zero_forcing(m.mesh)
    for _ in range(5):
        s = m.step_fn()(s, f)
    mesh = m.mesh
    vol = torch.where(mesh.node_layer_mask, s.hnode * mesh.areasvol[:-1],
                      0.0)
    assert bool(torch.isfinite(s.dvd_v).all())
    assert float((s.dvd_v[0] * vol).sum()) > 0.0
    out = dg.compute_diagnostics(s, mesh, m.cfg, f)
    assert "tr_dvd_vert_T" in out and "tr_dvd_horiz_S" in out
