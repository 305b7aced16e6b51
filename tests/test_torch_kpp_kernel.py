"""The data flow of ``csrc/kpp_column.cu`` walked in numpy on the CPU and
held against the plain torch version (``kpp.kpp_column_plain``).

The level-3 globe with 20 layers and partial cells, float64 (501 nodes, so
the last tile is ragged), its columns recut through
``mesh.globe.recut_columns`` to one wet layer and to full depth beside the
globe's own depths, T/S of the fixtures, seeded velocities, N^2 and the
buoyancy difference from ``eos.pressure_bv_plain``; the surface buoyancy
forcing Bo forced above 0 in some columns and below 0 in others, one
column with no bulk Richardson number above Ricr and one whose first
crossing is at interface 1.  Double diffusion off (32-column tiles) and on
(16-column tiles, as the kernel takes in float64).

The walk follows the kernel: per tile, the cells it stages (the others NaN,
so a read of one shows), phase (a, b) at every cell with the interior
values written over N^2 and the bulk Richardson number over dbsfc, the
first crossing as a minimum over the levels, phases (c1) to (c3) per
column (the surface terms, hbl, kbl and kn; the velocity scales and the
interior coefficients at kn; the matching), phase (d) at every cell with
each output row written once (the outputs start as NaN, so a missed write
shows).  With torch's CPU ``pow``, ``sqrt`` and
``exp`` it equals the plain version bit for bit; with numpy's, which round
``pow`` and ``sqrt`` otherwise in the last bit (``exp`` alike here), within
1e-14 of max|plain| with the boundary layer's last level kbl and the
matching level kn equal in every column.

On the card (``cuda`` marker): the kernel on the same columns, float64 and
float32, double diffusion off and on, against the outputs' SHA-256 of the
first design of the kernel (one thread walking each column three times),
recorded on an NVIDIA H100 80GB HBM3, and against the plain version within
1e-12 / 1e-5 of max|plain| (float32: or kbl moved by rounding, in a few
columns).
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from fesom2_tpu_torch import kernels
from fesom2_tpu_torch.core import eos
from fesom2_tpu_torch.core.mixing import kpp
from fesom2_tpu_torch.core.state import (allocate_state, init_thickness_linfs,
                                         initial_z3d, zero_forcing)
from fesom2_tpu_torch.mesh import build_mesh, globe
from fesom2_tpu_torch.model import pi_config
from fesom2_tpu_torch.scripts.timing import digest

TOL = 1e-14
PC = dict(force_rotation=True, cyclic_length_deg=360.0,
          use_partial_cell=True, partial_cell_thresh=0.0)
NO_CROSSING = 11       # a full-depth column of recut_columns
CROSS_AT_1 = 102       # a convective column of the globe's own depth


def tile_of(dd: bool) -> int:
    """Columns a block of the float64 kernel takes."""
    return 16 if dd else 32


def column_args(device, dtype, dd: bool, path: str):
    """kpp_column's arguments on the recut level-3 globe (see the module
    docstring), made on the CPU in float64 and then cast and moved."""
    torch.set_num_threads(1)
    m = build_mesh(path, device="cpu", **PC)
    fx = globe.globe_fixtures(*(x.numpy() for x in (
        m.geo_coords[:, 1], m.elem_nodes, m.Z, m.nlevels_node, m.area[0])),
        seed=5)
    st = init_thickness_linfs(allocate_state(m, 2, torch.float64), m)
    nlev, mask, cut = globe.recut_columns(
        m.nlevels_node.numpy(), m.nl, m.zbar.numpy(), m.Z.numpy(),
        {k: getattr(st, k).numpy() for k in ("Z_3d", "zbar_3d", "hnode")})
    rng = np.random.default_rng(5)
    uv = rng.uniform(-0.3, 0.3, (2,) + mask.shape) * mask
    st = dataclasses.replace(
        st, tr=torch.tensor(np.stack([fx["T"], fx["S"]])),
        unode=torch.tensor(uv[0]), vnode=torch.tensor(uv[1]),
        **{k: torch.tensor(v) for k, v in cut.items()})
    m = dataclasses.replace(
        m, nlevels_node=torch.as_tensor(nlev, dtype=m.nlevels_node.dtype),
        node_layer_mask=torch.as_tensor(mask))
    dref = eos.reference_density(m, initial_z3d(m, torch.float64)[1], 1)
    st = eos.pressure_bv_plain(st, m, pi_config(), dref)
    frc = dataclasses.replace(zero_forcing(m, torch.float64), **{
        k: torch.tensor(fx[k]) for k in ("stress_x", "stress_y",
                                         "heat_flux", "water_flux")})
    cfg = copy.deepcopy(pi_config())
    cfg.tra.double_diffusion = dd
    args = list(kpp.column_inputs(st, m, cfg, frc))
    Bo, dbsfc = args[8].clone(), args[3].clone()
    scale = float(Bo.abs().max())
    Bo[0::5] = 0.5 * scale          # stable columns
    Bo[2::5] = -0.5 * scale         # convective columns
    dbsfc[:, NO_CROSSING] = 0.0     # Rib = 0 all the way down
    dbsfc[1, CROSS_AT_1] = 1e3      # Rib(1) far above Ricr
    args[8], args[3] = Bo, dbsfc

    def put(x):
        if not isinstance(x, torch.Tensor):
            return x
        return x.to(device) if x.dtype == torch.int32 \
            else x.to(device=device, dtype=dtype)
    return tuple(put(x) for x in args)


@pytest.fixture(scope="module")
def globe_path(tmp_path_factory):
    return globe.write_globe(str(tmp_path_factory.mktemp("globe")), level=3,
                             n_layers=20, dz_bottom=600.0)


# --------------------------------------------------------------------------
# the numpy walk of the kernel
# --------------------------------------------------------------------------
NUMPY = dict(pow=np.power, sqrt=np.sqrt, exp=np.exp)
TORCH = dict(pow=lambda x, e: torch.pow(torch.from_numpy(x), e).numpy(),
             sqrt=lambda x: torch.sqrt(torch.from_numpy(x)).numpy(),
             exp=lambda x: torch.exp(torch.from_numpy(x)).numpy())

EPS_KPP, VONK, CONC1 = 0.1, 0.4, 5.0
CONAM, CONCM, CONC2, ZETAM = 1.257, 8.380, 16.0, -0.2
CONAS, CONCS, CONC3, ZETAS = -28.86, 98.96, 16.0, -1.0
CEKMAN, CMONOB, RIINFTY = 0.7, 1.0, 0.8


def _max_nan(a, b):
    return np.where(np.isnan(a) | np.isnan(b), a + b, np.where(a > b, a, b))


def _min_nan(a, b):
    return np.where(np.isnan(a) | np.isnan(b), a + b, np.where(a < b, a, b))


def _sign(x):
    return np.where(x > 0, 1.0, np.where(x < 0, -1.0, x))


def _wscale(zehat, us, eps, f):
    """wscale of the kernel: (wm, ws)."""
    u3 = us * us * us
    zeta = zehat / (u3 + eps)
    stable_wm = VONK * us / (1.0 + CONC1 * zeta)
    wm = np.where(zeta > ZETAM,
                  VONK * us * f["pow"](np.abs(1.0 - CONC2 * zeta), 0.25),
                  VONK * f["pow"](np.abs(CONAM * u3 - CONCM * zehat),
                                  1.0 / 3.0))
    ws = np.where(zeta > ZETAS,
                  VONK * us * f["sqrt"](np.abs(1.0 - CONC3 * zeta)),
                  VONK * f["pow"](np.abs(CONAS * u3 - CONCS * zehat),
                                  1.0 / 3.0))
    stab = zehat >= 0.0
    return np.where(stab, stable_wm, wm), np.where(stab, stable_wm, ws)


def kpp_walk(args, tile, f=NUMPY):
    """The kernel's data flow on the arguments of ``kpp_column`` (float64
    CPU tensors); returns ((viscA, Kv, Kv_s or None, nonloc), levels):
    per column the first crossing (``1 << 30`` for none), kbl and kn."""
    (un, vn, bv, dbsfc, zb3, Z3, hnode, ustar, Bo, fcor, nlevels, cfg, dd,
     alpha, beta, tt, ss) = (x.numpy() if isinstance(x, torch.Tensor) else x
                             for x in args)
    nl, N = zb3.shape
    L = nl - 1
    Vtc, cg = kpp.kpp_constants(cfg)
    Ricr = cfg.dyn.Ricr
    eps = kpp.guard_eps(torch.float64)
    dyn, tra = cfg.dyn, cfg.tra
    nan = np.nan
    outs = [np.full((nl, N), nan) for _ in range(4 if dd else 3)]
    levels = {k: np.zeros(N, int) for k in ("first", "kbl", "kn")}
    with np.errstate(all="ignore"):
        for n0 in range(0, N, tile):
            cols = np.arange(n0, min(N, n0 + tile))
            w = cols.shape[0]
            ar = np.arange(w)
            nln1 = nlevels[cols].astype(int) - 1
            kbot = np.maximum(nln1 - 1, 1)
            # staging: the cells the kernel copies, NaN elsewhere
            lay = lambda: np.full((L, w), nan)
            itf = lambda: np.full((nl, w), nan)
            sU, sV, sZ, sH = lay(), lay(), lay(), lay()
            sA, sBe, sT, sS = lay(), lay(), lay(), lay()
            sB, sD, sZb, sK, sKs = itf(), itf(), itf(), itf(), itf()
            for k in range(nl):
                if k < L:
                    need = (k < nln1) | (k == 1)
                    wet = k < nln1
                    sU[k] = np.where(need, un[k, cols], nan)
                    sV[k] = np.where(need, vn[k, cols], nan)
                    sZ[k] = np.where(need, Z3[k, cols], nan)
                    sH[k] = np.where(wet, hnode[k, cols], nan)
                    if dd:
                        for s_, a_ in ((sA, alpha), (sBe, beta), (sT, tt),
                                       (sS, ss)):
                            s_[k] = np.where(wet, a_[k, cols], nan)
                itfw = k <= nln1
                sB[k] = np.where(itfw, bv[k, cols], nan)
                sD[k] = np.where(itfw, dbsfc[k, cols], nan)
                sZb[k] = np.where(itfw, zb3[k, cols], nan)
            us, bo = ustar[cols], Bo[cols]
            stable = 0.5 + 0.5 * _sign(bo)
            sigma0 = stable + (1.0 - stable) * EPS_KPP

            def interior(a, k):
                """Row k's interior value after the surface and bottom
                copies (k may differ per column)."""
                k = np.broadcast_to(k, (w,))
                src = np.where(k == 0, 1, np.where(k == nln1, kbot, k))
                return np.where(k > nln1, 0.0, a[np.minimum(src, nl - 1), ar])

            # (a, b): every cell
            cross = np.full(w, 1 << 30)
            u0, v0 = sU[0], sV[0]

            def dvsq(k):
                k = np.broadcast_to(k, (w,))
                km1 = np.maximum(k - 1, 0)
                ui = 0.5 * (sU[km1, ar] + sU[np.minimum(k, L - 1), ar])
                vi = 0.5 * (sV[km1, ar] + sV[np.minimum(k, L - 1), ar])
                du, dv = u0 - ui, v0 - vi
                return np.where(k == 0, 0.0, du * du + dv * dv)
            for k in range(1, nl):
                b = sB[k].copy()
                doraw = k <= kbot
                visc = np.zeros(w)
                diff = np.zeros(w)
                if k <= nl - 2:
                    dz = sZ[k - 1] - sZ[k]
                    dz_inv = 1.0 / np.where(dz == 0.0, 1.0, dz)
                    du = (sU[k - 1] - sU[k]) * dz_inv
                    dv = (sV[k - 1] - sV[k]) * dz_inv
                    shear = du * du + dv * dv
                    Ri = np.where(b < 0.0, 0.0, b) / (shear + eps)
                    ratio = np.where(Ri < 0.0, 0.0, Ri) / RIINFTY
                    ratio = np.where(ratio > 1.0, 1.0, ratio)
                    fr = 1.0 - ratio * ratio
                    frit = fr * fr * fr
                    visc = dyn.visc_sh_limit * frit + dyn.A_ver
                    diff = tra.diff_sh_limit * frit + tra.K_ver
                if dd:
                    addT, addS = np.zeros(w), np.zeros(w)
                    if k <= L - 1:
                        inner = k <= nln1 - 1
                        aDT = sA[k - 1] * (sT[k - 1] - sT[k])
                        bDS = sBe[k - 1] * (sS[k - 1] - sS[k])
                        bsafe = np.where(bDS == 0.0, 1.0, bDS)
                        fing = inner & (aDT > bDS) & (bDS > 0.0)
                        Rf = aDT / bsafe
                        Rf = np.where(Rf > 1.9, 1.9, Rf)
                        q = 1.0 - (Rf - 1.0) / (1.9 - 1.0)
                        q = 1.0e-4 * q * q * q
                        addT = np.where(fing, 0.7 * q, addT)
                        addS = np.where(fing, q, addS)
                        conv = inner & (aDT < 0.0) & (aDT > bDS)
                        Rs = aDT / bsafe
                        ddc = (1.5e-6 * 0.909) * f["exp"](
                            4.6 * f["exp"](-0.54 * (1.0 / Rs - 1.0)))
                        pr = np.where(Rs > 0.5, (1.85 - 0.85 / Rs) * Rs,
                                      0.15 * Rs)
                        addT = np.where(conv, addT + ddc, addT)
                        addS = np.where(conv, addS + pr * ddc, addS)
                    sKs[k] = np.where(doraw, diff + addS, sKs[k])
                    diff = diff + addT
                sK[k] = np.where(doraw, diff, sK[k])
                sB[k] = np.where(doraw, visc, sB[k])
                dorib = k <= nln1
                zb = np.abs(sZb[k])
                zehat = VONK * sigma0 * zb * bo
                ws = _wscale(zehat, us, eps, f)[1]
                Vtsq = zb * ws * f["sqrt"](np.abs(b)) * Vtc
                dv2 = np.where(k == nln1, dvsq(nln1 - 1), dvsq(k))
                rib = zb * sD[k] / (dv2 + Vtsq + eps)
                sD[k] = np.where(dorib, rib, sD[k])
                cross = np.where(dorib & (rib > Ricr), np.minimum(cross, k),
                                 cross)

            # (c1) to (c3): the column's values
            zbf = lambda k: np.abs(sZb[k, ar])
            has = cross != 1 << 30
            kbl = np.where(has, cross, nln1)
            rib_k = sD[kbl, ar]
            rib_km1 = np.where(kbl == 1, 0.0, sD[np.maximum(kbl - 1, 0), ar])
            zk, zkm1 = zbf(kbl), zbf(np.maximum(kbl - 1, 0))
            hbl = np.where(has, zkm1 + (zk - zkm1) * (Ricr - rib_km1)
                           / (rib_k - rib_km1 + eps), zbf(nln1))
            hekman = CEKMAN * us / _max_nan(np.abs(fcor[cols]), eps)
            hmonob = CMONOB * (us * us * us) / VONK / (bo + eps)
            hlimit = stable * _min_nan(hekman, hmonob)
            lim = bo > 0.0
            hbl = np.where(lim, _min_nan(hbl, hlimit), hbl)
            hbl = np.where(lim, _max_nan(hbl, zbf(1)), hbl)
            kbl = nln1.copy()
            found = np.zeros(w, bool)
            for k in range(1, nl):
                hit = ~found & (k <= nln1) & (np.abs(sZb[k]) > hbl)
                kbl = np.where(hit, k, kbl)
                found |= hit
            kblm1 = np.maximum(kbl - 1, 0)
            dzup_k = zbf(kbl) - zbf(kblm1)
            caseA = 0.5 + 0.5 * _sign(zbf(kbl) - 0.5 * dzup_k - hbl)

            def h(k):
                return np.where(k < nln1, sH[np.clip(k, 0, L - 1), ar], 0.0)

            def dthick(k):
                d = np.where(k == nln1, 0.5 * h(np.maximum(nln1 - 1, 0)),
                             np.where(k == 0, 0.5 * h(np.zeros_like(k)),
                                      np.where(k <= nl - 2,
                                               0.5 * (h(k - 1) + h(k)), 0.0)))
                return np.where(d < 1e-12, 1e-12, d)
            sigma_h = stable + (1.0 - stable) * EPS_KPP
            wm_h, ws_h = _wscale(VONK * sigma_h * hbl * bo, us, eps, f)
            kn = np.where(caseA > 0.5, kbl - 1, kbl)
            kn = np.where(kn < nln1 - 1, kn, nln1 - 1)
            knm1 = np.maximum(kn - 1, 0)
            knp1 = np.where(kn + 1 < nln1, kn + 1, nln1)
            delhat = np.abs(sZ[np.minimum(kn, nl - 2), ar]) - hbl
            dth_kn, dth_knp1 = dthick(kn), dthick(knp1)
            R = 1.0 - delhat / dth_kn

            def interp(a):
                ckn = interior(a, kn)
                up = (interior(a, knm1) - ckn) / dth_kn
                dn = (ckn - interior(a, knp1)) / dth_knp1
                pp = 0.5 * ((1.0 - R) * (up + np.abs(up))
                            + R * (dn + np.abs(dn)))
                return pp, ckn + pp * delhat
            viscp, visch = interp(sB)
            diftp, difth = interp(sK)
            difsp, difsh = interp(sKs) if dd else (0.0, 0.0)
            u4 = f["pow"](us, 4.0)
            f1 = stable * CONC1 * bo / (u4 + eps)
            gat1 = {"m": visch / (hbl + eps) / (wm_h + eps),
                    "t": difth / (hbl + eps) / (ws_h + eps),
                    "s": difsh / (hbl + eps) / (ws_h + eps)}
            dat1 = {"m": _min_nan(-viscp / (wm_h + eps) + f1 * visch, 0.0),
                    "t": _min_nan(-diftp / (ws_h + eps) + f1 * difth, 0.0),
                    "s": _min_nan(-difsp / (ws_h + eps) + f1 * difsh, 0.0)}
            sig_k = zbf(kblm1) / (hbl + eps)
            sigma_k = stable * sig_k + (1.0 - stable) * _min_nan(sig_k,
                                                                 EPS_KPP)
            wm_k, ws_k = _wscale(VONK * sigma_k * hbl * bo, us, eps, f)
            a1k, a2k, a3k = sig_k - 2.0, 3.0 - 2.0 * sig_k, sig_k - 1.0

            def dkm1(wv, x):
                G = a1k + a2k * gat1[x] + a3k * dat1[x]
                return hbl * wv * sig_k * (1.0 + sig_k * G)
            dk = {"m": dkm1(wm_k, "m"), "t": dkm1(ws_k, "t"),
                  "s": dkm1(ws_k, "s")}
            zk0 = sZb[kblm1, ar]
            zk1 = sZb[np.minimum(kblm1 + 1, nl - 1), ar]
            delta = (hbl + zk0) / np.where(zk0 - zk1 == 0.0, 1.0, zk0 - zk1)
            for k, v in (("first", cross), ("kbl", kbl), ("kn", kn)):
                levels[k][cols] = v

            # (d): every cell, each output row written once
            k_enh = np.maximum(kbl - 1, 0)

            def enhance(inter, bl, dkv):
                dkmp5 = caseA * inter + (1.0 - caseA) * bl
                dstar = (1.0 - delta) * (1.0 - delta) * dkv \
                    + delta * delta * dkmp5
                return (1.0 - delta) * inter + delta * dstar
            for k in range(nl):
                lm = k <= nln1
                in_bl = (k >= 1) & (k < kbl) & lm
                sig = np.abs(sZ[min(k, nl - 2)]) / (hbl + eps)
                sig = np.where(in_bl, sig, nan)     # read only in the layer
                sigma_i = stable * sig + (1.0 - stable) * _min_nan(sig,
                                                                   EPS_KPP)
                wm_i, ws_i = _wscale(VONK * sigma_i * hbl * bo, us, eps, f)
                a1, a2, a3 = sig - 2.0, 3.0 - 2.0 * sig, sig - 1.0

                def blmc(wv, x):
                    G = a1 + a2 * gat1[x] + a3 * dat1[x]
                    return np.where(in_bl, hbl * wv * sig * (1.0 + sig * G),
                                    0.0)
                bm, bt = blmc(wm_i, "m"), blmc(ws_i, "t")
                bs = blmc(ws_i, "s") if dd else 0.0
                gh = np.where(in_bl, (1.0 - stable) * cg / (ws_i * hbl + eps),
                              0.0)
                vA, dK = interior(sB, k), interior(sK, k)
                dS = interior(sKs, k) if dd else 0.0
                at = k == k_enh
                bm = np.where(at, enhance(vA, bm, dk["m"]), bm)
                bt = np.where(at, enhance(dK, bt, dk["t"]), bt)
                if dd:
                    bs = np.where(at, enhance(dS, bs, dk["s"]), bs)
                gh = np.where(at, (1.0 - caseA) * gh, gh)
                outs[0][k, cols] = np.where(in_bl, _max_nan(vA, bm), vA)
                outs[1][k, cols] = np.where(
                    lm, np.where(in_bl, _max_nan(dK, bt), dK), 0.0)
                if dd:
                    outs[2][k, cols] = np.where(
                        lm, np.where(in_bl, _max_nan(dS, bs), dS), 0.0)
                nlc = gh * bt
                nlc = np.where(nlc > 1.0, 1.0, nlc)
                outs[-1][k, cols] = np.where((k >= 1) & (k < nln1), nlc, 0.0)
    viscA, Kv, *rest = outs
    Kv_s = rest[0] if dd else None
    return (viscA, Kv, Kv_s, rest[-1]), levels


@pytest.fixture(scope="module", params=[False, True], ids=["dd_off", "dd_on"])
def walked(request, globe_path):
    dd = request.param
    args = column_args("cpu", torch.float64, dd, globe_path)
    kernels.reset_launches()
    want = kpp.kpp_column(*args)
    assert kernels.LAUNCHES["kpp_column"] == 0      # the CPU path
    return dd, args, want, kpp_walk(args, tile_of(dd), TORCH)


def test_recut_columns_cover_the_cases(walked):
    dd, args, _, (_, lv) = walked
    nlev, Bo, dbsfc = args[10].numpy(), args[8].numpy(), args[3].numpy()
    L = args[4].shape[0] - 1
    assert nlev.shape[0] % tile_of(dd) != 0          # a ragged last tile
    assert int((nlev - 1 == 1).sum()) > 5
    assert int((nlev - 1 == L).sum()) > 5
    assert (Bo > 0).sum() > 50 and (Bo < 0).sum() > 50
    assert nlev[NO_CROSSING] - 1 == L and nlev[CROSS_AT_1] - 1 > 2
    assert not dbsfc[:, NO_CROSSING].any() and Bo[CROSS_AT_1] < 0
    assert lv["first"][NO_CROSSING] == 1 << 30
    assert lv["first"][CROSS_AT_1] == 1 and lv["kbl"][CROSS_AT_1] == 1
    # boundary layers of one level and of several, matching at the surface
    # and below it
    kbl, kn = lv["kbl"], lv["kn"]
    assert (kbl == 1).sum() > 10 and (kbl >= 3).sum() > 10
    assert (kn == 0).sum() > 10 and (kn >= 2).sum() > 10


def test_kpp_walk_equals_plain_bitwise(walked):
    dd, args, want, (got, _) = walked
    for name, g, w in zip(("viscA", "Kv", "Kv_s", "nonloc"), got, want):
        if w is None:
            assert g is None and not dd
            continue
        w = w.numpy()
        assert np.isfinite(w).all() and np.array_equal(g, w), name
    assert float(want[-1].max()) > 0.0      # a live nonlocal term


def test_kpp_walk_with_numpy_functions(walked):
    """numpy's pow and sqrt round otherwise than torch's in the last bit:
    the walk with them stays within 1e-14 of max|plain| and finds the same
    kbl and kn in every column."""
    dd, args, want, (_, lv) = walked
    got, lv_np = kpp_walk(args, tile_of(dd), NUMPY)
    for k in ("kbl", "kn"):
        assert np.array_equal(lv_np[k], lv[k]), k
    for name, g, w in zip(("viscA", "Kv", "Kv_s", "nonloc"), got, want):
        if w is None:
            continue
        w = w.numpy()
        assert np.isfinite(g).all(), name
        assert float(np.abs(g - w).max()) <= TOL * float(np.abs(w).max()), \
            name


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
# SHA-256 (first 16 hex digits) of the outputs' bytes (viscA, Kv, Kv_s if
# double diffusion, nonloc) of the first design of the kernel on these
# columns, on an NVIDIA H100 80GB HBM3 with torch 2.11.0+cu128 and CUDA
# 12.8 (another CUDA's pow or the inputs' CPU rounding under another torch
# may change them: record them anew from that design's source then)
PARENT_SHA = {
    ("float64", False): "c1a2d66cb692f1d0",
    ("float64", True): "a858c44e7c67f802",
    ("float32", False): "b6c2191b6730bcdd",
    ("float32", True): "758578fcf5650c78",
}


@pytest.mark.cuda
@pytest.mark.parametrize("dd", [False, True], ids=["dd_off", "dd_on"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_kpp_kernel_equals_first_design_on_card(globe_path, dtype, tol, dd):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = column_args("cuda", dtype, dd, globe_path)
    kernels.reset_launches()
    got = tuple(x for x in kpp.kpp_column(*args) if x is not None)
    want = tuple(x for x in kpp.kpp_column_plain(*args) if x is not None)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["kpp_column"] == 1
    tag = str(dtype).replace("torch.", "")
    assert digest(got) == PARENT_SHA[(tag, dd)]
    assert all(bool(torch.isfinite(g).all()) for g in got)
    bad = torch.zeros(args[0].shape[1], dtype=torch.bool, device="cuda")
    for g, w in zip(got, want):
        bad |= ((g - w).abs() > tol * w.abs().max()).any(0)
    if dtype == torch.float64:
        assert not bool(bad.any())
    else:
        # float32 rounding may move a boundary layer's last level (the
        # deepest interface with a nonlocal coefficient above 0): every
        # column beyond the tolerance is such a move, in at most 10
        lev = torch.arange(got[-1].shape[0], device="cuda")[:, None]
        depth = lambda x: torch.where(x > 0, lev, -1).amax(0)
        moved = depth(got[-1]) != depth(want[-1])
        assert int(bad.sum()) <= 10 and not bool((bad & ~moved).any())
