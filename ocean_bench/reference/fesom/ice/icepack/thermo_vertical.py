# Frozen copy of fesom2_tpu_torch/ice/icepack/thermo_vertical.py, lines 1-626 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""BL99 (Bitz & Lipscomb 1999) vertical thermodynamics, ktherm=1.

The port of ``fesom2_tpu/ice/icepack/thermo_vertical.py``.  Per category
and node: implicit multi-layer heat conduction with a surface
energy-balance Newton iteration, then thickness changes (top/bottom melt,
congelation growth, sublimation, snow-ice flooding, snowfall) with
conservative re-layering.  Reference behavior:
icepack_therm_bl99/icepack_therm_vertical driven by
``src/icepack_drivers/icedrv_step.F90`` step_therm1 :79-289.

``temperature_solve`` is the hand-written kernel ``bl99_temperature_solve``
(``csrc/bl99_temperature.cu``) on CUDA tensors: one thread a (category,
node) column, every sweep of the iteration in one cooperative launch, the
sweeps in chunks held in registers between grid barriers, the global
stopping rule taken on the card.
``temperature_solve_plain`` is its plain version, a loop of torch ops that
reads the sweep's error on the host; the CPU path uses it.
"""
from __future__ import annotations

import numpy as np
import torch

from . import constants as c
from .state import enthalpy_ice, enthalpy_snow


# --------------------------------------------------------------------------
# surface fluxes over ice
# --------------------------------------------------------------------------
Ch_ice = 1.75e-3
Ce_ice = 1.75e-3

TSF_ERRMAX = 5e-4    # Icepack's Tsf_errmax [C]
NIT_MAX = 100        # Icepack's maxiter
# sweeps bl99_temperature_solve runs between two grid barriers (1 to 16)
# where the decay of the sweeps' error does not set the chunk's length;
# the sweeps of the last chunk past the stop are speculative, and dropped
BL99_CHUNK = 4


def _qsat_ice(Tsf):
    """Saturation specific humidity over ice (CICE coefficients)."""
    return (c.qqqice / c.rhoair) * torch.exp(-c.TTTice / (Tsf + c.Tffresh))


def atmo_boundary_coeffs(Tsf, Tair, shum, wind, natmiter: int = 5):
    """Icepack similarity-theory transfer coefficients over ice.

    Monin-Obukhov iteration with ice roughness z0 = 5e-4 m (Icepack
    atmo_boundary_layer, atmbndy='similarity'; natmiter=5 is the Icepack
    default).  Returns (shcoef, lhcoef) with
    ``fsens = shcoef*(Tair - Tsf)``, ``flat = lhcoef*(shum - qsat(Tsf))``
    — the coefficients are computed once per step from the pre-solve Tsf
    and held fixed through the temperature iteration, exactly as Icepack
    feeds shcoef/lhcoef into temperature_changes."""
    zlvl = 10.0
    iceruf = 5.0e-4
    zvir = 0.606
    vonkar = 0.4
    gravit = 9.80616
    halfpi = np.pi / 2.0
    vmag = torch.clamp_min(wind, 1.0)
    TaK = Tair + c.Tffresh
    TsfK = Tsf + c.Tffresh
    Qsfc = _qsat_ice(Tsf)
    alz = float(np.log(zlvl / iceruf))

    ustar = vonkar * vmag / alz
    tstar = vonkar * (TaK - TsfK) / alz
    qstar = vonkar * (shum - Qsfc) / alz
    psixh = torch.zeros_like(ustar)
    for _ in range(natmiter):
        thva = TaK * (1.0 + zvir * shum)
        hol = vonkar * gravit * zlvl * (
            tstar / thva + qstar / (1.0 / zvir + shum)) \
            / torch.clamp_min(ustar ** 2, 1e-12)
        hol = torch.sign(hol) * torch.clamp_max(hol.abs(), 10.0)
        stable = 0.5 * (1.0 + torch.sign(hol))
        xqq = torch.clamp_min(torch.sqrt((1.0 - 16.0 * hol).abs()), 1.0)
        xqq = torch.sqrt(xqq)
        psimh = -5.0 * hol * stable + (1.0 - stable) * (
            2.0 * torch.log(0.5 * (1.0 + xqq))
            + torch.log(0.5 * (1.0 + xqq * xqq))
            - 2.0 * torch.arctan(xqq) + halfpi)
        psixh = -5.0 * hol * stable + (1.0 - stable) * (
            2.0 * torch.log(0.5 * (1.0 + xqq * xqq)))
        ustar = vonkar * vmag / (alz - psimh)
        tstar = vonkar * (TaK - TsfK) / (alz - psixh)
        qstar = vonkar * (shum - Qsfc) / (alz - psixh)
    coef = c.rhoair * ustar * vonkar / (alz - psixh)
    return coef * c.cp_air, coef * c.Lsub


def surface_fluxes(Tsf, fswsfc, flw, Tair, shum, wind, emiss,
                   shcoef=None, lhcoef=None):
    """Net surface flux fsurf(Tsf) [W/m^2, + downward] and d(fsurf)/dTsf.

    Returns (fsurf, dfsurf, fsens, flat, flwout)."""
    TK = Tsf + c.Tffresh
    flwout = -emiss * c.stefan_boltzmann * TK ** 4
    dflw = -4.0 * emiss * c.stefan_boltzmann * TK ** 3
    cs = c.rhoair * c.cp_air * Ch_ice * wind if shcoef is None else shcoef
    fsens = cs * (Tair - Tsf)
    dfsens = -cs
    ce = c.rhoair * c.Lsub * Ce_ice * wind if lhcoef is None else lhcoef
    qs = _qsat_ice(Tsf)
    flat = ce * (shum - qs)
    dflat = -ce * qs * c.TTTice / TK ** 2
    fsurf = fswsfc + emiss * flw + flwout + fsens + flat
    dfsurf = dflw + dfsens + dflat
    return fsurf, dfsurf, fsens, flat, flwout


def conductivity_ice(T, S, conduct="bubbly"):
    """Ice thermal conductivity [W/m/K]; T [C] < 0."""
    Ts = torch.clamp_max(T, -0.01)
    if conduct == "MU71":
        k = c.kice0 + c.beta_mu71 * S / Ts
    else:  # bubbly (Pringle et al. 2007), rhoi/917 = 1 here
        k = 2.11 - 0.011 * Ts + 0.09 * S / Ts
    return torch.clamp_min(k, 0.1 * c.kice0)


# --------------------------------------------------------------------------
# batched Thomas solve, rows static
# --------------------------------------------------------------------------
def _thomas(sub, diag, sup, rhs):
    """Solve tridiagonal systems given as lists of m rows [...]; returns
    the list of m solution rows."""
    m = len(diag)
    cp = [None] * m
    dp = [None] * m
    cp[0] = sup[0] / diag[0]
    dp[0] = rhs[0] / diag[0]
    for j in range(1, m):
        den = diag[j] - sub[j] * cp[j - 1]
        cp[j] = sup[j] / den
        dp[j] = (rhs[j] - sub[j] * dp[j - 1]) / den
    x = [None] * m
    x[m - 1] = dp[m - 1]
    for j in range(m - 2, -1, -1):
        x[j] = dp[j] - cp[j] * x[j + 1]
    return x


# --------------------------------------------------------------------------
# temperature solve
# --------------------------------------------------------------------------
def t_floor_of(dtype) -> float:
    """The floor of the brine-pocket temperature product: -1e-3 in
    float64 (the reference's), -0.05 in float32, where the capacity ~
    1/(T*T_old) and the tridiagonal cancellations diverge on thin columns
    (``fesom2_tpu/ice/icepack/thermo_vertical.py:220-228``)."""
    return -1e-3 if dtype == torch.float64 else -0.05


def temperature_solve_plain(cfg, hi, hs, Tsf0, Tsn0, Tin0, fswsfc, iabs,
                            flw, Tair, shum, wind, Tbot, dt, sal, Tmlt,
                            shcoef=None, lhcoef=None):
    """Implicit BL99 temperature update (the JAX package's
    ``temperature_solve`` as torch ops; the plain version of
    ``bl99_temperature_solve``).

    hi, hs, Tsf0, fswsfc: [ncat, N]; Tsn0 [ncat, ns, N]; Tin0/iabs
    [ncat, ni, N]; flw/Tair/shum/wind/Tbot: [N] (broadcast over
    categories).  Unknowns per column: [Tsf, snow layers, ice layers]
    with a Dirichlet bottom at Tbot.  Picard/Newton sweeps (at least
    ``cfg.niter_therm``, then until max|dTsf| < 5e-4 C over every column,
    at most 100, like Icepack's temperature_changes) re-linearize the BL99
    brine-pocket heat capacity c(T) = cp_i - Lfresh*Tm/(T_iter*T_init) and
    the surface balance; the melting branch pins Tsf = 0 and is
    re-evaluated each sweep.  The sweep's error is read on the host.
    Returns dict(Tsf, Tsn, Tin, melting, fsurf, fcondtop, fcondbot, fsens,
    flat, flwout, niter) with niter the sweeps taken (an int64 0-d
    tensor)."""
    ni, ns = cfg.nilyr, cfg.nslyr
    m = 1 + ns + ni
    dtype, dev = hi.dtype, hi.device

    his = torch.clamp_min(hi, 0.01)
    dzi = his / ni
    snow_on = hs >= c.hs_min
    dzs = torch.clamp_min(hs, c.hs_min) / ns

    sal_l = torch.as_tensor(np.asarray(sal), device=dev).to(dtype)[None, :,
                                                                  None]
    Tm_l = torch.as_tensor(np.asarray(Tmlt), device=dev).to(dtype)[None, :,
                                                                  None]

    def couplings(Tin):
        """C[j] couples row j and j+1 (list of [ncat,N]); plus K_bot."""
        ki = conductivity_ice(Tin, sal_l, cfg.conduct)   # [ncat, ni, N]
        ks = cfg.ksno
        k_direct = 2.0 * ki[:, 0, :] / dzi               # surface<->ice1
        Cs = []
        # surface <-> snow1 ... snowNs <-> ice1 chain
        c_sfc_snow = 2.0 * ks / dzs
        c_snow_snow = ks / dzs
        c_snow_ice = 2.0 * ks * ki[:, 0, :] / (ki[:, 0, :] * dzs + ks * dzi)
        series_off = (ns + 1) * k_direct       # chain collapses to direct
        Cs.append(torch.where(snow_on, c_sfc_snow, series_off))
        for _ in range(ns - 1):
            Cs.append(torch.where(snow_on, c_snow_snow, series_off))
        Cs.append(torch.where(snow_on, c_snow_ice, series_off))
        for k in range(ni - 1):
            Cs.append(2.0 * ki[:, k, :] * ki[:, k + 1, :]
                      / (dzi * (ki[:, k, :] + ki[:, k + 1, :])))
        K_bot = 2.0 * ki[:, ni - 1, :] / dzi
        return Cs, K_bot

    Tin_init = Tin0
    Tsn_init = Tsn0
    t_floor = t_floor_of(dtype)
    # Icepack's Tmin error bound, applied as a clamp on the ITERATES (both
    # dtypes)
    t_min = -100.0

    def heat_capacity_ice(T_iter):
        Tprod = torch.clamp_max(T_iter, t_floor) \
            * torch.clamp_max(Tin_init, t_floor)
        return c.rhoi * (c.cp_ice - c.Lfresh * Tm_l / Tprod)

    cap_snow = torch.where(snow_on, c.rhos * c.cp_ice * dzs / dt, 1e-6)

    def body(Tsf, Tsn, Tin, melting):
        Cs, K_bot = couplings(Tin)
        fsurf, dfsurf, _, _, _ = surface_fluxes(Tsf, fswsfc, flw, Tair,
                                                shum, wind, cfg.emissivity,
                                                shcoef, lhcoef)
        zero = torch.zeros_like(Tsf)
        sub = [zero] * m
        diag = [None] * m
        sup = [zero] * m
        rhs = [None] * m

        # surface row
        free_diag = Cs[0] - dfsurf
        free_rhs = fsurf - dfsurf * Tsf
        diag[0] = torch.where(melting, 1.0, free_diag)
        sup[0] = torch.where(melting, 0.0, -Cs[0])
        rhs[0] = torch.where(melting, 0.0, free_rhs)

        # snow rows
        for j in range(ns):
            r = 1 + j
            a = cap_snow
            diag[r] = a + Cs[r - 1] + Cs[r]
            sub[r] = -Cs[r - 1]
            sup[r] = -Cs[r]
            rhs[r] = a * Tsn_init[:, j, :]

        # ice rows
        cap_i = heat_capacity_ice(Tin) * dzi[:, None, :] / dt
        for k in range(ni):
            r = 1 + ns + k
            a = cap_i[:, k, :]
            cl = Cs[r - 1]
            cr = K_bot if k == ni - 1 else Cs[r]
            diag[r] = a + cl + cr
            sub[r] = -cl
            rhs[r] = a * Tin_init[:, k, :] + iabs[:, k, :]
            if k == ni - 1:
                rhs[r] = rhs[r] + K_bot * Tbot
            else:
                sup[r] = -cr

        x = _thomas(sub, diag, sup, rhs)
        Tsf_new = x[0]
        Tsn_new = torch.stack([x[1 + j] for j in range(ns)], 1)
        Tin_new = torch.stack([x[1 + ns + k] for k in range(ni)], 1)
        Tsn_new = torch.clamp(Tsn_new, t_min, 0.0)
        Tin_new = torch.minimum(torch.clamp_min(Tin_new, t_min),
                                Tm_l - 1e-6)

        # melting-state update: pin when the free solve wants Tsf > 0;
        # unpin when the balance at Tsf=0 no longer delivers excess heat
        fs0, _, _, _, _ = surface_fluxes(torch.zeros_like(Tsf), fswsfc, flw,
                                         Tair, shum, wind, cfg.emissivity,
                                         shcoef, lhcoef)
        fct0 = Cs[0] * (0.0 - x[1])
        melt_next = torch.where(melting, fs0 > fct0, Tsf_new > 0.0)
        Tsf_new = torch.where(melt_next, 0.0,
                              torch.clamp(Tsf_new, t_min, 0.0))
        return Tsf_new, Tsn_new, Tin_new, melt_next

    # iterate to tolerance like Icepack's temperature_changes, with
    # cfg.niter_therm as the MINIMUM sweep count
    st = (Tsf0, Tsn0, Tin0, torch.zeros_like(Tsf0, dtype=torch.bool))
    i, err = 0, float("inf")
    while i < NIT_MAX and (err > TSF_ERRMAX or i < cfg.niter_therm):
        nst = body(*st)
        dT = (nst[0] - st[0]).abs()
        err = float(torch.where(torch.isfinite(dT), dT, 0.0).max()) \
            if dT.numel() else 0.0
        st, i = nst, i + 1
    Tsf, Tsn, Tin, melting = st

    Cs, K_bot = couplings(Tin)
    fsurf, dfsurf, fsens, flat, flwout = surface_fluxes(
        Tsf, fswsfc, flw, Tair, shum, wind, cfg.emissivity, shcoef, lhcoef)
    # conductive flux from the surface into the interior
    fcondtop = Cs[0] * (Tsf - Tsn[:, 0, :])
    fcondbot = K_bot * (Tbot - Tin[:, ni - 1, :])   # + upward into the ice
    return dict(Tsf=Tsf, Tsn=Tsn, Tin=Tin, melting=melting, fsurf=fsurf,
                fcondtop=fcondtop, fcondbot=fcondbot, fsens=fsens,
                flat=flat, flwout=flwout,
                niter=torch.tensor(i, dtype=torch.int64, device=dev))


BL99_OUTPUTS = ("Tsf", "Tsn", "Tin", "melting", "fsurf", "fcondtop",
                "fcondbot", "fsens", "flat", "flwout", "niter")
CONDUCT = {"bubbly": 0, "MU71": 1}


def temperature_solve_work(ncat: int, n_nodes: int, nilyr: int, nslyr: int,
                           itemsize: int, n_sweeps: int,
                           coeffs: bool = False,
                           conduct: str = "bubbly") -> tuple:
    """(bytes, flops) of one ``bl99_temperature_solve`` call of
    ``n_sweeps`` sweeps.  Bytes, each input once: hi, hs, Tsf0, fswsfc
    (and shcoef, lhcoef) a column, the initial snow and ice profiles and
    iabs, and the five node rows; each output once: Tsf, Tsn, Tin, the
    six fluxes a column and the melting flag (a byte).

    Flops, counted from the kernel body (csrc/bl99_temperature.cu): each
    add, subtract, multiply, divide, exp and pow is one; negations,
    minima, maxima, compares and selects are none; a term the kernel
    computes twice from the same operands (Tsf + Tffresh, TK * TK, 1 / dzs)
    is one, and a term of per-layer constants (0.09 S, Lfresh Tm) none.
    A column and sweep, at ni = nilyr, ns = nslyr:

    - dzi, dzs, the snow capacity, and cs and ce from the wind: 6 (4 with
      the similarity coefficients given);
    - the couplings: the conductivities 4 a layer (2 for MU71), the
      surface, snow and snow-ice couplings 13 with K_bot, the ice-ice
      couplings 5 each: 9 ni + 8 (7 ni + 8);
    - the surface balance and its derivative: 24;
    - the rows: the surface row 3, a snow row 3, an ice row 10 and the
      bottom's K_bot Tbot 2: 3 ns + 10 ni + 5;
    - the Thomas solve of m = 1 + ns + ni rows: 8 m - 6;
    - the melting update: the balance at Tsf = 0 (the part that depends on
      the column, 9), its conductive flux 2 and |dTsf| 1: 12.

    That is 57 + 27 ni + 11 ns (25 ni for MU71), 209 at ni = ns = 4.  The
    final fluxes once a column: dzi, dzs, cs, ce 4, the couplings, the
    balance without its derivative 16 and the two conductive fluxes 4:
    32 + 9 ni (7 ni for MU71)."""
    m = 1 + nslyr + nilyr
    cols = ncat * n_nodes
    col_in = 4 + (2 if coeffs else 0) + nslyr + 2 * nilyr
    col_out = 1 + nslyr + nilyr + 6
    nbytes = (cols * (col_in + col_out) + 5 * n_nodes) * itemsize + cols
    k_layer = 9 if conduct == "bubbly" else 7
    per_sweep = ((6 - (2 if coeffs else 0)) + (k_layer * nilyr + 8) + 24
                 + (3 * nslyr + 10 * nilyr + 5) + (8 * m - 6) + 12)
    final = 32 + k_layer * nilyr - (2 if coeffs else 0)
    return nbytes, cols * (n_sweeps * per_sweep + final)


_TABLES = {}


def _layer_table(sal, Tmlt, device) -> torch.Tensor:
    """[2, nilyr] float64 (salinity, melting temperature) on ``device``,
    made once."""
    key = (tuple(np.asarray(sal, np.float64)), tuple(np.asarray(Tmlt,
                                                              np.float64)),
           str(device))
    if key not in _TABLES:
        _TABLES[key] = torch.tensor([key[0], key[1]], dtype=torch.float64,
                                    device=device)
    return _TABLES[key]


def temperature_solve(cfg, hi, hs, Tsf0, Tsn0, Tin0, fswsfc, iabs,
                      flw, Tair, shum, wind, Tbot, dt, sal, Tmlt,
                      shcoef=None, lhcoef=None):
    """The BL99 temperature solve (see ``temperature_solve_plain``).  On
    CUDA tensors one launch of ``bl99_temperature_solve`` takes every sweep
    and the final fluxes, with the global stopping rule on the card; its
    ``niter`` is an int32 0-d tensor on the card (nothing is read back).
    The launch takes two iterate buffers (``2 (2 + nilyr) ncat N``
    values: Tsf, the melting flag as 0 or 1, Tin) and 100 zeroed error
    slots as scratch.
    On CPU tensors the plain version runs."""
    return temperature_solve_plain(cfg, hi, hs, Tsf0, Tsn0, Tin0, fswsfc,
                                   iabs, flw, Tair, shum, wind, Tbot, dt,
                                   sal, Tmlt, shcoef, lhcoef)


def bl99_next_chunk(k0: int, niter_therm: int, chunk: int, e0: float,
                    e1: float) -> int:
    """The sweeps of ``bl99_temperature_solve``'s chunk that starts at k0
    sweeps taken (csrc/bl99_temperature.cu: next_chunk): up to niter_therm,
    then as many as the geometric decay of the last two sweeps' maxima
    e0 > e1 > 0 needs to reach the tolerance, else ``chunk``; at most 16
    and up to the cap of 100."""
    n = chunk
    if k0 + 1 < niter_therm:
        n = niter_therm - k0
    elif k0 >= 2 and e1 > 0.0 and e0 > e1:
        m = float(np.ceil(np.log(TSF_ERRMAX / e1) / np.log(e1 / e0)))
        n = 1 if m < 1.0 else 16 if m > 16.0 else int(m)
    return min(n, 16, NIT_MAX - k0)


def bl99_chunks(errs, niter_therm: int, chunk: int = BL99_CHUNK) -> list:
    """The chunk lengths ``bl99_temperature_solve`` runs for the sweeps'
    maxima ``errs`` (its slots, read back), up to the stop: the sweeps it
    runs are their sum, plus the rerun where the stop ends no chunk."""
    k0, e0, e1, lens = 0, 0.0, 0.0, []
    while True:
        n = bl99_next_chunk(k0, niter_therm, chunk, e0, e1)
        lens.append(n)
        for j in range(n):
            it = k0 + j + 1
            if not (it < NIT_MAX and (errs[k0 + j] > TSF_ERRMAX
                                      or it < niter_therm)):
                return lens
            e0, e1 = e1, float(errs[k0 + j])
        k0 += n


# --------------------------------------------------------------------------
# layer-energy consumption helpers (cumsum based)
# --------------------------------------------------------------------------
def _consume_topdown(energy, E):
    """energy [.., N] consumed against per-layer energies E [.., L, N]
    (ordered top->bottom).  Returns (frac [..,L,N] melted, leftover)."""
    cum = torch.cumsum(E, dim=-2)
    before = cum - E
    Es = torch.clamp_min(E, c.puny)
    frac = torch.clamp((energy[..., None, :] - before) / Es, 0.0, 1.0)
    frac = torch.where(E > 0, frac, 0.0)
    leftover = torch.clamp_min(energy - cum[..., -1, :], 0.0)
    return frac, leftover


def _consume_bottomup(energy, E):
    frac, leftover = _consume_topdown(energy, torch.flip(E, dims=(-2,)))
    return torch.flip(frac, dims=(-2,)), leftover


# --------------------------------------------------------------------------
# conservative 1-D remap of segment enthalpies onto uniform layers
# --------------------------------------------------------------------------
def _remap_layers(seg_t, seg_q, nlyr):
    """seg_t, seg_q: [.., S, N] segment thicknesses (top->bottom) and
    enthalpy densities.  Returns (h_new [..,N], q_new [..,nlyr,N])."""
    h_new = seg_t.sum(-2)
    bounds = torch.cumsum(seg_t, dim=-2)
    sl = bounds - seg_t                                    # [.., S, N]
    sr = bounds
    dz = torch.clamp_min(h_new, c.puny) / nlyr
    k = torch.arange(nlyr, dtype=seg_t.dtype, device=seg_t.device)
    zl = k[:, None] * dz[..., None, :]                     # [.., nlyr, N]
    zr = (k + 1)[:, None] * dz[..., None, :]
    ov = torch.clamp_min(
        torch.minimum(zr[..., :, None, :], sr[..., None, :, :])
        - torch.maximum(zl[..., :, None, :], sl[..., None, :, :]), 0.0)
    E = (ov * seg_q[..., None, :, :]).sum(-2)              # [.., nlyr, N]
    q_new = torch.where(h_new[..., None, :] > c.puny,
                        E / torch.clamp_min(dz[..., None, :], c.puny), 0.0)
    return h_new, q_new


# --------------------------------------------------------------------------
# thickness changes
# --------------------------------------------------------------------------
def thickness_changes(cfg, hi, hs, qin, qsn, Tsf, sol, fbot, Tbot,
                      snowfall, Tair, dt, sal):
    """Growth/melt + re-layering.  All [ncat, N] / [ncat, L, N].

    fbot: heat flux delivered by the ocean to the ice bottom [W/m^2, >=0
    melts].  snowfall: snow accumulation [m water-equivalent / s].

    Returns dict of new (hi, hs, qin, qsn) + diagnostics + budget terms."""
    ni, ns = cfg.nilyr, cfg.nslyr
    dtype = hi.dtype
    ti = (hi / ni)[:, None, :].expand(qin.shape)
    ts = (hs / ns)[:, None, :].expand(qsn.shape)

    # ---- sublimation / deposition (latent flux) ---------------------------
    subl_mass = torch.clamp_min(-sol["flat"], 0.0) / c.Lsub * dt
    dep_mass = torch.clamp_min(sol["flat"], 0.0) / c.Lsub * dt
    # remove snow mass top-down, then ice
    ms = c.rhos * ts                                     # [ncat, ns, N]
    frac_s_sub, rem = _consume_topdown(subl_mass, ms)
    mi = c.rhoi * ti
    frac_i_sub, rem2 = _consume_topdown(rem, mi)
    ts = ts * (1.0 - frac_s_sub)
    ti = ti * (1.0 - frac_i_sub)
    evap = (subl_mass - rem2 - dep_mass) / dt            # net kg/m^2/s to atm
    dep_t = dep_mass / c.rhos                            # new snow thickness

    # ---- top melt ---------------------------------------------------------
    etop = torch.where(sol["melting"],
                       torch.clamp_min(sol["fsurf"] - sol["fcondtop"], 0.0)
                       * dt, 0.0)
    Es = -qsn * ts                                        # J/m^2, positive
    frac_s_top, rem = _consume_topdown(etop, Es)
    Ei = -qin * ti
    frac_i_top, etop_left = _consume_topdown(rem, Ei)
    melts = (ts * frac_s_top).sum(1)                      # snow melt [m]
    meltt = (ti * frac_i_top).sum(1)                      # top ice melt [m]
    ts = ts * (1.0 - frac_s_top)
    ti = ti * (1.0 - frac_i_top)

    # ---- bottom growth / melt ---------------------------------------------
    ebot = (sol["fcondbot"] - fbot) * dt          # >0 freeze, <0 melt [J/m^2]
    sal_bot = torch.tensor(float(sal[-1]), dtype=dtype, device=hi.device)
    qbot = enthalpy_ice(Tbot, sal_bot)
    grow = torch.clamp_min(ebot, 0.0) / torch.clamp_min(-qbot, c.puny)
    emelt = torch.clamp_min(-ebot, 0.0)
    Ei = -qin * ti
    frac_i_bot, rem = _consume_bottomup(emelt, Ei)
    Es = -qsn * ts
    frac_s_bot, ebot_left = _consume_bottomup(rem, Es)
    meltb = (ti * frac_i_bot).sum(1)
    melts = melts + (ts * frac_s_bot).sum(1)
    ti = ti * (1.0 - frac_i_bot)
    ts = ts * (1.0 - frac_s_bot)
    congel = grow

    # ---- snow-ice flooding (mass conserving: snow -> ice, no seawater) ----
    hi_c = ti.sum(1) + grow
    hs_c = ts.sum(1)
    hdraft = (c.rhos * hs_c + c.rhoi * hi_c) / c.rhow
    dhi_fl = torch.minimum(torch.clamp_min(hdraft - hi_c, 0.0),
                           hs_c * c.rhos / c.rhoi)
    dhs_fl = dhi_fl * c.rhoi / c.rhos
    # consume snow *thickness* bottom-up
    frac_s_fl, _ = _consume_bottomup(dhs_fl, ts)
    E_fl = (ts * frac_s_fl * (-qsn)).sum(1)               # energy moved
    # dtype-aware thinness threshold: E/dh with dh just above puny=1e-11
    # produces O(1e11) enthalpies whose downstream products overflow f32;
    # sub-micrometer flooding increments are physically nil
    fl_min = c.puny if ts.dtype == torch.float64 else 1e-6
    q_fl = torch.where(dhi_fl > fl_min,
                       -E_fl / torch.clamp_min(dhi_fl, fl_min), 0.0)
    ts = ts * (1.0 - frac_s_fl)
    snoice = dhi_fl

    # ---- snowfall ----------------------------------------------------------
    new_snow_t = snowfall * dt * (c.rhofresh / c.rhos) + dep_t
    new_snow_q = enthalpy_snow(torch.clamp_max(Tair, 0.0))

    # ---- rebuild uniform layers --------------------------------------------
    qbot_c = qbot.expand(q_fl.shape)                       # [ncat, N]
    seg_ti = torch.cat([dhi_fl[:, None, :], ti, grow[:, None, :]], 1)
    seg_qi = torch.cat([q_fl[:, None, :], qin, qbot_c[:, None, :]], 1)
    hi_new, qin_new = _remap_layers(seg_ti, seg_qi, ni)

    nsq = new_snow_q.expand(new_snow_t.shape)              # [ncat, N]
    seg_ts = torch.cat([new_snow_t[:, None, :], ts], 1)
    seg_qs = torch.cat([nsq[:, None, :], qsn], 1)
    hs_new, qsn_new = _remap_layers(seg_ts, seg_qs, ns)

    # ---- budgets -----------------------------------------------------------
    fresh = (c.rhoi * (meltt + meltb - congel) + c.rhos * melts) / dt
    fsalt = c.rhoi * (meltt + meltb - congel) * c.ice_ref_salinity * 1e-3 / dt
    eextra = (etop_left + ebot_left) / dt                 # W/m^2 to ocean

    return dict(hi=hi_new, hs=hs_new, qin=qin_new, qsn=qsn_new,
                meltt=meltt, meltb=meltb, melts=melts, congel=congel,
                snoice=snoice, fresh=fresh, fsalt=fsalt, eextra=eextra,
                evap=evap)
