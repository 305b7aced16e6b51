# Frozen copy of fesom2_tpu_torch/ice/icepack/driver.py, lines 1-451 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""Icepack ice-step orchestration (replaces step_icepack,
``src/icepack_drivers/icedrv_step.F90:1119-1309``).

The port of ``fesom2_tpu/ice/icepack/driver.py``: thermo1 (per-category
BL99 vertical) -> thermo2 (frazil, lateral melt, linear ITD remap) ->
strength -> EVP (strength-coupled, on the whole mesh) -> category-tracer
FCT advection -> ridging -> cleanup -> aggregate + ocean fluxes.  The
aggregate quantities and ocean fluxes are written into the ``IceState``
fields, so the rest of the coupled model (ocean2ice / oce_fluxes) is
untouched.

Two hand-written kernels carry the stages that are loops in the JAX
package: ``bl99_temperature_solve`` (thermo_vertical.temperature_solve,
every sweep of the BL99 iteration in one launch) and ``itd_remap``
(itd.itd_remap: the linear remap with the rebin after thermo2, the rebin
alone after ridging).  The rest is torch ops.  The spans
``step.icepack.thermo1``, ``.thermo2``, ``.dynamics``, ``.advection``,
``.ridging`` and ``.aggregate`` mark the stages for torch.profiler.
"""
from __future__ import annotations

import contextlib
from dataclasses import replace

import torch
from torch.profiler import record_function

from ..state import IceState, IceForcing, OceanSurface, inv_rhowat
from ..evp import ice_dynamics, ridging_rates
from ..fct import fct_advect_fields
from ..thermo import tfrez, obudget
from ..state import cc as cc_ocean          # rhowat * 4190 [J/m^3/K]
from . import constants as c
from .state import (IcepackConfig, IcepackState, temperature_ice,
                    temperature_snow, salinity_profile, melt_temps)
from .shortwave import ccsm3_shortwave
from .thermo_vertical import (temperature_solve, thickness_changes,
                              atmo_boundary_coeffs)
from .thermo_itd import add_new_ice, lateral_melt
from .itd import (aggregate, aggregate_tsfc, cleanup_itd, itd_remap,
                  unpack_itd)
from .ridge import ice_strength, ridge_ice

h_ml = 2.5          # mixed-layer depth for the freezing/melting potential
                    # (same as the FESIM thermodynamics, ice_thermo_oce.F90)


def _pack_tracers(ipk: IcepackState, ipc: IcepackConfig):
    """[F, N] advection work array (state_to_work,
    icedrv_advection.F90:719-767): per category aicen, vicen, vsnon,
    aicen*Tsfc, per-layer ice/snow energies, then (if enabled) the
    area-weighted and ice-volume-weighted aux tracers."""
    ncat, ni, ns = ipc.ncat, ipc.nilyr, ipc.nslyr
    ei = ipk.qin * (ipk.vicen / ni)[:, None, :]       # [ncat, ni, N]
    es = ipk.qsn * (ipk.vsnon / ns)[:, None, :]
    rows = [ipk.aicen, ipk.vicen, ipk.vsnon, ipk.aicen * ipk.Tsfcn]
    blocks = [torch.stack(rows, 1), ei, es]           # [ncat, 4+ni+ns, N]
    nrow = 4 + ni + ns
    if ipc.has_aux:
        blocks.append(ipk.ta * ipk.aicen[:, None, :])
        blocks.append(ipk.tv * ipk.vicen[:, None, :])
        nrow += len(ipc.area_tracers) + len(ipc.vol_tracers)
    stack = torch.cat(blocks, 1)
    return stack.reshape(ncat * nrow, -1)


def _unpack_tracers(work, ipc: IcepackConfig) -> IcepackState:
    ncat, ni, ns = ipc.ncat, ipc.nilyr, ipc.nslyr
    ka = len(ipc.area_tracers) if ipc.has_aux else 0
    kv = len(ipc.vol_tracers) if ipc.has_aux else 0
    w = work.reshape(ncat, 4 + ni + ns + ka + kv, -1)
    aicen = torch.clamp(w[:, 0], 0.0, 1.0)
    vicen = torch.clamp_min(w[:, 1], 0.0)
    vsnon = torch.clamp_min(w[:, 2], 0.0)
    has = (aicen > c.puny) & (vicen > c.puny)
    Tsfcn = torch.where(has, w[:, 3] / torch.clamp_min(aicen, c.puny), 0.0)
    Tsfcn = torch.clamp(Tsfcn, -100.0, 0.0)
    ei = w[:, 4:4 + ni]
    es = w[:, 4 + ni:4 + ni + ns]
    qin = torch.where(has[:, None, :],
                      torch.clamp_max(ei / torch.clamp_min(
                          (vicen / ni)[:, None, :], c.puny), 0.0), 0.0)
    qsn = torch.where((vsnon > c.puny)[:, None, :],
                      torch.clamp_max(es / torch.clamp_min(
                          (vsnon / ns)[:, None, :], c.puny), 0.0), 0.0)
    ta = tv = None
    if ipc.has_aux:
        wa = w[:, 4 + ni + ns:4 + ni + ns + ka]
        wv = w[:, 4 + ni + ns + ka:]
        # FCT keeps each weighted field bounded but the ratio of two
        # advected fields can over/undershoot by rounding: clamp to the
        # per-tracer physical range (fractions to [0,1], depths/age >= 0)
        inf = float("inf")
        frac_a = torch.tensor(
            [1.0 if (n in ("apnd", "FY", "alvl") or n.startswith("fsd"))
             else inf for n in ipc.area_tracers], dtype=w.dtype,
            device=w.device)[None, :, None]
        frac_v = torch.tensor(
            [1.0 if n in ("vlvl",) else inf for n in ipc.vol_tracers],
            dtype=w.dtype, device=w.device)[None, :, None]
        ta = torch.minimum(torch.clamp_min(torch.where(
            has[:, None, :],
            wa / torch.clamp_min(aicen[:, None, :], c.puny), 0.0), 0.0),
            frac_a)
        tv = torch.minimum(torch.clamp_min(torch.where(
            has[:, None, :],
            wv / torch.clamp_min(vicen[:, None, :], c.puny), 0.0), 0.0),
            frac_v)
    return IcepackState(aicen=aicen, vicen=vicen, vsnon=vsnon,
                        Tsfcn=Tsfcn, qin=qin, qsn=qsn, ta=ta, tv=tv)


_KERNELS = {"temperature_solve": temperature_solve, "itd_remap": itd_remap,
            "ice_dynamics": ice_dynamics}
_RECORD = None


def _call(name, *args, **kw):
    """The stage ``name`` (a key of ``_KERNELS``: the calls that launch a
    hand-written kernel); under ``recording_kernel_inputs`` its arguments
    are kept first."""
    if _RECORD is not None:
        _RECORD[name].append((args, kw))
    return _KERNELS[name](*args, **kw)


@contextlib.contextmanager
def recording_kernel_inputs():
    """Within the block, the step's calls of ``temperature_solve``,
    ``itd_remap`` and ``ice_dynamics`` keep their arguments in the dict it
    yields, {name: [(args, kwargs), ...]}: what a kernel is held against
    its plain version on."""
    global _RECORD
    _RECORD = {name: [] for name in _KERNELS}
    try:
        yield _RECORD
    finally:
        _RECORD = None


def _remap(cats, ipc, a_init, v_init, linear):
    """``itd_remap`` on the category tuple (aicen, vicen, vsnon, Tsfcn,
    qin, qsn, ta, tv): the tensors in as they are, the tuple (views of the
    new pack) out."""
    pack = _call("itd_remap", *cats, a_init, v_init, ipc.hin_max, linear)
    return unpack_itd(pack, ipc.nilyr, ipc.nslyr, cats[6].shape[1])


def icepack_timestep(ipk: IcepackState, ice: IceState, mesh,
                     forcing: IceForcing, ocean: OceanSurface, cfg,
                     ipc: IcepackConfig, use_virt_salt: bool,
                     ref_sss: float = 34.0, ref_sss_local: bool = False,
                     yday=None):
    """One coupled icepack step.  Returns (IcepackState, IceState) — the
    IceState carries aggregate fields, velocities and the ocean fluxes.

    yday: optional day-of-year (a number or a 0-d tensor) — enables the
    annual first-year-ice reset when tr_FY is on."""
    dt = cfg.dt * cfg.ice.ice_ave_steps
    ncat, ni = ipc.ncat, ipc.nilyr
    aux = ipc.has_aux
    N = ipk.aicen.shape[1]
    ta0 = ipk.ta if ipk.ta is not None \
        else ipk.aicen.new_zeros((ncat, 0, N))
    tv0 = ipk.tv if ipk.tv is not None \
        else ipk.aicen.new_zeros((ncat, 0, N))
    sal = salinity_profile(ni)
    Tmlt = melt_temps(ni)

    T_oc, S_oc = ocean.T_oc, ocean.S_oc
    Ta = forcing.Tair
    a0, v0, vs0 = ipk.aicen, ipk.vicen, ipk.vsnon

    # ---------------- thermo1: per-category vertical physics --------------
    with record_function("step.icepack.thermo1"):
        tf = tfrez(S_oc)
        ug = torch.sqrt(forcing.u_wind ** 2 + forcing.v_wind ** 2)
        rain = torch.where(Ta >= 0.0, forcing.prec_rain, 0.0)
        snowfall = torch.where(Ta >= 0.0, 0.0, forcing.prec_rain)
        vice_before = v0.sum(0)
        vsno_before = vs0.sum(0)

        has = a0 > c.puny
        hi = torch.where(has, v0 / torch.clamp_min(a0, c.puny), 0.0)
        hs = torch.where(has, vs0 / torch.clamp_min(a0, c.puny), 0.0)
        sal_t = torch.as_tensor(sal, device=hi.device).to(hi.dtype)
        Tin0 = temperature_ice(ipk.qin, sal_t[None, :, None])
        Tsn0 = temperature_snow(ipk.qsn)
        Tin0 = torch.where(has[:, None, :], Tin0, -2.0)
        Tsn0 = torch.where(has[:, None, :], Tsn0, -2.0)
        Tsf0 = torch.where(has, torch.clamp_max(ipk.Tsfcn, 0.0),
                           torch.clamp_max(Ta, -0.1))

        if getattr(ipc, "shortwave", "ccsm3") == "dEdd":
            # delta-Eddington multiple scattering (dedd.py); the ponded
            # sub-column is part of the radiative solution
            from .dedd import dedd_shortwave
            if ipc.tr_pond_cesm:
                ia, ih = ipc.ta_index("apnd"), ipc.ta_index("hpnd")
                apnd, hpnd = ta0[:, ia], ta0[:, ih]
            else:
                apnd = hpnd = None
            albedo, fswsfc, iabs, fswthru = dedd_shortwave(
                ipc, hi, hs, Tsf0, forcing.shortwave, apnd, hpnd)
        else:
            albedo, fswsfc, iabs, fswthru = ccsm3_shortwave(
                ipc, hi, hs, Tsf0, forcing.shortwave)
            if ipc.tr_pond_cesm:
                # pond-darkened surface albedo (the role dEdd plays for
                # ponds)
                from .ponds import pond_albedo_adjust
                ia, ih = ipc.ta_index("apnd"), ipc.ta_index("hpnd")
                albedo, fswsfc = pond_albedo_adjust(
                    ipc, albedo, fswsfc, ta0[:, ia], ta0[:, ih], hs,
                    forcing.shortwave)

        # stability-iterated transfer coefficients from the pre-solve
        # surface state (Icepack atmo_boundary_layer; held fixed through
        # the solve)
        if getattr(ipc, "atmbndy", "similarity") == "similarity":
            shc, lhc = atmo_boundary_coeffs(Tsf0, Ta, forcing.shum, ug)
        else:
            shc = lhc = None
        sol = _call("temperature_solve", ipc, hi, hs, Tsf0, Tsn0, Tin0,
                    fswsfc.contiguous(), iabs.contiguous(), forcing.longwave,
                    Ta, forcing.shum, ug, tf, dt, sal, Tmlt, shcoef=shc,
                    lhcoef=lhc)

        # ocean -> ice-bottom heat flux (per unit ice area)
        ustar = torch.clamp_min(torch.sqrt(
            ((ice.u_ice - ocean.u_w) ** 2 + (ice.v_ice - ocean.v_w) ** 2)
            * cfg.ice.Cd_oce_ice), ipc.ustar_min)
        fbot = 0.006 * ustar * cc_ocean * (T_oc - tf)     # [W/m^2] +melts

        tc = thickness_changes(ipc, hi, hs,
                               torch.where(has[:, None, :], ipk.qin, 0.0),
                               torch.where(has[:, None, :], ipk.qsn, 0.0),
                               sol["Tsf"], sol, fbot, tf, snowfall, Ta, dt,
                               sal)

        # masked per-category updates
        aicen = a0
        vicen = torch.where(has, tc["hi"] * a0, v0)
        vsnon = torch.where(has, tc["hs"] * a0, vs0)
        Tsfcn = torch.where(has, sol["Tsf"], ipk.Tsfcn)
        qin = torch.where(has[:, None, :], tc["qin"], ipk.qin)
        qsn = torch.where(has[:, None, :], tc["qsn"], ipk.qsn)

        # aux tracer point processes: pond evolution, aging, FY reset
        if aux:
            from . import ponds
            if ipc.tr_pond_cesm:
                apnd, hpnd = ponds.compute_ponds_cesm(
                    ipc, aicen, vicen, Tsfcn,
                    torch.where(has, tc["meltt"], 0.0),
                    torch.where(has, tc["melts"], 0.0),
                    ta0[:, ia], ta0[:, ih])
                ta0 = ta0.clone()
                ta0[:, ia], ta0[:, ih] = apnd, hpnd
            if ipc.tr_iage:
                iv = ipc.tv_index("iage")
                tv0 = tv0.clone()
                tv0[:, iv] = ponds.advance_age(tv0[:, iv], aicen, dt)
            if ipc.tr_FY and yday is not None:
                jf = ipc.ta_index("FY")
                ta0 = ta0.clone()
                ta0[:, jf] = ponds.reset_first_year(
                    ta0[:, jf], mesh.geo_coords[:, 1], yday)
            if ipc.tr_bgc:
                # skeletal-layer ecosystem (bgc.py): driven by the
                # transmitted shortwave and the net ice growth/melt rate
                from . import bgc as bgc_mod
                s0 = ipc.bgc_slice.start
                dhi_dt = torch.where(has, (tc["hi"] - hi) / dt, 0.0)
                algN, NO3, Sil, _, _, _ = bgc_mod.skl_bgc_step(
                    ipc, ta0[:, s0], ta0[:, s0 + 1], ta0[:, s0 + 2], aicen,
                    vicen, fswthru, dhi_dt, tf, dt)
                ta0 = ta0.clone()
                ta0[:, s0], ta0[:, s0 + 1], ta0[:, s0 + 2] = algN, NO3, Sil

        aw = torch.where(has, a0, 0.0)                    # weights
        fresh_kg = (aw * tc["fresh"]).sum(0)              # kg/m^2/s
        fsalt_kg = (aw * tc["fsalt"]).sum(0)
        fhocn = (aw * (tc["eextra"] - fbot[None, :])).sum(0)  # W/m^2
        fswthru_g = (aw * fswthru).sum(0)
        evap_sub = (aw * tc["evap"]).sum(0)               # kg/m^2/s to atm

    # ---------------- thermo2: frazil + lateral melt + ITD remap ----------
    with record_function("step.icepack.thermo2"):
        aice_mid = aicen.sum(0)
        pot = (tf - T_oc) * cc_ocean * h_ml / dt          # [W/m^2] +freezing
        frzmlt = torch.clamp_min(pot, 0.0)
        a_pre, v_pre = aicen, vicen
        (aicen, vicen, vsnon, Tsfcn, qin, qsn, dvfraz,
         fhocn_fraz) = add_new_ice(ipc, aicen, vicen, vsnon, Tsfcn, qin,
                                   qsn, frzmlt, tf, dt)
        if aux:
            from . import ponds
            ta0, tv0 = ponds.dilute_on_new_ice(ipc, ta0, tv0, a_pre, aicen,
                                               v_pre, vicen)
        fresh_kg = fresh_kg - c.rhoi * dvfraz
        fsalt_kg = fsalt_kg - c.rhoi * dvfraz * c.ice_ref_salinity * 1e-3
        fhocn = fhocn + fhocn_fraz

        # FSD column processes (fsd.py): radial growth on the frazil rate,
        # welding in freezing conditions, and the lateral-melt feedback
        rside_scale = None
        if aux and ipc.tr_fsd:
            from . import fsd as fsd_mod
            sl = ipc.fsd_slice
            afsd = ta0[:, sl]
            dr_g = fsd_mod.fsd_radial_growth_rate(
                ipc, afsd, aicen, vicen, dvfraz, dt, ipc.fsd_lims)
            afsd = fsd_mod.fsd_radial_evolve(afsd, dr_g, ipc.fsd_lims)
            afsd = fsd_mod.fsd_weld(afsd, aicen, frzmlt > 0.0, dt,
                                    ipc.kweld, ipc.fsd_lims)
            # lateral melt shrinks floes radially at the Maykut & Perovich
            # rate
            wlat = c.m1_lat * torch.clamp_min(T_oc - tf, 0.0) ** c.m2_lat
            afsd = fsd_mod.fsd_radial_evolve(
                afsd, -(wlat * dt)[None, :] * torch.ones_like(aicen),
                ipc.fsd_lims)
            afsd = fsd_mod.afsd_normalize(afsd, aicen)
            ta0 = ta0.clone()
            ta0[:, sl] = afsd
            rside_scale = fsd_mod.fsd_lateral_melt_scale(afsd, ipc.fsd_lims)

        melt_pot = torch.clamp_min(-pot, 0.0) * aice_mid  # lateral, w/ ice
        (aicen, vicen, vsnon, Tsfcn, qin, qsn, dfr, dfs,
         dfh) = lateral_melt(ipc, aicen, vicen, vsnon, Tsfcn, qin, qsn,
                             T_oc, tf, melt_pot, dt, rside_scale=rside_scale)
        fresh_kg = fresh_kg + dfr
        fsalt_kg = fsalt_kg + dfs
        fhocn = fhocn + dfh

        # the linear remap (kitd=1) and the rebin: one itd_remap
        (aicen, vicen, vsnon, Tsfcn, qin, qsn, ta0, tv0) = _remap(
            (aicen, vicen, vsnon, Tsfcn, qin, qsn, ta0, tv0), ipc, a0, v0,
            ipc.kitd == 1)
        (aicen, vicen, vsnon, Tsfcn, qin, qsn, ta0, tv0, dfr, dfs,
         dfh) = cleanup_itd(aicen, vicen, vsnon, Tsfcn, qin, qsn, dt,
                            ta=ta0, tv=tv0)
        fresh_kg = fresh_kg + dfr
        fsalt_kg = fsalt_kg + dfs
        fhocn = fhocn + dfh

    # ---------------- dynamics: strength-coupled EVP ----------------------
    with record_function("step.icepack.dynamics"):
        strength = ice_strength(ipc, aicen, vicen)
        aice_d, vice_d, vsno_d = aggregate(aicen, vicen, vsnon)
        ice = replace(ice, a_ice=aice_d, m_ice=vice_d, m_snow=vsno_d)
        ice = _call("ice_dynamics", ice, mesh, forcing, ocean, cfg,
                    strength_node=strength)
        rdg_conv, rdg_shear = ridging_rates(ice, mesh, cfg)

    # ---------------- advection of category tracers -----------------------
    with record_function("step.icepack.advection"):
        ipk2 = IcepackState(aicen=aicen, vicen=vicen, vsnon=vsnon,
                            Tsfcn=Tsfcn, qin=qin, qsn=qsn,
                            ta=ta0 if aux else None, tv=tv0 if aux else None)
        work = _pack_tracers(ipk2, ipc)
        work = fct_advect_fields(ice.u_ice, ice.v_ice, work, mesh,
                                 cfg.ice.ice_gamma_fct, dt)
        ipk2 = _unpack_tracers(work, ipc)
        aicen, vicen, vsnon = ipk2.aicen, ipk2.vicen, ipk2.vsnon
        Tsfcn, qin, qsn = ipk2.Tsfcn, ipk2.qin, ipk2.qsn
        if aux:
            # the ratio of two separately-FCT-advected fields can leave
            # the donor range when the denominator is near puny: bound by
            # the pre-advection global extremes per tracer
            ta0 = torch.minimum(ipk2.ta, ta0.amax(dim=(0, 2))[None, :, None])
            tv0 = torch.minimum(ipk2.tv, tv0.amax(dim=(0, 2))[None, :, None])

    # ---------------- ridging ---------------------------------------------
    with record_function("step.icepack.ridging"):
        (aicen, vicen, vsnon, Tsfcn, qin, qsn, ta0, tv0, dfr,
         dfh) = ridge_ice(ipc, aicen, vicen, vsnon, Tsfcn, qin, qsn,
                          rdg_conv, rdg_shear, dt, ipc.hin_max, ta=ta0,
                          tv=tv0)
        fresh_kg = fresh_kg + dfr
        fhocn = fhocn + dfh

        (aicen, vicen, vsnon, Tsfcn, qin, qsn, ta0, tv0) = _remap(
            (aicen, vicen, vsnon, Tsfcn, qin, qsn, ta0, tv0), ipc, None,
            None, False)
        (aicen, vicen, vsnon, Tsfcn, qin, qsn, ta0, tv0, dfr, dfs,
         dfh) = cleanup_itd(aicen, vicen, vsnon, Tsfcn, qin, qsn, dt,
                            ta=ta0, tv=tv0)
        fresh_kg = fresh_kg + dfr
        fsalt_kg = fsalt_kg + dfs
        fhocn = fhocn + dfh

        if aux and ipc.tr_fsd:
            # advection/remap/ridging mix the bins conservatively but the
            # normalization (sum_k afsd = 1 per category) is not their
            # invariant: restore it
            from . import fsd as fsd_mod
            sl = ipc.fsd_slice
            ta0 = ta0.clone()
            ta0[:, sl] = fsd_mod.afsd_normalize(ta0[:, sl], aicen)

    # ---------------- aggregate + ocean fluxes ----------------------------
    with record_function("step.icepack.aggregate"):
        aice, vice, vsno = aggregate(aicen, vicen, vsnon)
        tskin = aggregate_tsfc(aicen, Tsfcn)

        # open-water atmospheric budget (same bulk as the FESIM scheme)
        fh_ow, evap_ow, hflatow, hfsenow, hflwrdout = obudget(
            forcing.shum, forcing.shortwave, forcing.longwave, T_oc, ug, Ta,
            forcing.Ch_atm_oce, forcing.Ce_atm_oce, cfg.ice.emiss_wat,
            cfg.ice.albw)
        ow = 1.0 - aice
        hftot_ow = (1.0 - cfg.ice.albw) * forcing.shortwave \
            + forcing.longwave + hflwrdout + hfsenow + hflatow

        # total heat into the ocean [W/m^2]
        ehf = ow * hftot_ow + fhocn + fswthru_g

        # freshwater [m/s] and salt [psu m/s] in the FESIM conventions
        prec = rain + forcing.runoff + snowfall * ow
        evap = evap_ow * ow
        if use_virt_salt:
            # linfs: virtual-salt formulation — the ice-melt water is
            # scaled by (S_ref - S_ice)/S_ref and no real salt flux is
            # applied (mirrors ice_thermo_oce.F90:406-415)
            rsss = S_oc if ref_sss_local else ref_sss
            fw = prec + evap + fresh_kg * inv_rhowat \
                * (rsss - c.ice_ref_salinity) \
                / (torch.clamp_min(rsss, 1.0) if ref_sss_local
                   else max(rsss, 1.0))
            rsf = torch.zeros_like(T_oc)
        else:
            fw = prec + evap + fresh_kg * inv_rhowat
            rsf = fsalt_kg * 1000.0 * inv_rhowat           # [psu m/s]

        thdgr = (vice - vice_before) / dt                  # [m ice / s]
        thdgrsn = (vsno - vsno_before) / dt
        # sublimation leaves to the atmosphere (counted like FESIM's subli)
        evap_total = evap - evap_sub / 1000.0

        ice = replace(ice, a_ice=aice, m_ice=vice, m_snow=vsno, t_skin=tskin,
                      fresh_wa_flux=fw, net_heat_flux=ehf,
                      real_salt_flux=rsf, evaporation=evap_total,
                      thdgr=thdgr, thdgrsn=thdgrsn,
                      flice=(aw * tc["snoice"]).sum(0) / dt,
                      a_ice_old=a0.sum(0))
        ipk_out = IcepackState(aicen=aicen, vicen=vicen, vsnon=vsnon,
                               Tsfcn=Tsfcn, qin=qin, qsn=qsn,
                               ta=ta0 if aux else None,
                               tv=tv0 if aux else None)
    return ipk_out, ice
