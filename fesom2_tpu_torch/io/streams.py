"""Declarative mean-output streams (the def_stream registry).

The port of ``fesom2_tpu/io/streams.py`` (ref ``src/io_meandata.F90``:
the registry def_stream{2D,3D} :938-1003, the accumulation update_means
:768, event-driven flushes with background-thread NetCDF writes, output
:798-922).  The same stream ids, the same gates and the same extracts;
``make_stream`` resolves a reference id to a ``StreamDef`` or to None.

On the card the running sums are tensors allocated at the first update
and updated in place (``add_``), never aliasing a state tensor; an
update launches the extracts and the sums, no host wait.  A flush copies
a stream's sums into the stream's pinned host buffer (allocated at its
first flush, reused after) without a wait, records an event and zeroes
the sums; one writer thread takes the flushes in order, waits for each
copy's event, divides by the count as the JAX package does (in numpy),
hands the buffer back and rewrites the stream's NetCDF3 file with all its
records.  A flush waits only where the writer has not yet taken the
stream's previous copy.  The
density-MOC streams share one bundle: ``diag_dens_moc`` runs once per
update, whatever the number of ``std_dens_*`` streams (XLA deduplicates
those calls in the JAX package; eager code would repeat them).
"""
from __future__ import annotations

import os
import queue
import re
import threading
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from .netcdf import write_dataset
from ..utils.clock import Clock, event_triggered


class AtmHolder:
    """Mutable indirection for the atm-backed extracts: the run loop
    swaps ``.current`` at a forcing-year rollover, so that the streams
    read the active year's series."""

    def __init__(self, atm):
        self.current = atm


@dataclass
class StreamDef:
    name: str
    extract: Callable            # (state, ice[, extra][, forcing]) -> tensor
    freq: int = 1
    unit: str = "d"              # y/m/d/h/s
    precision: str = "f8"        # f4 or f8
    comment: str = ""
    wants_extra: bool = False    # extract takes a third arg (e.g. icepack)
    wants_forcing: bool = False  # extract takes (state, ice, forcing)
    atm_holder: Optional[AtmHolder] = None   # set for atm-backed streams
    # a stream that takes one entry of a bundle several streams share:
    # (bundle name, fn(state, ice, forcing) -> dict, key, fallback key);
    # OutputStreams evaluates each bundle once an update
    bundle: Optional[tuple] = None


class OutputStreams:
    """Accumulates each stream's running sum on the device; flushes on a
    writer thread (``async_write``) or in the caller."""

    def __init__(self, defs: List[StreamDef], result_path: str,
                 runid: str = "fesom", async_write: bool = True):
        self.defs = defs
        self.result_path = result_path
        self.runid = runid
        self.async_write = async_write
        self._acc = None             # running sums, one tensor a stream
        self._counts = [0] * len(defs)
        # each stream's pinned host buffer and the event the writer sets
        # once it has taken the buffer's copy
        self._host = [None] * len(defs)
        self._free = [None] * len(defs)
        # each stream's records and times so far (the writer's)
        self._records = {d.name: ([], []) for d in defs}
        self._queue = None
        self._worker = None
        self._error = None
        os.makedirs(result_path, exist_ok=True)

    def set_atm(self, atm):
        """Swap the forcing-year series the atm-backed streams read."""
        for d in self.defs:
            if d.atm_holder is not None:
                d.atm_holder.current = atm

    # -- accumulate (device side) -----------------------------------------
    def _extract_all(self, state, ice, extra, forcing):
        bundles, out = {}, []
        for d in self.defs:
            if d.bundle is not None:
                name, fn, key, fallback = d.bundle
                if name not in bundles:
                    bundles[name] = fn(state, ice, forcing)
                b = bundles[name]
                out.append(b.get(key, b[fallback]))
            elif d.wants_forcing:
                out.append(d.extract(state, ice, forcing))
            elif d.wants_extra:
                out.append(d.extract(state, ice, extra))
            else:
                out.append(d.extract(state, ice))
        return out

    @torch.no_grad()
    def update_means(self, state, ice=None, extra=None, forcing=None):
        vals = self._extract_all(state, ice, extra, forcing)
        if self._acc is None:
            self._acc = [torch.zeros_like(v) for v in vals]
        for a, v in zip(self._acc, vals):
            a.add_(v)
        self._counts = [c + 1 for c in self._counts]

    # -- event-driven flush ------------------------------------------------
    def maybe_flush(self, clock_before: Clock, clock_after: Clock,
                    step: int):
        for i, d in enumerate(self.defs):
            if event_triggered(d.unit, d.freq, clock_before, clock_after,
                               step):
                self._flush_stream(i, clock_after)

    def _flush_stream(self, i: int, clock: Clock):
        d = self.defs[i]
        if self._acc is None or self._counts[i] == 0:
            return
        acc = self._acc[i]
        done = release = None
        if acc.device.type == "cuda":
            if self._host[i] is None:
                self._host[i] = torch.empty(acc.shape, dtype=acc.dtype,
                                            pin_memory=True)
                self._free[i] = threading.Event()
                self._free[i].set()
            release = self._free[i]
            release.wait()
            release.clear()
            host = self._host[i]
            host.copy_(acc, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(acc.device))
        else:
            host = acc.clone()
        acc.zero_()
        job = (d, host, done, release, self._counts[i],
               clock.seconds_in_year,
               os.path.join(self.result_path, f"{d.name.strip()}."
                            f"{self.runid}.{clock.yearnew}.nc"))
        self._counts[i] = 0
        if not self.async_write:
            self._write(job)
            return
        if self._worker is None:
            self._queue = queue.Queue()
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()
        self._queue.put(job)

    def _drain(self):
        while True:
            job = self._queue.get()
            if job is None:
                return
            try:
                if self._error is None:
                    self._write(job)
            except Exception as exc:     # raised again by finalize()
                self._error = exc
            finally:
                if job[3] is not None:
                    job[3].set()

    def _write(self, job):
        d, host, done, release, count, t, path = job
        if done is not None:
            done.synchronize()
        mean = host.numpy() / count
        if release is not None:
            release.set()
        if d.precision == "f4":
            mean = mean.astype(np.float32)
        records, times = self._records[d.name]
        records.append(mean)
        times.append(t)
        arr = np.stack(records)
        dims = {"time": arr.shape[0]}
        dnames = ["time"]
        for k, s in enumerate(arr.shape[1:]):
            dims[f"d{k}"] = s
            dnames.append(f"d{k}")
        write_dataset(path, dims, {
            d.name.strip(): (tuple(dnames), arr),
            "time": (("time",), np.asarray(times)),
        }, attrs={"comment": d.comment})

    def finalize(self):
        """Wait for the writer; raise what it raised."""
        if self._worker is not None:
            self._queue.put(None)
            self._worker.join()
            self._worker = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def default_ocean_streams(mesh, fill_T=None, fill_S=None) -> List[StreamDef]:
    """The core subset of the reference's registered fields
    (``io_meandata.F90:94-537``).  fill_T/fill_S [nl-1, N]: the values
    written at dry cells (the reference's output carries the initial
    climatology there; the state keeps them at 0)."""
    def tr_out(k, fill):
        if fill is None:
            return lambda s, i: s.tr[k]
        mask = mesh.node_layer_mask
        return lambda s, i, _fill=fill, _k=k: torch.where(mask, s.tr[_k],
                                                          _fill)

    return [
        StreamDef("sst", lambda s, i: s.tr[0, 0],
                  comment="sea surface temperature"),
        StreamDef("sss", lambda s, i: s.tr[1, 0],
                  comment="sea surface salinity"),
        StreamDef("ssh", lambda s, i: s.eta, comment="sea surface height"),
        StreamDef("temp", tr_out(0, fill_T), comment="potential temperature"),
        StreamDef("salt", tr_out(1, fill_S), comment="salinity"),
        StreamDef("u", lambda s, i: s.u, comment="zonal velocity (elements)"),
        StreamDef("v", lambda s, i: s.v,
                  comment="meridional velocity (elements)"),
        StreamDef("w", lambda s, i: s.w, comment="vertical velocity"),
        StreamDef("MLD2", lambda s, i: s.mld2,
                  comment="mixed layer depth (Levitus)"),
    ]


def default_ice_streams() -> List[StreamDef]:
    return [
        StreamDef("a_ice", lambda s, i: i.a_ice, comment="ice concentration"),
        StreamDef("m_ice", lambda s, i: i.m_ice, comment="ice thickness"),
        StreamDef("m_snow", lambda s, i: i.m_snow, comment="snow thickness"),
        StreamDef("uice", lambda s, i: i.u_ice, comment="ice velocity x"),
        StreamDef("vice", lambda s, i: i.v_ice, comment="ice velocity y"),
    ]


def default_icepack_streams(ipc=None) -> List[StreamDef]:
    """The category fields of the Icepack path (&nml_list_icepack,
    config/namelist.icepack:110-113); where the IcepackConfig carries aux
    tracers, their area- or volume-weighted means and, with the floe-size
    distribution, the mean floe radius ``fsdrad``."""
    defs = [
        StreamDef("aicen", lambda s, i, p: p.aicen, wants_extra=True,
                  comment="category ice concentration"),
        StreamDef("vicen", lambda s, i, p: p.vicen, wants_extra=True,
                  comment="category ice volume per area"),
        StreamDef("vsnon", lambda s, i, p: p.vsnon, wants_extra=True,
                  comment="category snow volume per area"),
        StreamDef("Tsfcn", lambda s, i, p: p.Tsfcn, wants_extra=True,
                  comment="category surface temperature"),
    ]
    if ipc is None or not getattr(ipc, "has_aux", False):
        return defs

    def area_mean(idx):
        def f(s, i, p, _k=idx):
            a = p.aicen.sum(0)
            return torch.where(a > 1e-11, (p.aicen * p.ta[:, _k]).sum(0)
                               / torch.clamp_min(a, 1e-11), 0.0)
        return f

    def vol_mean(idx):
        def f(s, i, p, _k=idx):
            v = p.vicen.sum(0)
            return torch.where(v > 1e-11, (p.vicen * p.tv[:, _k]).sum(0)
                               / torch.clamp_min(v, 1e-11), 0.0)
        return f

    comments = {"apnd": "melt pond area fraction (of ice)",
                "hpnd": "melt pond depth",
                "FY": "first-year ice area fraction",
                "alvl": "level ice area fraction",
                "vlvl": "level ice volume fraction",
                "iage": "ice age [s]",
                "bgc_N": "skeletal-layer ice algae [mmol N/m^3]",
                "bgc_NO3": "skeletal-layer nitrate [mmol/m^3]",
                "bgc_Sil": "skeletal-layer silicate [mmol/m^3]"}
    for k, name in enumerate(ipc.area_tracers):
        if name.startswith("fsd"):
            continue          # per-bin fractions: summarized by fsdrad
        defs.append(StreamDef(name, area_mean(k), wants_extra=True,
                              comment=comments[name]))
    for k, name in enumerate(ipc.vol_tracers):
        defs.append(StreamDef(name, vol_mean(k), wants_extra=True,
                              comment=comments[name]))
    if getattr(ipc, "tr_fsd", False):
        from ..ice.icepack import fsd as fsd_mod

        def fsdrad(s, i, p):
            return fsd_mod.fsd_mean_radius(p.ta[:, ipc.fsd_slice], p.aicen,
                                           ipc.fsd_lims)

        defs.append(StreamDef("fsdrad", fsdrad, wants_extra=True,
                              comment="area-weighted mean floe radius [m]"))
    return defs


# --------------------------------------------------------------------------
# the namelist-driven registry (ref io_meandata.F90 ini_mean_io :94-537)
# --------------------------------------------------------------------------
def parse_namelist_io(path: str):
    """The &nml_list block of a reference ``namelist.io``: its
    quadruples 'id', freq, 'unit', precision (4 -> f4, 8 -> f8), up to the
    first 'unknown' id (io_meandata.F90:130-136), as a list of
    (id, freq, unit, precision)."""
    txt = open(path).read()
    m = re.search(r"^\s*&nml_list\b(.*?)\n\s*/", txt, re.S | re.M)
    if not m:
        return []
    out = []
    for sid, freq, unit, prec in re.findall(
            r"'([^']+)'\s*,\s*(\d+)\s*,\s*'([^']+)'\s*,\s*(\d+)", m.group(1)):
        sid = sid.strip()
        if sid == "unknown":
            break
        out.append((sid, int(freq), unit.strip(),
                    "f4" if int(prec) == 4 else "f8"))
    return out


def _bottom(x, mesh):
    """x [nl-1, E] on each element's bottom layer [E]."""
    from ..core.ops import take_row
    return take_row(x, torch.clamp_min(mesh.nlevels_elem.long() - 2, 0))


def _dens_flux(s, f):
    """The surface density flux alpha fh / cp - beta sss fw rho0 [N]."""
    from ..constants import density_0
    from ..core import eos
    a, b = eos.sw_alpha_beta(s.tr[0, 0], s.tr[1, 0], s.Z_3d[0])
    return -a * f.heat_flux / 3996.0 \
        - b * s.tr[1, 0] * f.water_flux * density_0


def make_stream(sid: str, mesh, cfg, freq: int = 1, unit: str = "d",
                precision: str = "f8", atm=None, fill_T=None, fill_S=None):
    """One reference stream id as a StreamDef, or None where the
    configuration does not carry the field (the reference's conditional
    registration: use_ice, Fer_GM, the ldiag_* flags and the mixing
    scheme gate it).  Streams whose source has no counterpart in the
    carried state are recomputed from the state (alpha and beta, the
    slopes, the stress curl), as in ``fesom2_tpu/io/streams.py:302-804``."""
    k = dict(freq=freq, unit=unit, precision=precision)
    use_ice = cfg.run.use_ice
    dt = cfg.dt
    nmask = mesh.node_layer_mask
    hold = atm if isinstance(atm, AtmHolder) else None
    current = lambda: atm.current if isinstance(atm, AtmHolder) else atm
    spy = max(int(round(365 * 86400.0 / dt)), 1)

    def tr_stream(idx, fill):
        if fill is None:
            return lambda s, i, _k=idx: s.tr[_k]
        return lambda s, i, _k=idx, _f=fill: torch.where(nmask, s.tr[_k], _f)

    def atm_time(s):
        # the forcing time axis is year-relative: the step's own model
        # time, the means accumulating after the step
        return ((s.step - 1) % spy) * dt

    def atm_stream(series_name, taxis_name):
        from ..forcing.atmos import _time_interp

        def f(s, i):
            a = current()
            return _time_interp(getattr(a, series_name),
                                getattr(a, taxis_name), atm_time(s))
        return f

    # ---- 2D from state ---------------------------------------------------
    state_2d = {"sst": (lambda s, i: s.tr[0, 0], "sea surface temperature"),
                "sss": (lambda s, i: s.tr[1, 0], "sea surface salinity"),
                "ssh": (lambda s, i: s.eta, "sea surface elevation"),
                "vve_5": (lambda s, i: s.w[4],
                          "vertical velocity at 5th level"),
                "ssh_rhs_old": (lambda s, i: s.ssh_rhs_old, "ssh rhs (old)"),
                "MLD1": (lambda s, i: s.mld1, "Mixed Layer Depth (buoyancy)"),
                "MLD2": (lambda s, i: s.mld2, "Mixed Layer Depth (Levitus)")}
    if sid in state_2d:
        fn, cm = state_2d[sid]
        return StreamDef(sid, fn, comment=cm, **k)

    # ---- sea ice ---------------------------------------------------------
    ice_map = {"uice": ("u_ice", "ice velocity x"),
               "vice": ("v_ice", "ice velocity y"),
               "a_ice": ("a_ice", "ice concentration"),
               "m_ice": ("m_ice", "ice height"),
               "m_snow": ("m_snow", "snow height"),
               "thdgr": ("thdgr", "thermodynamic growth rate ice"),
               "thdgrsn": ("thdgrsn", "thermodynamic growth rate snow"),
               "flice": ("flice", "flooding growth rate ice"),
               "evap": ("evaporation", "evaporation"),
               "ist": ("t_skin", "ice surface temperature")}
    if sid in ice_map:
        if not use_ice:
            return None
        attr, cm = ice_map[sid]
        return StreamDef(sid, lambda s, i, _a=attr: getattr(i, _a),
                         comment=cm, **k)

    # ---- surface forcing (from the step's ocean Forcing) ----------------
    forc_map = {"fh": ("heat_flux", "heat flux"),
                "fw": ("water_flux", "water flux"),
                "atmoce_x": ("stress_atm_x", "stress atmosphere->ocean x"),
                "atmoce_y": ("stress_atm_y", "stress atmosphere->ocean y"),
                "tx_sur": ("stress_x", "zonal wind stress to ocean"),
                "ty_sur": ("stress_y", "meridional wind stress to ocean"),
                "virtual_salt": ("virtual_salt", "virtual salt flux"),
                "real_salt_flux": ("real_salt_flux", "real salt flux")}
    if sid in forc_map:
        attr, cm = forc_map[sid]
        return StreamDef(sid, lambda s, i, f, _a=attr: getattr(f, _a),
                         comment=cm, wants_forcing=True, **k)
    if sid == "curl_surf":
        from ..core.diagnostics import curl_stress_surf
        return StreamDef("curl_surf",
                         lambda s, i, f: curl_stress_surf(f, mesh),
                         comment="curl of the surface stress",
                         wants_forcing=True, **k)
    if sid in ("dens_flux", "dflux"):
        return StreamDef(sid, lambda s, i, f: _dens_flux(s, f),
                         comment="surface density flux",
                         wants_forcing=True, **k)

    # ---- atmospheric state (preloaded series, interpolated at step time)
    atm_map = {"tair": ("tair", "t_wind", "air temperature"),
               "shum": ("shum", "t_wind", "specific humidity"),
               "uwind": ("u_wind", "t_wind", "zonal wind"),
               "vwind": ("v_wind", "t_wind", "meridional wind"),
               "swr": ("swdn", "t_rad", "shortwave radiation"),
               "lwr": ("lwdn", "t_rad", "longwave radiation"),
               "prec": ("prec", "t_prec", "precipitation rain"),
               "snow": ("snow", "t_prec", "precipitation snow")}
    if sid in atm_map:
        if atm is None:
            return None
        attr, tax, cm = atm_map[sid]
        return StreamDef(sid, atm_stream(attr, tax), comment=cm,
                         atm_holder=hold, **k)
    if sid == "runoff":
        if atm is None:
            return None
        return StreamDef("runoff", lambda s, i: current().runoff,
                         comment="runoff", atm_holder=hold, **k)

    # ---- 3D prognostics + mixing ----------------------------------------
    if sid == "temp":
        return StreamDef("temp", tr_stream(0, fill_T),
                         comment="temperature", **k)
    if sid == "salt":
        return StreamDef("salt", tr_stream(1, fill_S),
                         comment="salinity", **k)
    if sid == "otracers":
        if cfg.tra.num_tracers <= 2:
            return None
        return StreamDef("otracers", lambda s, i: s.tr[2:],
                         comment="other tracers", **k)
    state_map = {"u": ("u", "zonal velocity (elements)"),
                 "v": ("v", "meridional velocity (elements)"),
                 "w": ("w", "vertical velocity"),
                 "Kv": ("Kv", "vertical diffusivity Kv"),
                 "Av": ("Av", "vertical viscosity Av (elements)"),
                 "N2": ("bvfreq", "brunt-vaisala frequency squared"),
                 "pgf_x": ("pgf_x", "zonal pressure gradient force"),
                 "pgf_y": ("pgf_y", "meridional pressure gradient force"),
                 "unod": ("unode", "zonal velocity at nodes"),
                 "vnod": ("vnode", "meridional velocity at nodes")}
    if sid in state_map:
        attr, cm = state_map[sid]
        return StreamDef(sid, lambda s, i, _a=attr: getattr(s, _a),
                         comment=cm, **k)

    # ---- EoS coefficients + neutral slopes (recomputed from state) ------
    if sid in ("alpha", "beta"):
        from ..core import eos
        which = 0 if sid == "alpha" else 1
        cm = ("thermal expansion coefficient" if sid == "alpha"
              else "haline contraction coefficient")
        return StreamDef(sid, lambda s, i, _w=which: eos.sw_alpha_beta(
            s.tr[0], s.tr[1], s.Z_3d)[_w], comment=cm, **k)
    if sid in ("slope_x", "slope_y", "slope_z"):
        from ..core import gm_redi
        comp = {"slope_x": 0, "slope_y": 1, "slope_z": 2}[sid]

        def slope(s, i, _c=comp):
            sig = gm_redi.compute_sigma_xy(s, mesh)
            ns, _ = gm_redi.compute_neutral_slope(sig, s.bvfreq, mesh)
            return ns[_c]
        return StreamDef(sid, slope, comment="neutral slope " + sid[-1], **k)

    # ---- GM / Redi (carried in state when Fer_GM, with_gm alloc) --------
    gm_map = {"bolus_u": ("fer_u", "GM bolus velocity x"),
              "bolus_v": ("fer_v", "GM bolus velocity y"),
              "bolus_w": ("fer_w", "GM bolus velocity z"),
              "fer_K": ("fer_K3", "GM diffusivity"),
              "fer_C": ("fer_c", "GM wave speed c^2")}
    if sid in gm_map:
        if not cfg.dyn.Fer_GM:
            return None
        attr, cm = gm_map[sid]
        return StreamDef(sid, lambda s, i, _a=attr: getattr(s, _a),
                         comment=cm, **k)
    if sid == "fer_scal":
        if not cfg.dyn.Fer_GM:
            return None
        # the resolution scaling is static per mesh (oce_fer_gm.F90:193-226)
        d = cfg.dyn
        reso = mesh.resolution.detach().cpu().numpy()
        scal = (reso / 100000.0) ** 2 if d.scaling_resolution \
            else np.ones_like(reso)
        ramp = np.maximum((reso / 1000.0 - d.K_GM_rampmin)
                          / (d.K_GM_rampmax - d.K_GM_rampmin), 0.0)
        scal = np.where(reso / 1000.0 < d.K_GM_rampmax, scal * ramp, scal)
        fer_scal = torch.as_tensor(np.minimum(scal, 1.0),
                                   device=mesh.resolution.device)
        return StreamDef("fer_scal", lambda s, i: fer_scal,
                         comment="GM resolution scaling", **k)

    # ---- diagnostics-gated ----------------------------------------------
    if sid in ("dMOC", "density_dMOC"):
        if not cfg.diag.ldiag_dMOC:
            return None
        from ..core.diagnostics import density_dmoc
        return StreamDef(sid, lambda s, i: density_dmoc(s, cfg),
                         comment="sigma2 density (density-space MOC)", **k)
    if sid in ("dvd_temp_h", "dvd_temp_v", "dvd_salt_h", "dvd_salt_v"):
        # the discrete variance decay split (ref :505-511, ldiag_DVD)
        if not cfg.diag.ldiag_DVD:
            return None
        tr_i = 0 if "temp" in sid else 1
        attr = "dvd_h" if sid.endswith("_h") else "dvd_v"
        return StreamDef(sid,
                         lambda s, i, _a=attr, _t=tr_i: getattr(s, _a)[_t],
                         comment="discrete variance decay " + sid[4:], **k)
    if sid == "curl_u":
        # the 3D relative vorticity (ref :491-497, ldiag_curl_vel3)
        from ..core.diagnostics import curl_vel3
        return StreamDef("curl_u", lambda s, i: curl_vel3(s, mesh),
                         comment="relative vorticity", **k)
    if sid == "density_flux_e":
        # the surface density flux on elements (ref :372, ldiag_dMOC)
        if not cfg.diag.ldiag_dMOC:
            return None
        from ..core.diagnostics import _elem_mean
        return StreamDef(sid, lambda s, i, f: _elem_mean(_dens_flux(s, f),
                                                         mesh),
                         comment="density flux at elements",
                         wants_forcing=True, **k)
    if sid.startswith("std_dens") or sid in ("U_rho_x_DZ", "V_rho_x_DZ",
                                             "std_heat_flux",
                                             "std_frwt_flux",
                                             "std_rest_flux"):
        # the density-space MOC binning (ref :364-375, ldiag_dMOC): one
        # bundle of diag_dens_moc (without the surface alpha and beta, so
        # without the flux rows, as in the JAX package); an id the bundle
        # lacks takes the classes std_dens
        if not cfg.diag.ldiag_dMOC:
            return None
        from ..core.diagnostics import diag_dens_moc
        key = {"U_rho_x_DZ": "std_dens_UDZ", "V_rho_x_DZ": "std_dens_VDZ",
               "std_heat_flux": "std_dens_flux_H",
               "std_frwt_flux": "std_dens_flux_W",
               "std_rest_flux": "std_dens_flux_R"}.get(sid, sid)

        def bundle(s, i, f):
            return diag_dens_moc(s, mesh, cfg, forcing=f)

        def dmocf(s, i, f, _key=key):
            out = bundle(s, i, f)
            return out.get(_key, out["std_dens"])
        return StreamDef(sid, dmocf, comment="density-MOC " + sid,
                         wants_forcing=True,
                         bundle=("diag_dens_moc", bundle, key, "std_dens"),
                         **k)

    # ---- ice dynamics / ice-ocean stress --------------------------------
    if sid in ("atmice_x", "atmice_y"):
        # atmosphere->ice stress (ref :205-207), carried in the step's
        # forcing
        attr = "stress_atmice_x" if sid.endswith("x") else "stress_atmice_y"
        if not use_ice:
            return None
        return StreamDef(sid, lambda s, i, f, _a=attr: getattr(f, _a),
                         comment="stress atmosphere->ice " + sid[-1],
                         wants_forcing=True, **k)
    if sid in ("iceoce_x", "iceoce_y"):
        # ice->ocean stress (ref :213-215), recomputed from the ice-ocean
        # relative velocity as oce_fluxes_mom does
        if not use_ice:
            return None
        from ..constants import density_0

        def iocstr(s, i, _x=sid.endswith("x")):
            du = i.u_ice - s.unode[0]
            dv = i.v_ice - s.vnode[0]
            sp = torch.sqrt(du ** 2 + dv ** 2)
            c = density_0 * cfg.ice.Cd_oce_ice * sp
            return c * (du if _x else dv)
        return StreamDef(sid, iocstr, comment="stress ice->ocean " + sid[-1],
                         **k)
    if sid in ("alpha_EVP", "beta_EVP"):
        # adaptive-EVP stability fields (ref :499-503, whichEVP == 2)
        if not (use_ice and cfg.ice.whichEVP == 2):
            return None
        attr = "alpha_aevp" if sid.startswith("alpha") else "beta_aevp"
        return StreamDef(sid, lambda s, i, _a=attr: getattr(i, _a),
                         comment="aEVP " + sid, **k)
    if sid == "subli":
        if not use_ice:
            return None
        return StreamDef("subli", lambda s, i: getattr(i, "sublimation",
                                                       i.evaporation * 0.0),
                         comment="sublimation", **k)

    # ---- bulk transfer coefficients (ref :525-529) ----------------------
    if sid in ("cd", "ce", "ch"):
        if atm is None:
            return None
        from ..forcing.atmos import _time_interp
        from ..forcing.bulk import ncar_ocean_fluxes
        comp = {"cd": 0, "ch": 1, "ce": 2}[sid]

        def bulkc(s, i, _c=comp):
            a = current()
            t = atm_time(s)
            cds = ncar_ocean_fluxes(
                _time_interp(a.tair, a.t_wind, t), s.tr[0, 0],
                _time_interp(a.shum, a.t_wind, t),
                _time_interp(a.u_wind, a.t_wind, t),
                _time_interp(a.v_wind, a.t_wind, t), s.unode[0], s.vnode[0])
            return cds[_c]
        return StreamDef(sid, bulkc, comment="bulk transfer coeff " + sid,
                         atm_holder=hold, **k)

    # ---- surface/bottom layer extractions (ref :427-439) ----------------
    if sid in ("u_surf", "v_surf", "u_bott", "v_bott"):
        comp = "u" if sid[0] == "u" else "v"
        bott = sid.endswith("bott")

        def layext(s, i, _c=comp, _b=bott):
            arr = getattr(s, _c)
            return _bottom(arr, mesh) if _b else arr[0]
        return StreamDef(sid, layext,
                         comment=("bottom" if bott else "surface")
                         + " layer velocity " + comp, **k)
    if sid in ("tx_bot", "ty_bot"):
        # the bottom stress C_d |u| u on the bottom layer (ref :433-435)
        comp = 0 if sid[1] == "x" else 1

        def botstr(s, i, _c=comp):
            ub, vb = _bottom(s.u, mesh), _bottom(s.v, mesh)
            sp = torch.sqrt(ub ** 2 + vb ** 2)
            return cfg.dyn.C_d * sp * (ub if _c == 0 else vb)
        return StreamDef(sid, botstr, comment="bottom stress " + sid[1], **k)
    if sid in ("utau_surf", "utau_bott"):
        # the kinetic-energy flux u.tau at the surface or bottom (ref
        # :427-429, ldiag_turbflux)
        bott = sid.endswith("bott")

        def utau(s, i, f, _b=bott):
            if _b:
                ub, vb = _bottom(s.u, mesh), _bottom(s.v, mesh)
                sp = torch.sqrt(ub ** 2 + vb ** 2)
                return cfg.dyn.C_d * sp * (ub ** 2 + vb ** 2)
            return (s.u[0] * f.stress_x + s.v[0] * f.stress_y) / 1035.0
        return StreamDef(sid, utau, comment="KE flux " + sid,
                         wants_forcing=True, **k)

    # ---- turbulence-flux second moments (ref :403-425, ldiag_turbflux) --
    mom2 = {"uu": lambda s: s.u * s.u, "vv": lambda s: s.v * s.v,
            "uv": lambda s: s.u * s.v,
            "um": lambda s: s.u, "vm": lambda s: s.v,
            "wm": lambda s: s.w}
    if sid in mom2:
        return StreamDef(sid, lambda s, i, _f=mom2[sid]: _f(s),
                         comment="turb moment " + sid, **k)
    if sid in ("uw", "vw"):
        comp = "unode" if sid[0] == "u" else "vnode"
        return StreamDef(sid, lambda s, i, _c=comp: getattr(s, _c)
                         * (0.5 * (s.w[:-1] + s.w[1:])),
                         comment="vertical momentum flux " + sid, **k)
    if sid in ("rhof", "wrhof"):
        def rhof(s, i, _w=(sid == "wrhof")):
            r = s.density_m_rho0
            return r * 0.5 * (s.w[:-1] + s.w[1:]) if _w else r
        return StreamDef(sid, rhof, comment="in-situ density flux " + sid,
                         **k)
    grad_map = {"dudx": ("unode", 0), "dudy": ("unode", 1),
                "dvdx": ("vnode", 0), "dvdy": ("vnode", 1)}
    if sid in grad_map:
        from ..core.tracers import tracer_gradient_elements
        attr, comp = grad_map[sid]
        return StreamDef(sid, lambda s, i, _a=attr, _c=comp:
                         tracer_gradient_elements(getattr(s, _a), mesh)[_c],
                         comment="velocity gradient " + sid, **k)
    if sid in ("dudz", "dvdz", "av_dudz", "av_dvdz", "av_dudz_sq"):
        def shear(s, i, _sid=sid):
            u_or_v = s.u if "du" in _sid else s.v
            dz = torch.where(mesh.node_layer_mask, s.hnode, 1.0)
            dze = 0.5 * (dz[:, mesh.elem_nodes].sum(-1) / 3.0)
            den = torch.clamp_min(dze[:-1] + dze[1:], 1e-12)
            top = torch.zeros_like(u_or_v[:1])
            dd = torch.cat([top, (u_or_v[:-1] - u_or_v[1:]) / den], 0)
            if _sid == "av_dudz_sq":
                dv = torch.cat([top, (s.v[:-1] - s.v[1:]) / den], 0)
                return s.Av[:-1] * (dd ** 2 + dv ** 2)
            if _sid.startswith("av_"):
                return s.Av[:-1] * dd
            return dd
        return StreamDef(sid, shear, comment="vertical shear " + sid, **k)

    # ---- mixing-scheme internals ----------------------------------------
    if sid in ("tke", "tke_Lmix", "tke_Pr"):
        if "TKE" not in cfg.dyn.mix_scheme.upper():
            return None
        if sid == "tke":
            return StreamDef("tke", lambda s, i: s.tke,
                             comment="turbulent kinetic energy", **k)

        # mixing length / Prandtl number recomputed from the carried tke
        def tkediag(s, i, _want=sid):
            nb = s.bvfreq
            sq = torch.sqrt(torch.clamp_min(2.0 * s.tke, 1e-30))
            lmix = sq / torch.sqrt(torch.clamp_min(nb, 1e-12))
            if _want == "tke_Lmix":
                return lmix
            return torch.clamp(6.6 * torch.clamp_min(nb, 0.0)
                               / torch.clamp_min(2.0 * s.tke, 1e-30),
                               1.0, 6.6)
        return StreamDef(sid, tkediag, comment="TKE diagnostic " + sid, **k)
    if sid in ("iwe", "iwe_Tdis"):
        if "IDEMIX" not in cfg.dyn.mix_scheme.upper():
            return None
        attr = "iwe" if sid == "iwe" else "iwe_diss"
        return StreamDef(sid, lambda s, i, _a=attr: getattr(s, _a),
                         comment="internal wave energy " + sid, **k)
    if sid in ("kpp_obldepth", "kpp_sbuoyflx"):
        if "KPP" not in cfg.dyn.mix_scheme.upper():
            return None
        if sid == "kpp_obldepth":
            return StreamDef(sid, lambda s, i: s.mld1,
                             comment="KPP boundary-layer depth", **k)

        def sbuoy(s, i, f):
            from ..constants import g
            from ..core import eos
            a, b = eos.sw_alpha_beta(s.tr[0, 0], s.tr[1, 0], s.Z_3d[0])
            return g * (a * f.heat_flux / 3996.0
                        - b * s.tr[1, 0] * f.water_flux)
        return StreamDef(sid, sbuoy, comment="KPP surface buoyancy flux",
                         wants_forcing=True, **k)
    if sid == "Redi_K":
        if not cfg.dyn.Redi:
            return None
        from ..core import gm_redi

        def rediK(s, i):
            sig = gm_redi.compute_sigma_xy(s, mesh)
            ns, _ = gm_redi.compute_neutral_slope(sig, s.bvfreq, mesh)
            return gm_redi.init_redi_gm(s, mesh, cfg, ns)[2]
        return StreamDef("Redi_K", rediK, comment="Redi diffusivity", **k)
    if sid == "momix_length":
        # the Monin-Obukhov mixing length (ref :486-489, use_momix)
        if not cfg.tra.use_momix:
            return None
        return StreamDef(sid, lambda s, i: s.mixlength,
                         comment="Monin-Obukhov length", **k)

    # ---- generic passive-tracer ids (ref :296: 'tra_<id>') --------------
    if sid.startswith("tra_"):
        try:
            tid = int(sid[4:])
        except ValueError:
            return None
        ids = list(cfg.tra.tracer_ID)
        if tid not in ids:
            return None
        idx = ids.index(tid)
        return StreamDef(sid, lambda s, i, _j=idx: s.tr[_j],
                         comment=f"passive tracer {tid}", **k)
    return None


#: Reference ids this port deliberately does not resolve, with the reason
#: (the JAX package's list, ``fesom2_tpu/io/streams.py:811-844``).
STREAMS_NOT_CARRIED = {
    "ssh_rhs": "transient CG rhs; only ssh_rhs_old is model state "
               "(reference writes the in-solve scratch array)",
    "u_dis_tend": "visc_option 6/7 dissipation-tendency split not carried",
    "v_dis_tend": "visc_option 6/7 dissipation-tendency split not carried",
    "u_back_tend": "visc_option 6/7 backscatter-tendency split not carried",
    "v_back_tend": "visc_option 6/7 backscatter-tendency split not carried",
    "u_total_tend": "visc_option 6/7 tendency split not carried",
    "v_total_tend": "visc_option 6/7 tendency split not carried",
    "alb": "__oifs coupled-mode send field (requires OASIS OIFS coupling)",
    "qsi": "__oifs coupled-mode ice heat flux (requires OIFS coupling)",
    "qso": "__oifs coupled-mode ocean heat flux (requires OIFS coupling)",
    "tke_Tbpr": "CVMix TKE tendency-split accumulators not carried "
                "(tke itself is; cvmix_tke.F90 tendency diagnostics)",
    "tke_Tdif": "CVMix TKE tendency split not carried",
    "tke_Tdis": "CVMix TKE tendency split not carried",
    "tke_Twin": "CVMix TKE tendency split not carried",
    "tke_Tiwf": "CVMix TKE tendency split not carried",
    "tke_Tbck": "CVMix TKE tendency split not carried",
    "tke_Tspr": "CVMix TKE tendency split not carried",
    "tke_Ttot": "CVMix TKE tendency split not carried",
    "iwe_Tdif": "IDEMIX tendency split not carried (iwe/iwe_Tdis are)",
    "iwe_Tsur": "IDEMIX tendency split not carried",
    "iwe_Tbot": "IDEMIX tendency split not carried",
    "iwe_Ttot": "IDEMIX tendency split not carried",
    "iwe_c0": "IDEMIX group-velocity internals not carried",
    "iwe_v0": "IDEMIX group-velocity internals not carried",
    "tidal_Av": "CVMix tidal mixing folds into Av; separate component "
                "not carried",
    "tidal_Kv": "CVMix tidal mixing folds into Kv; separate component "
                "not carried",
    "tidal_forcbot": "static tidal bottom forcing field (input data, "
                     "not model state)",
}


def streams_from_io_list(io_list, mesh, cfg, atm=None,
                         fill_T=None, fill_S=None) -> List[StreamDef]:
    """A parsed &nml_list as StreamDefs, skipping (as the reference does)
    the ids whose feature gate is off."""
    if atm is not None and not isinstance(atm, AtmHolder):
        atm = AtmHolder(atm)
    defs = []
    for sid, freq, unit, prec in io_list:
        d = make_stream(sid, mesh, cfg, freq=freq, unit=unit,
                        precision=prec, atm=atm, fill_T=fill_T,
                        fill_S=fill_S)
        if d is not None:
            defs.append(d)
    return defs
