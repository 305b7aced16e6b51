"""Run driver for the port: setup -> time loop -> norms and timing.

    python -m fesom2_tpu_torch.run soufflet --steps N --device cuda \\
        [--f32] [--mesh DIR]
    python -m fesom2_tpu_torch.run pi --steps N --device cuda \\
        [--f32] [--level 7] [--seed 0] [--mesh DIR] [--parity ci|fast] \\
        [--forcing DIR] [--icepack]

The port of ``fesom2_tpu/run.py:run_soufflet`` and of the time loop of
``run_pi``.  ``--device`` defaults to cuda and raises where CUDA is
missing; the CPU runs only when asked for with ``--device cpu``.  Without
``--mesh`` the soufflet run uses the default code-built channel
(``mesh/channel.py``) and the pi run writes the globe of ``--level``
(``mesh/globe.py``; level 7: 114,033 ocean nodes) into a temporary
directory.  Output streams, restarts and ``mkrun`` are not ported yet
(ROADMAP queue 1 item 20).

``run_pi`` takes coupled ocean + ice steps of the global configuration
(``model.setup_pi_model``, ``model.pi_initial_state``,
``model.pi_coupled_step_fn``) and raises where ice shows up outside the
EVP subdomain; with ``use_icepack`` (``run pi --icepack``) the ice is the
multi-category Icepack column physics (``ice/icepack``), its EVP on the
whole mesh, started from the initial ice by ``init_icepack_state``
(``fesom2_tpu/run.py:71-78, 134-135``; its output streams are not
ported).  With forcing from files (``--forcing DIR``: the NCEP test
set and ``woa18_netcdf_5deg.nc`` in DIR) it switches the forcing year as
``fesom2_tpu/run.py:108-156`` does: the step index it hands the step
counts from the start of the clock's year, and at a year's end the next
year's series, read ahead on a host thread (``SbcProvider``), replace it.  ``run_pi_ocean`` drives its ocean alone, with shortwave
penetration and no ice, as the coupled step of
``fesom2_tpu/model.py:396-407`` does below open water;
``globe_ocean_inputs`` gives that run's initial state and forcing on a
mesh of ``mesh/globe.py``.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from dataclasses import dataclass, replace
from typing import Dict, Optional

import torch

from .core import tracers
from .core.state import OceanState, Forcing, zero_forcing
from .forcing.atmos import SbcProvider
from .mesh import MeshTables
from .mesh.globe import write_globe
from .ice.state import IceState
from .model import (Model, globe_atm_data, globe_ocean_fixtures,
                    pi_coupled_step_fn, pi_initial_state, setup_pi_model,
                    setup_soufflet_model)
from .utils.clock import Clock

# the inputs of a run on the code-built globe, under one roof:
# ``globe_atm_data`` (defined beside ``setup_pi_model``, which needs it)
# and ``globe_ocean_inputs`` below
__all__ = ["RunTimers", "step_info", "format_step_info",
           "ice_outside_subdomain", "run_soufflet", "globe_atm_data",
           "globe_ocean_inputs", "run_pi_ocean", "run_pi", "main"]


@dataclass
class RunTimers:
    """Wall-clock accounting of the step loop (ref BENCHMARK RUNTIME)."""
    setup: float = 0.0
    step: float = 0.0
    total: float = 0.0
    n_steps: int = 0

    def report(self, device: torch.device) -> str:
        name = torch.cuda.get_device_name(device) if device.type == "cuda" \
            else "cpu"
        lines = ["=== BENCHMARK RUNTIME ===",
                 f" device              : {name}",
                 f" steps               : {self.n_steps}",
                 f" runtime setup [s]   : {self.setup:.3f}",
                 f" runtime total [s]   : {self.total:.3f}",
                 f" runtime step  [s]   : {self.step:.3f}"]
        if self.n_steps:
            lines.append(f" sec/step            : "
                         f"{self.step / self.n_steps:.4f}")
        return "\n".join(lines)


def step_info(state: OceanState, mesh: MeshTables,
              ice: Optional[IceState] = None) -> Dict[str, float]:
    """Global min/max norms of the prognostic fields; with ``ice`` also the
    largest concentration, thickness and drift speed, the ice area [m^2]
    and the ice volume [m^3]."""
    nmask = mesh.node_layer_mask
    area = mesh.area[0]
    T = state.tr[0][nmask]
    S = state.tr[1][nmask]
    vals = torch.stack([
        state.eta.min(), state.eta.max(), (state.eta * area).sum() / area.sum(),
        T.min(), T.max(), S.min(), S.max(), state.u.abs().max(),
        state.v.abs().max(), state.w.abs().max(), state.cfl_z.max()])
    names = ("eta_min", "eta_max", "eta_int", "T_min", "T_max", "S_min",
             "S_max", "u_max", "v_max", "w_max", "cfl_z_max")
    if ice is not None:
        vals = torch.cat([vals, torch.stack([
            ice.a_ice.max(), ice.m_ice.max(), ice.u_ice.abs().max(),
            (ice.a_ice * area).sum(), (ice.m_ice * area).sum()])])
        names += ("aice_max", "hice_max", "uice_max", "ice_area",
                  "ice_volume")
    return dict(zip(names, vals.tolist()))


def ice_outside_subdomain(ice: IceState, model: Model) -> int:
    """Nodes with a_ice > 0.01 outside the EVP subdomain (0 without one):
    the dynamics are frozen there, so any such node means the cap was
    chosen too tight (``fesom2_tpu/core/diag.py:72-78``)."""
    sub = model.ice_sub
    if sub is None:
        return 0
    return int(((ice.a_ice > 0.01) & ~sub.node_mask).sum())


def format_step_info(info: Dict[str, float], step: int) -> str:
    return " | ".join([f"step {step:7d}"]
                      + [f"{k}={v:+.6e}" for k, v in info.items()])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_soufflet(n_steps: int = 72, *, device="cuda", dtype=torch.float64,
                 mesh_path: Optional[str] = None, logfile_outfreq: int = 10,
                 verbose: bool = True, model: Optional[Model] = None,
                 state: Optional[OceanState] = None):
    """Run the soufflet channel (no ice, no external forcing).
    Returns (model, final state, timers)."""
    t_all = time.perf_counter()
    if model is None:
        model = setup_soufflet_model(mesh_path, device=device, dtype=dtype)
    mesh = model.mesh
    dev = mesh.zbar.device
    state = state if state is not None else model.initial_state()
    forcing = zero_forcing(mesh, model.dtype)
    step = model.step_fn()
    timers = RunTimers(setup=time.perf_counter() - t_all)
    with torch.no_grad():
        for k in range(n_steps):
            _sync(dev)
            t0 = time.perf_counter()
            state = step(state, forcing)
            _sync(dev)
            timers.step += time.perf_counter() - t0
            timers.n_steps += 1
            if verbose and (k + 1) % logfile_outfreq == 0:
                print(format_step_info(step_info(state, mesh), k + 1),
                      flush=True)
    timers.total = time.perf_counter() - t_all
    if verbose:
        print(timers.report(dev), flush=True)
    return model, state, timers


def globe_ocean_inputs(model: Model, seed: int = 0):
    """(initial state, forcing, shortwave [N]) of ``mesh/globe.py``'s
    fixtures on ``model``'s mesh, at its dtype and device: T/S profiles
    with seeded noise, zonal wind stress, heat and zero-mean water fluxes,
    the atmospheric stress for the Monin-Obukhov mixing."""
    mesh = model.mesh
    fx = globe_ocean_fixtures(model, seed)
    dev, dt = mesh.zbar.device, model.dtype
    put = lambda a: torch.as_tensor(a, device=dev).to(dt)
    state = model.initial_state()
    tr = state.tr.clone()
    tr[0], tr[1] = put(fx["T"]), put(fx["S"])
    state = replace(state, tr=tr, tr_old=tr)
    forcing = replace(zero_forcing(mesh, dt), **{
        k: put(fx[k]) for k in ("stress_x", "stress_y", "stress_atm_x",
                                "stress_atm_y", "heat_flux", "water_flux")})
    return state, forcing, put(fx["shortwave"])


def run_pi_ocean(model: Model, state: OceanState, forcing: Forcing,
                 shortwave: torch.Tensor, n_steps: int) -> OceanState:
    """``n_steps`` ocean steps of the global configuration.  Each step
    takes the penetrating part of ``shortwave`` [N] from the state's
    interfaces (no ice: ``a_ice = 0``) and adds the surface flux it moves
    to depth to ``heat_flux``, as ``fesom2_tpu/model.py:396-407`` does;
    without ``use_sw_pene`` the forcing goes in unchanged."""
    cfg = model.cfg
    step = model.step_fn()
    a_ice = torch.zeros_like(shortwave)
    with torch.no_grad():
        for _ in range(n_steps):
            f, sw_3d = forcing, None
            if cfg.run.use_sw_pene:
                sw_3d, dheat = tracers.shortwave_penetration(
                    shortwave, a_ice, state.zbar_3d, model.mesh,
                    cfg.ice.albw)
                f = replace(forcing, heat_flux=forcing.heat_flux + dheat)
            state = step(state, f, sw_3d)
    return state


def run_pi(model: Model, atm, state: OceanState, ice: IceState,
           n_steps: int, *, first_step: int = 0, logfile_outfreq: int = 10,
           verbose: bool = False, timers: Optional[RunTimers] = None,
           use_icepack: bool = False, icepack_opts: Optional[dict] = None,
           ipk=None):
    """``n_steps`` coupled ocean + ice steps of the global configuration
    from step index ``first_step`` (model time ``first_step * dt``).
    Prints the step norms every ``logfile_outfreq`` steps when ``verbose``;
    raises where ice lies outside the EVP subdomain at such a step or at
    the end.  Returns (state, ice).

    ``use_icepack`` switches the model to Icepack (``cfg.run.use_icepack``
    and ``cfg.icepack = IcepackConfig(**icepack_opts)``, as
    ``fesom2_tpu/run.py:71-78`` does; a model already so configured keeps
    its IcepackConfig when ``icepack_opts`` is None) and returns (state,
    ice, ipk); ``ipk`` continues a run, else ``init_icepack_state`` builds
    it from ``ice``.  Its EVP runs on the whole mesh: no subdomain check.

    Where the forcing came from files (``model.sbc``), the clock starts on
    Jan 1 of ``cfg.clock.yearnew`` at step 0 and the step index counts from
    the start of the clock's year (``fesom2_tpu/run.py:108-156``); ``atm``
    is the series of the year ``first_step`` falls in.  A run that crosses
    a year's end switches to the next year's series: read ahead on a host
    thread by ``SbcProvider`` (evict the old year, get the new one,
    prefetch the one after), or the same series again under
    ``y_perpetual``."""
    if use_icepack or model.cfg.run.use_icepack:
        from .ice.icepack import IcepackConfig, init_icepack_state
        cfg = model.cfg
        if icepack_opts is not None or not isinstance(cfg.icepack,
                                                      IcepackConfig):
            cfg.icepack = IcepackConfig(**(icepack_opts or {}))
        cfg.run.use_icepack = True
        if ipk is None:
            ipk = init_icepack_state(cfg.icepack, ice.a_ice, ice.m_ice,
                                     ice.m_snow, ice.t_skin,
                                     dtype=model.dtype)
    icepack = model.cfg.run.use_icepack
    step = pi_coupled_step_fn(model, atm)
    mesh = model.mesh
    dev = mesh.zbar.device
    dt = model.cfg.dt
    clock = Clock(0.0, 1, model.cfg.clock.yearnew)
    for _ in range(first_step):
        clock.advance(dt)
    provider, steps_per_year, k_off = None, None, 0
    sbc = model.sbc
    if sbc is not None and n_steps > 0:
        steps_per_year = int(round(365 * 86400.0 / dt))
        k_off = (first_step // steps_per_year) * steps_per_year
        if (first_step + n_steps > steps_per_year
                and not sbc.y_perpetual):
            provider = SbcProvider(mesh, sbc, model.dtype)
            provider._cache[clock.yearnew] = atm
            provider.prefetch(clock.yearnew + 1)
    def take(state, ice, ipk, k):
        if icepack:
            state, ice, ipk, _ = step(state, ice, k, ipk)
        else:
            state, ice, _ = step(state, ice, k)
        return state, ice, ipk

    for k in range(first_step, first_step + n_steps):
        if timers is None:
            # no host wait between steps: the host queues the next step's
            # forcing and ice while the card finishes the ocean's
            state, ice, ipk = take(state, ice, ipk, k - k_off)
        else:
            _sync(dev)
            t0 = time.perf_counter()
            state, ice, ipk = take(state, ice, ipk, k - k_off)
            _sync(dev)
            timers.step += time.perf_counter() - t0
            timers.n_steps += 1
        year = clock.yearnew
        clock.advance(dt)
        if steps_per_year is not None and clock.yearnew != year:
            k_off = k + 1
            if provider is not None:
                provider.evict(year)
                atm = provider.get(clock.yearnew)
                provider.prefetch(clock.yearnew + 1)
                step = pi_coupled_step_fn(model, atm)
            if verbose:
                print(f" --> forcing year switched to {clock.yearnew}"
                      f"{' (perpetual)' if provider is None else ''}",
                      flush=True)
        last = k + 1 == first_step + n_steps
        if last or (verbose and (k + 1) % logfile_outfreq == 0):
            outside = 0 if icepack else ice_outside_subdomain(ice, model)
            if outside:
                raise RuntimeError(
                    f"step {k + 1}: ice at {outside} nodes outside the EVP "
                    "subdomain: rebuild it with more margin "
                    "(cfg.ice.evp_subdomain_lat)")
            if verbose:
                print(format_step_info(step_info(state, mesh, ice), k + 1),
                      flush=True)
    if icepack:
        return state, ice, ipk
    return state, ice


def main(argv=None):
    p = argparse.ArgumentParser(description="fesom2_tpu_torch run driver")
    p.add_argument("config", choices=["soufflet", "pi"])
    p.add_argument("--steps", type=int, default=72)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; the CPU only when asked)")
    p.add_argument("--f32", action="store_true")
    p.add_argument("--mesh", default=None,
                   help="FESOM mesh directory (default: code-built channel, "
                        "or the globe of --level)")
    p.add_argument("--level", type=int, default=7,
                   help="pi: subdivision level of the code-built globe")
    p.add_argument("--seed", type=int, default=0,
                   help="pi: seed of the initial state and the atmosphere")
    p.add_argument("--parity", choices=["ci", "fast"], default="ci",
                   help="pi: the CI configuration or the fast one (linfs + "
                        "PP), as bench.py's BENCH_PARITY")
    p.add_argument("--forcing", default=None,
                   help="pi: a directory with the NCEP test-set forcing "
                        "(u_10.1948.nc, ..., runoff.nc, NetCDF3) and "
                        "woa18_netcdf_5deg.nc (default: both built in code)")
    p.add_argument("--icepack", action="store_true",
                   help="pi: multi-category ice column physics (Icepack)")
    args = p.parse_args(argv)
    dtype = torch.float32 if args.f32 else torch.float64
    if args.config == "soufflet":
        run_soufflet(args.steps, device=args.device, dtype=dtype,
                     mesh_path=args.mesh)
        return
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = args.mesh or write_globe(tmp, level=args.level)
        model, atm = setup_pi_model(path, device=args.device, dtype=dtype,
                                    parity=args.parity, atm_seed=args.seed,
                                    forcing_path=args.forcing)
    state, ice = pi_initial_state(model, seed=args.seed,
                                  forcing_path=args.forcing)
    timers = RunTimers(setup=time.perf_counter() - t_all)
    run_pi(model, atm, state, ice, args.steps, verbose=True, timers=timers,
           use_icepack=args.icepack)
    timers.total = time.perf_counter() - t_all
    print(timers.report(model.mesh.zbar.device), flush=True)


if __name__ == "__main__":
    main()
