"""The port's run entry points: setup -> time loop -> output, restarts
and diagnostics.

    python -m fesom2_tpu_torch.run soufflet --steps N --device cuda \\
        [--f32] [--mesh DIR] [--result DIR]
    python -m fesom2_tpu_torch.run pi --steps N --device cuda \\
        [--f32] [--level 7] [--seed 0] [--mesh DIR] [--parity ci|fast] \\
        [--forcing DIR] [--icepack] [--result DIR] [--restart-every K] \\
        [--resume]
    python -m fesom2_tpu_torch.run --version | --info

The port of ``fesom2_tpu/run.py``.  ``--device`` defaults to cuda and
raises where CUDA is missing; the CPU runs only when asked for with
``--device cpu``.  Without ``--mesh`` the soufflet run uses the default
code-built channel (``mesh/channel.py``) and the pi run writes the globe
of ``--level`` (``mesh/globe.py``; level 7: 114,033 ocean nodes) into a
temporary directory.  With ``--result DIR`` a run writes its mean output
streams (``io/streams.py``: the default ocean and ice streams, Icepack's
with ``--icepack``) and, on a fresh pi run, the mesh description
``fesom.mesh.diag.nc`` (``io/mesh_info.py``) into DIR; ``--restart-every
K`` writes ``DIR/restart.nc`` (``io/restart.py``) and ``DIR/fesom.clock``
every K steps, and ``--resume`` continues from them up to step N.
A run from a reference setup.yml, with its golden check, is ``mkrun``.

``run_pi`` takes coupled ocean + ice steps of the global configuration
(``model.setup_pi_model``, ``model.pi_initial_state``,
``model.pi_coupled_step_fn``) and scans every step for a blowup
(``core/diag.py``: ``check_blowup``, ice outside the EVP subdomain
included); with ``use_icepack`` (``run pi --icepack``) the ice is the
multi-category Icepack column physics (``ice/icepack``), its EVP on the
whole mesh, started from the initial ice by ``init_icepack_state``
(``fesom2_tpu/run.py:71-78, 134-135``).  With forcing from files
(``--forcing DIR``: the NCEP test set and ``woa18_netcdf_5deg.nc`` in
DIR) it switches the forcing year as ``fesom2_tpu/run.py:108-156`` does:
the step index it hands the step counts from the start of the clock's
year, and at a year's end the next year's series, read ahead on a host
thread (``SbcProvider``), replace it.  ``run_pi_ocean`` drives its ocean
alone, with shortwave penetration and no ice, as the coupled step of
``fesom2_tpu/model.py:396-407`` does below open water;
``globe_ocean_inputs`` gives that run's initial state and forcing on a
mesh of ``mesh/globe.py``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from dataclasses import dataclass, replace
from typing import Optional

import torch
from torch.profiler import record_function

from .core import tracers
from .core.diag import (blowup_reasons, blowup_scope, check_blowup,
                        first_bad_step, format_step_info, ice_outside_mask,
                        step_info)
from .core.state import OceanState, Forcing, zero_forcing
from .forcing.atmos import SbcProvider
from .io.mesh_info import write_mesh_info
from .io.restart import read_restart, write_restart
from .io.streams import (OutputStreams, default_ice_streams,
                         default_icepack_streams, default_ocean_streams)
from .mesh.globe import write_globe
from .ice.state import IceState
from .model import (Model, globe_atm_data, globe_ocean_fixtures,
                    pi_coupled_step_fn, pi_initial_state, setup_pi_model,
                    setup_soufflet_model)
from .utils.clock import Clock, read_clock_file, write_clock_file

# the inputs of a run on the code-built globe, under one roof:
# ``globe_atm_data`` (defined beside ``setup_pi_model``, which needs it)
# and ``globe_ocean_inputs`` below
__all__ = ["RunTimers", "step_info", "format_step_info",
           "ice_outside_subdomain", "run_soufflet", "globe_atm_data",
           "globe_ocean_inputs", "run_pi_ocean", "run_pi", "main"]


@dataclass
class RunTimers:
    """Wall-clock accounting of the run (ref BENCHMARK RUNTIME): the
    steps, the output streams' updates and flushes, the restarts."""
    setup: float = 0.0
    step: float = 0.0
    output: float = 0.0
    restart: float = 0.0
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
                 f" runtime step  [s]   : {self.step:.3f}",
                 f" runtime output [s]  : {self.output:.3f}",
                 f" runtime restart [s] : {self.restart:.3f}"]
        if self.n_steps:
            lines.append(f" sec/step            : "
                         f"{self.step / self.n_steps:.4f}")
        return "\n".join(lines)


def ice_outside_subdomain(ice: IceState, model: Model) -> int:
    """Nodes with a_ice > 0.01 outside the EVP subdomain (0 without one)
    (``core.diag.ice_outside_mask``)."""
    if model.ice_sub is None:
        return 0
    return int(ice_outside_mask(ice, model.ice_sub).sum())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_soufflet(n_steps: int = 72, *, device="cuda", dtype=torch.float64,
                 mesh_path: Optional[str] = None, logfile_outfreq: int = 10,
                 verbose: bool = True, model: Optional[Model] = None,
                 state: Optional[OceanState] = None,
                 result_path: Optional[str] = None):
    """Run the soufflet channel (no ice, no external forcing); with
    ``result_path`` the default ocean streams are written there
    (``fesom2_tpu/run.py:192-229``).  Returns (model, final state,
    timers)."""
    t_all = time.perf_counter()
    if model is None:
        model = setup_soufflet_model(mesh_path, device=device, dtype=dtype)
    mesh = model.mesh
    dev = mesh.zbar.device
    state = state if state is not None else model.initial_state()
    forcing = zero_forcing(mesh, model.dtype)
    step = model.step_fn()
    clock = Clock(0.0, 1, model.cfg.clock.yearnew)
    streams = None if result_path is None else OutputStreams(
        default_ocean_streams(mesh), result_path)
    timers = RunTimers(setup=time.perf_counter() - t_all)
    with torch.no_grad():
        for k in range(n_steps):
            _sync(dev)
            t0 = time.perf_counter()
            state = step(state, forcing)
            _sync(dev)
            timers.step += time.perf_counter() - t0
            timers.n_steps += 1
            before = clock.copy()
            clock.advance(model.cfg.dt)
            if streams is not None:
                t0 = time.perf_counter()
                streams.update_means(state, None)
                streams.maybe_flush(before, clock, k)
                timers.output += time.perf_counter() - t0
            if verbose and (k + 1) % logfile_outfreq == 0:
                print(format_step_info(step_info(state, mesh), k + 1),
                      flush=True)
    if streams is not None:
        t0 = time.perf_counter()
        streams.finalize()
        timers.output += time.perf_counter() - t0
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
           ipk=None, result_path: Optional[str] = None,
           restart_every: Optional[int] = None, resume: bool = False,
           stream_defs=None):
    """``n_steps`` coupled ocean + ice steps of the global configuration
    from step index ``first_step`` (model time ``first_step * dt``).
    Prints the step norms every ``logfile_outfreq`` steps when
    ``verbose``.  Returns (state, ice).

    Every step is scanned for a blowup (``core.diag.check_blowup``, with
    the EVP subdomain's escape guard where the EVP runs on one), as in
    ``fesom2_tpu/run.py:164-174``, but with no host wait each step: a
    sticky flag on the device keeps the first bad step, and the host reads
    it every ``logfile_outfreq`` steps, before each restart and at the
    end.  On a bad flag the run writes ``blowup.nc`` (a restart file of
    the state at the read) into ``result_path``, if there is one, and
    raises, naming the first bad step.  This is the one difference from
    the JAX package, which reads the flag after every step: the state
    dumped is that of the read, up to ``logfile_outfreq - 1`` steps after
    the first bad one.

    With ``result_path`` the run writes there, as ``fesom2_tpu/run.py:
    48-190`` does: the mesh description ``fesom.mesh.diag.nc`` on a fresh
    run; the mean streams ``stream_defs`` (default: the default ocean and
    ice streams, and Icepack's under Icepack; written on a thread); with
    ``restart_every``, ``restart.nc`` and
    ``fesom.clock`` every that many steps.  ``resume`` continues from
    those two files: the state, ice (and Icepack state) are read into the
    ones given, the clock is read, and the run goes from the restart's
    step up to step ``n_steps``: under ``resume`` ``n_steps`` is the run's
    total step count and ``first_step`` is not read.

    ``use_icepack`` switches the model to Icepack (``cfg.run.use_icepack``
    and ``cfg.icepack = IcepackConfig(**icepack_opts)``, as
    ``fesom2_tpu/run.py:71-78`` does; a model already so configured keeps
    its IcepackConfig when ``icepack_opts`` is None) and returns (state,
    ice, ipk); ``ipk`` continues a run, else ``init_icepack_state`` builds
    it from ``ice``.  Its EVP runs on the whole mesh: no subdomain guard.

    Where the forcing came from files (``model.sbc``), the clock starts on
    Jan 1 of ``cfg.clock.yearnew`` at step 0 and the step index counts from
    the start of the clock's year (``fesom2_tpu/run.py:108-156``); ``atm``
    is the series of the year the first step falls in.  A run that crosses
    a year's end switches to the next year's series: read ahead on a host
    thread by ``SbcProvider`` (evict the old year, get the new one,
    prefetch the one after), or the same series again under
    ``y_perpetual``; the atm-backed streams follow."""
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
    mesh = model.mesh
    dev = mesh.zbar.device
    dt = model.cfg.dt
    t_out = time.perf_counter()
    clock = Clock(0.0, 1, model.cfg.clock.yearnew)
    if resume:
        if result_path is None:
            raise ValueError("resume needs the result_path of the run")
        loaded = read_restart(os.path.join(result_path, "restart.nc"),
                              state, ice, ipk=ipk, mesh=mesh, cfg=model.cfg)
        state, ice = loaded[:2]
        if icepack:
            ipk = loaded[2]
        clock = read_clock_file(os.path.join(result_path, "fesom.clock"))
        first_step = int(state.step)
        n_steps = max(n_steps - first_step, 0)
        if verbose:
            print(f" --> resumed from {result_path}/restart.nc at step "
                  f"{first_step} (clock {clock.yearnew}-{clock.daynew})",
                  flush=True)
    else:
        for _ in range(first_step):
            clock.advance(dt)
    streams = None
    if result_path is not None:
        os.makedirs(result_path, exist_ok=True)
        if not resume:
            write_mesh_info(result_path, mesh)   # fvom_main.F90, fresh runs
        if stream_defs is None:
            stream_defs = default_ocean_streams(mesh) + default_ice_streams()
            if icepack:
                stream_defs += default_icepack_streams(model.cfg.icepack)
        streams = OutputStreams(stream_defs, result_path)
    t_out = time.perf_counter() - t_out
    if timers is not None:
        timers.output += t_out
    step = pi_coupled_step_fn(model, atm)
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
    ice_sub = None if icepack else model.ice_sub
    scope = blowup_scope(mesh)          # a padded mesh's dummies unread
    first_bad = torch.full((), -1, dtype=torch.int32, device=dev)

    def read_flag(k):
        """Raise if a step so far blew up (a host read of the flag)."""
        bad = int(first_bad)
        if bad < 0:
            return
        where = ""
        if result_path is not None:
            where = os.path.join(result_path, "blowup.nc")
            write_restart(where, state, ice, k, ipk=ipk)
            where = f"; state at step {k + 1} dumped to {where}"
        raise RuntimeError(
            f"blowup detected at step {bad} (read at step {k + 1}): "
            f"{blowup_reasons(state, mesh, ice, ice_sub, scope)}{where}")

    for k in range(first_step, first_step + n_steps):
        if timers is None:
            # no host wait between steps: the host queues the next step's
            # forcing and ice while the card finishes the ocean's
            out = step(state, ice, k - k_off, ipk) if icepack \
                else step(state, ice, k - k_off)
        else:
            _sync(dev)
            t0 = time.perf_counter()
            out = step(state, ice, k - k_off, ipk) if icepack \
                else step(state, ice, k - k_off)
            _sync(dev)
            timers.step += time.perf_counter() - t0
            timers.n_steps += 1
        state, ice, oforc = out[0], out[1], out[-1]
        if icepack:
            ipk = out[2]
        first_bad = first_bad_step(
            check_blowup(state, mesh, ice, ice_sub, scope), first_bad, k + 1)
        before = clock.copy()
        clock.advance(dt)
        if steps_per_year is not None and clock.yearnew != before.yearnew:
            k_off = k + 1
            if provider is not None:
                provider.evict(before.yearnew)
                atm = provider.get(clock.yearnew)
                provider.prefetch(clock.yearnew + 1)
                step = pi_coupled_step_fn(model, atm)
                if streams is not None:
                    streams.set_atm(atm)
            if verbose:
                print(f" --> forcing year switched to {clock.yearnew}"
                      f"{' (perpetual)' if provider is None else ''}",
                      flush=True)
        if streams is not None:
            t0 = time.perf_counter()
            with record_function("step.output"):
                streams.update_means(state, ice, ipk, oforc)
                streams.maybe_flush(before, clock, k)
            if timers is not None:
                timers.output += time.perf_counter() - t0
        last = k + 1 == first_step + n_steps
        if last or (k + 1) % logfile_outfreq == 0:
            read_flag(k)
            if verbose:
                print(format_step_info(step_info(state, mesh, ice), k + 1),
                      flush=True)
                if model.cfg.diag.ldiag_salt3D:
                    from .core.diagnostics import salt3d_integral
                    print(" total integral of salinity at timestep : %d "
                          "%.10e" % (k + 1,
                                     float(salt3d_integral(state, mesh))),
                          flush=True)
        if result_path is not None and restart_every \
                and (k + 1) % restart_every == 0:
            read_flag(k)
            t0 = time.perf_counter()
            write_restart(os.path.join(result_path, "restart.nc"), state,
                          ice, k, ipk=ipk)
            write_clock_file(os.path.join(result_path, "fesom.clock"), clock)
            if timers is not None:
                timers.restart += time.perf_counter() - t0
    if streams is not None:
        t0 = time.perf_counter()
        streams.finalize()
        if timers is not None:
            timers.output += time.perf_counter() - t0
    if icepack:
        return state, ice, ipk
    return state, ice


def _version_string() -> str:
    """The checkout's git SHA with a dirty flag, or "unknown" outside a
    git checkout (ref fesom_version_info.F90, src/CMakeLists.txt:18-26)."""
    import subprocess
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        sha = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             cwd=here, capture_output=True, text=True,
                             timeout=5)
        if sha.returncode != 0:
            return "unknown"
        dirty = subprocess.run(["git", "status", "--porcelain"],
                               cwd=here, capture_output=True, text=True,
                               timeout=5).stdout.strip()
        return sha.stdout.strip() + ("-dirty" if dirty else "")
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def print_info():
    """--info (ref info_module.F90:19, command_line_options.F90:16): the
    version, torch and its CUDA, and the cards."""
    print(f"fesom2_tpu_torch version: {_version_string()}")
    print(f"torch: {torch.__version__} (cuda {torch.version.cuda})")
    cards = [torch.cuda.get_device_name(i)
             for i in range(torch.cuda.device_count())] \
        if torch.cuda.is_available() else []
    print(f"devices: {cards or 'no CUDA device'}")
    print("configs: pi (global ocean+ice on a code-built globe; --icepack, "
          "--parity fast, --forcing DIR), soufflet (baroclinic channel)")


def main(argv=None):
    import sys
    argv = sys.argv[1:] if argv is None else argv
    if "--version" in argv:
        print(_version_string())
        return
    if "--info" in argv:
        print_info()
        return
    p = argparse.ArgumentParser(description="fesom2_tpu_torch run driver")
    p.add_argument("config", choices=["soufflet", "pi"])
    p.add_argument("--steps", type=int, default=72,
                   help="steps to take (with --resume: the run's total)")
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
    p.add_argument("--result", default=None,
                   help="directory of the output streams, the mesh "
                        "description and the restarts (default: none)")
    p.add_argument("--restart-every", type=int, default=None,
                   help="pi: write <result>/restart.nc every N steps")
    p.add_argument("--resume", action="store_true",
                   help="pi: continue from <result>/restart.nc and "
                        "fesom.clock up to step --steps")
    p.add_argument("--version", action="store_true",
                   help="print the checkout's git SHA")
    p.add_argument("--info", action="store_true",
                   help="print the version, torch and the cards")
    args = p.parse_args(argv)
    dtype = torch.float32 if args.f32 else torch.float64
    if args.config == "soufflet":
        run_soufflet(args.steps, device=args.device, dtype=dtype,
                     mesh_path=args.mesh, result_path=args.result)
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
           use_icepack=args.icepack, result_path=args.result,
           restart_every=args.restart_every, resume=args.resume)
    timers.total = time.perf_counter() - t_all
    print(timers.report(model.mesh.zbar.device), flush=True)


if __name__ == "__main__":
    main()
