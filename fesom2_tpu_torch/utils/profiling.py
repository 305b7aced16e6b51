"""Per-phase step profiling: the reference's per-step ALE breakdown table
(``oce_ale.F90:2779-2797``, ``ice_setup_step.F90:263-277``, "BENCHMARK
RUNTIME" ``fvom_main.F90:299-327``) for the port's coupled step.

The port of ``fesom2_tpu/utils/profiling.py``.  Each phase is timed as its
own call on the same state, as there (the JAX step is one fused program;
the port's runs its operators and kernels in turn, so the isolation also
keeps the table comparable between the two).  The sum of the phases is
reported beside the whole step.  ``torch.cuda.synchronize`` ends each
timing on a card, where the JAX module drains the device with a host read
(``_barrier``).

Usage (one process, one card):

    from fesom2_tpu_torch.utils.profiling import profile_pi_phases
    table = profile_pi_phases(mesh_path, dtype=torch.float32)
"""
from __future__ import annotations

import dataclasses
import time

import torch

PHASES = ("eos_pressure", "mixing", "momentum", "ssh_solve", "vert_vel",
          "tracers", "ice_total")


def _time_fn(fn, args, n: int, sync) -> float:
    """Seconds a call of ``fn(*args)``: two warm-up calls, then the mean of
    ``n`` calls between two synchronisations."""
    fn(*args)
    sync()
    fn(*args)                        # second call: caches warm
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)
    sync()
    return (time.perf_counter() - t0) / n


def profile_pi_phases(mesh_path: str, *, device="cuda", dtype=torch.float64,
                      n: int = 5, parity: str = "ci", n_refine: int = 0,
                      verbose: bool = True) -> dict:
    """Build the pi coupled model on ``mesh_path`` and time each step
    phase in isolation.

    Returns {phase: sec/step}: 'coupled_total' (the whole coupled step),
    'ocean_total' (the ocean step alone), 'ice_plus_forcing' (their
    difference), the phases 'eos_pressure', 'mixing', 'momentum',
    'ssh_solve' (the warm-started solve less the momentum prelude),
    'vert_vel', 'tracers', 'ice_total', 'ice_evp' (the ice's dynamics
    alone, inside 'ice_total'), and 'sum_of_phases' (the sum of the seven
    of ``PHASES``)."""
    from ..core import ale, dynamics, eos, ssh
    from ..core.state import zero_forcing
    from ..forcing.atmos import atm_window
    from ..ice import coupling as ice_cpl
    from ..ice.evp import ice_dynamics
    from ..ice.state import zero_ice_forcing
    from ..ice.step import ice_timestep
    from ..model import (pi_coupled_step_fn, pi_initial_state,
                         setup_pi_model, solve_tracers)

    device = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    model, atm = setup_pi_model(mesh_path, device=device, dtype=dtype,
                                parity=parity, n_refine=n_refine)
    state, ice = pi_initial_state(model)
    cfg, mesh = model.cfg, model.mesh
    atm = atm_window(atm, 0.0, 25 * cfg.dt)
    forcing = zero_forcing(mesh, dtype)
    ice_forcing = zero_ice_forcing(mesh, dtype)
    step = pi_coupled_step_fn(model, atm)

    # advance a few steps so the state is dynamically active
    for k in range(2):
        state, ice, forcing = step(state, ice, k)
    sync()

    results = {}
    with torch.no_grad():
        # --- full coupled step and the ocean step alone -----------------
        results["coupled_total"] = _time_fn(
            lambda k: step(state, ice, k), (5,), n, sync)
        results["ocean_total"] = _time_fn(model, (state, forcing), n, sync)
        results["ice_plus_forcing"] = max(results["coupled_total"]
                                          - results["ocean_total"], 0.0)

        # --- ocean phases (ref rtime table: press/mix, dyn, ssh, tracer)
        def ph_pressure(st):
            st = eos.pressure_bv(st, mesh, cfg, model.density_ref)
            return dynamics.pressure_force(st, mesh, cfg)
        results["eos_pressure"] = _time_fn(ph_pressure, (state,), n, sync)

        if cfg.dyn.mix_scheme.upper() == "KPP":
            from ..core.mixing import kpp as kpp_mixing

            def ph_mix(st, fo):
                return kpp_mixing.oce_mixing_kpp(st, mesh, cfg, fo)
        else:
            from ..core.mixing import pp as pp_mixing

            def ph_mix(st, fo):
                return pp_mixing.oce_mixing_pp(st, mesh, cfg)
        results["mixing"] = _time_fn(ph_mix, (state, forcing), n, sync)

        def ph_momentum(st, fo):
            st, u_rhs, v_rhs = dynamics.compute_vel_rhs(st, mesh, fo, cfg)
            st, u_rhs, v_rhs = dynamics.viscosity_filter(st, mesh, cfg,
                                                         u_rhs, v_rhs)
            return dynamics.impl_vert_visc(st, mesh, cfg, fo, u_rhs, v_rhs)
        results["momentum"] = _time_fn(ph_momentum, (state, forcing), n,
                                       sync)

        def ph_ssh(st, fo):
            _, u_rhs, v_rhs = dynamics.compute_vel_rhs(st, mesh, fo, cfg)
            rhs = ssh.compute_ssh_rhs(st, mesh, cfg, fo, u_rhs, v_rhs)
            if model.ssh_dense_inv is not None:
                return ssh.solve_ssh_dense(st, mesh, cfg, model.ssh_dense_inv,
                                           rhs)[0]
            pc = model.ssh_block_pc
            if pc is None:
                dinv = model.ssh_diag_inv
                pc = lambda r: dinv * r
            return ssh.solve_ssh(st, mesh, cfg, pc, rhs, model.ssh_ring,
                                 x0=st.d_eta)[0]
        # warm-start the profiled solve like real stepping does: one
        # priming solve feeds its d_eta back as x0 (a cold-start solve runs
        # more CG iterations than steady stepping)
        state_warm = dataclasses.replace(state, d_eta=ph_ssh(state, forcing))
        ssh_with_mom = _time_fn(ph_ssh, (state_warm, forcing), n, sync)

        # subtract the momentum-rhs prelude cost
        def ph_velrhs(st, fo):
            return dynamics.compute_vel_rhs(st, mesh, fo, cfg)[1:]
        velrhs = _time_fn(ph_velrhs, (state, forcing), n, sync)
        results["ssh_solve"] = max(ssh_with_mom - velrhs, 0.0)

        def ph_wvel(st, fo):
            return ale.vert_vel_ale(st, mesh, cfg, fo).w
        results["vert_vel"] = _time_fn(ph_wvel, (state, forcing), n, sync)

        def ph_tracer(st, fo):
            return solve_tracers(st, mesh, cfg, model.tracer_statics, fo,
                                 0.0 if cfg.ale.which_ALE == "linfs"
                                 else 1.0).tr
        results["tracers"] = _time_fn(ph_tracer, (state, forcing), n, sync)

        # --- ice phases --------------------------------------------------
        if cfg.run.use_ice:
            surf = ice_cpl.ocean2ice(state, mesh)
            use_virt_salt = cfg.ale.which_ALE == "linfs"

            def ph_ice(st_ice):
                return ice_timestep(st_ice, mesh, ice_forcing, surf, cfg,
                                    use_virt_salt, sub=model.ice_sub)
            results["ice_total"] = _time_fn(ph_ice, (ice,), n, sync)

            def ph_evp(st_ice):
                return ice_dynamics(st_ice, mesh, ice_forcing, surf, cfg,
                                    sub=model.ice_sub).u_ice
            results["ice_evp"] = _time_fn(ph_evp, (ice,), n, sync)

    results["sum_of_phases"] = sum(v for k, v in results.items()
                                   if k in PHASES)
    if verbose:
        for k, v in results.items():
            print(f"  {k:18s}: {v * 1e3:9.2f} ms")
    return results
