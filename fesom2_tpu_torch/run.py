"""Run driver for the port: setup -> time loop -> norms and timing.

    python -m fesom2_tpu_torch.run soufflet --steps N --device cuda \\
        [--f32] [--mesh DIR]

The port of ``fesom2_tpu/run.py:run_soufflet``.  ``--device`` defaults to
cuda and raises where CUDA is missing; the CPU runs only when asked for
with ``--device cpu``.  Without ``--mesh`` the default code-built channel
is used (``mesh/channel.py``).  Output streams are not ported yet
(ROADMAP queue 1 item 20).
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from .core.state import OceanState, zero_forcing
from .mesh import MeshTables
from .model import Model, setup_soufflet_model


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


def step_info(state: OceanState, mesh: MeshTables) -> Dict[str, float]:
    """Global min/max norms of the prognostic fields."""
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
    return dict(zip(names, vals.tolist()))


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


def main(argv=None):
    p = argparse.ArgumentParser(description="fesom2_tpu_torch run driver")
    p.add_argument("config", choices=["soufflet"])
    p.add_argument("--steps", type=int, default=72)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; the CPU only when asked)")
    p.add_argument("--f32", action="store_true")
    p.add_argument("--mesh", default=None,
                   help="FESOM mesh directory (default: code-built channel)")
    args = p.parse_args(argv)
    dtype = torch.float32 if args.f32 else torch.float64
    run_soufflet(args.steps, device=args.device, dtype=dtype,
                 mesh_path=args.mesh)


if __name__ == "__main__":
    main()
