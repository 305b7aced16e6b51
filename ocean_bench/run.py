"""One run of one benchmark cell of the PyTorch/CUDA port.

    python -m ocean_bench.run --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout.  The cell (``BENCHMARK.json``: a
configuration and a traffic mix, found by name under ``ocean_bench/``) is
run through the port's own time loop, ``fesom2_tpu_torch.run.run_pi``:

1. set-up: the kernel library (built once into ``build/fesom2_tpu_torch/``
   of the checkout), the configuration's globe mesh (written once into
   ``build/ocean_bench/``; it has no seed), ``setup_pi_model`` on the card,
   the initial state and atmosphere from the seed, and two warm-up calls
   of ``steps_per_call`` steps each (step 0 onward; the first is checked);
2. the window: successive ``run_pi`` calls of ``steps_per_call`` steps,
   ``first_step`` carrying on, until the first call boundary after
   ``--seconds``; every call ends in ``run_pi``'s own host read of its
   blowup flag, so the window's clock stops on finished work;
3. with ``--trace 1``, one step under the profiler to start it up, then a
   profiled stretch of ``profile_steps`` more steps (one call) for the
   per-layer metrics;
4. the check (``check.py``): the plain reference against the first
   warm-up call and against the window's last call;
5. the result: one JSON line, last on standard output; the numbers
   compared, each beside its limit, last on standard error.

It exits with 2, and prints no result, where CUDA is missing or has fewer
cards than the cell asks for, and where JAX or the JAX package is loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse        # noqa: E402
import gc              # noqa: E402
import json            # noqa: E402
import re              # noqa: E402
import subprocess      # noqa: E402
import sys             # noqa: E402
import tempfile        # noqa: E402

from . import spec     # noqa: E402

# top-level module names that may not be loaded in the process
BANNED = ("jax", "jaxlib", "flax", "fesom2_tpu")


class Refused(Exception):
    """A run that may print no result."""


def banned_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in BANNED)


def mesh_dir(cell, level=None):
    """The configuration's globe mesh files, written once into a fixed
    directory of the checkout by the reference's frozen mesh generator
    (``write_globe``: ``level`` and its other options, such as
    ``n_layers`` or ``shelf``, from the configuration's ``mesh``)."""
    m = dict(cell.config["mesh"])
    if m.pop("generator") != "globe":
        raise ValueError(f"unknown mesh generator {cell.config['mesh']}")
    lev = m.pop("level")
    lev = level if level is not None else lev
    name = "_".join([f"globe_l{lev}"] + [f"{k}{v}" for k, v in
                                          sorted(m.items())])
    d = spec.ROOT / "build" / "ocean_bench" / name
    if not (d / "done").exists():
        from .reference.fesom.mesh.globe import write_globe
        d.mkdir(parents=True, exist_ok=True)
        write_globe(str(d), level=lev, **m)
        (d / "done").write_text("written\n")
    return d


class _Lines(list):
    """Lines for standard error, printed as they come where ``echo``."""

    def __init__(self, echo: bool):
        super().__init__()
        self.echo = echo

    def append(self, line: str) -> None:
        super().append(line)
        if self.echo:
            print(line, file=sys.stderr, flush=True)


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return res.stdout.strip().splitlines()[0] if res.returncode == 0 \
            else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


class Program:
    """The program under test for one cell: its model on the device, the
    seed's inputs and one call of its own time loop (``run.run_pi``), as a run
    makes them.  Only the atmosphere and the initial state depend on the
    seed (``reseed``)."""

    def __init__(self, cell, device, seed: int, level=None,
                 result_path=None):
        import torch
        from fesom2_tpu_torch.model import pi_config, setup_pi_model
        phys, traffic = cell.config["physics"], cell.traffic
        self.cell = cell
        self.mdir = mesh_dir(cell, level)
        cfg = pi_config(phys["parity"], phys["step_per_day"])
        spec.apply_config(cfg, cell)
        self.model, _ = setup_pi_model(
            str(self.mdir), device=device, dtype=getattr(torch, phys["dtype"]),
            cfg=cfg, atm_seed=seed)
        self.kw = dict(logfile_outfreq=int(traffic["steps_per_call"]))
        icepack = cell.config.get("icepack")
        if icepack is not None:
            from fesom2_tpu_torch.ice.icepack import IcepackConfig
            opts = dict(icepack.get("opts", {}))
            spec.check_icepack(IcepackConfig(**opts), cell)
            self.kw.update(use_icepack=True, icepack_opts=opts)
        if result_path is not None:
            self.kw.update(result_path=result_path,
                           restart_every=traffic.get("restart_every"),
                           stream_defs=None if traffic.get("output_streams")
                           == "default" else [])
        self.reseed(seed)

    def reseed(self, seed: int) -> None:
        from fesom2_tpu_torch.model import globe_atm_data
        self.seed = seed
        self.atm = globe_atm_data(self.model, seed,
                                  n_records=self.cell.traffic["atm_records"])

    def initial(self):
        """(state, ice) of the seed (``pi_initial_state``)."""
        from fesom2_tpu_torch.model import pi_initial_state
        return pi_initial_state(self.model, seed=self.seed)

    def call(self, out, first: int, n: int):
        """One ``run_pi`` call: (state, ice[, ipk]) -> the same after n
        steps from step index ``first``."""
        from fesom2_tpu_torch.run import run_pi
        ipk = out[2] if len(out) > 2 else None
        return run_pi(self.model, self.atm, out[0], out[1], n,
                      first_step=first, ipk=ipk, **self.kw)


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", level=None, echo: bool = False) -> tuple:
    """Run the cell once; returns (result dict, lines for standard error,
    the last of them the numbers compared).  With ``echo`` each line but
    those is also printed to standard error as it comes.  ``device`` and
    ``level`` serve the CPU tests (a small globe)."""
    import torch
    from fesom2_tpu_torch import kernels
    from . import check, trace as tr, work

    info = _Lines(echo)
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    traffic = cell.traffic
    dtype = getattr(torch, cell.config["physics"]["dtype"])
    c = int(traffic["steps_per_call"])
    out_dir = None
    if traffic.get("output_streams") or traffic.get("restart_every"):
        out_dir = tempfile.TemporaryDirectory(prefix="ocean_bench_")
    t = time.perf_counter()
    prog = Program(cell, dev, seed, level,
                   None if out_dir is None else out_dir.name)
    model, mdir, call = prog.model, prog.mdir, prog.call
    state, ice = prog.initial()
    info.append(f"setup mesh, setup_pi_model and inputs "
                f"{time.perf_counter() - t:.3f} s")

    # the warm-up: two calls, the first of them checked; the second holds
    # as many states as the window does, so the window allocates nothing new
    t = time.perf_counter()
    first = call((state, ice), 0, c)
    sync()
    t1 = time.perf_counter()
    out = call(first, c, c)
    sync()
    info.append(f"setup warm-up calls of {c} steps {t1 - t:.3f} s, "
                f"{time.perf_counter() - t1:.3f} s")

    # the window
    k0 = k = 2 * c
    failed, error, last, calls = 0, None, None, []
    t_window = time.perf_counter()
    setup_s = t_window - T_START
    while True:
        before = out
        try:
            out = call(out, k, c)
        except RuntimeError as exc:
            m = re.search(r"blowup detected at step (\d+)", str(exc))
            if m is None:
                raise
            failed, error = k + c - int(m.group(1)) + 1, str(exc)
            k += c
            break
        last = (k, before, out)
        k += c
        calls.append(time.perf_counter() - t_window)
        if calls[-1] >= seconds:
            break
    window_s = time.perf_counter() - t_window
    attempted = k - k0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    dt = model.cfg.dt
    sypd = attempted * dt / (365.0 * window_s)
    wet_levels = int(model.mesh.node_layer_mask.sum())
    info.append(f"window {attempted} steps in {window_s:.6f} s: "
                f"{attempted / window_s:.4f} steps/s, "
                f"{wet_levels * attempted / window_s:.6e} wet node-levels/s; "
                f"s a call: " + " ".join(
                    f"{b - a:.3f}" for a, b in zip([0.0] + calls, calls)))

    readings = None
    if trace and error is None:
        from torch.profiler import ProfilerActivity, profile
        n_prof = int(traffic["profile_steps"])
        iters, launches = [], []
        hook = model.register_forward_hook(
            lambda m, i, o: iters.append(int(m.ssh_iters)))
        launch = kernels.launch

        def recorded(name, device_, *args, entry=""):
            launches.append((name, entry, args))
            return launch(name, device_, *args, entry=entry)

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        # one step under a profiler of its own first: the profiler's own
        # start-up stays out of the stretch that is read
        with profile(activities=acts):
            out = call(out, k, 1)
            sync()
        iters.clear()
        kernels.launch = recorded
        try:
            with profile(activities=acts) as prof:
                t = time.perf_counter()
                call(out, k + 1, n_prof)
                sync()
                stretch_s = time.perf_counter() - t
        finally:
            kernels.launch = launch
            hook.remove()
        readings = tr.readings_from_profile(prof, n_prof, stretch_s)
        del prof
        readings.ssh_iters = iters
        readings.launches = [(name, work.launch_work(name, entry, args))
                             for name, entry, args in launches]
        del launches
        readings.window_step_s = window_s / max(attempted, 1)
        readings.config, readings.traffic = cell.config, traffic

    # the program's answers to the host, then its state freed
    first_snap = check.snapshot(*first)
    last_snap = None if last is None else (
        last[0], check.snapshot(*last[1]), check.snapshot(*last[2]))
    del prog, model, state, ice, first, out, before, last
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    limits = cell.config.get("limits", {})
    checks = {}
    if last_snap is not None:
        t = time.perf_counter()
        got = check.judge(str(mdir), cell, seed, dev, dtype, first_snap,
                          last_snap)
        numbers = [n for n in got if n.endswith("_gap")]
        info.append(f"check: the reference took {time.perf_counter() - t:.3f}"
                    f" s (set-up {got['setup_s']:.3f}, {2 * c} steps "
                    f"{got['steps_s']:.3f}); widest gaps in " + ", ".join(
                        f"{got[n][1]} ({n})" for n in numbers))
        for name in numbers:
            checks[name] = {"value": got[name][0],
                            "limit": limits.get(name)}
        sizes = got["sizes"]
    correct = (error is None and bool(checks) and all(
        v["limit"] is not None and v["value"] <= v["limit"]
        for v in checks.values()))

    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": cell.chips, "memory_peak_bytes": int(peak)}
    metrics = {}
    breakdown = None
    if not trace:
        values = {"sypd": sypd, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    elif readings is not None:
        readings.sizes = sizes if checks else {}
        readings.itemsize = torch.empty((), dtype=dtype).element_size()
        readings.card = power_limit()
        for m in cell.per_layer:
            value = spec.load_reader(m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        for line in readings.notes:
            info.append(line)
        busy = tr.union_us(readings.device_ops) / 1e6
        device_info.update(busy_s=busy, window_s=readings.stretch_s)
        breakdown = tr.breakdown(readings)
        info.append(f"traced: {readings.n_steps} steps in "
                    f"{readings.stretch_s:.6f} s, device busy {busy:.6f} s, "
                    f"CG iterations {readings.ssh_iters}; card "
                    f"{readings.card}")
    if error is not None:
        info.append(f"blowup: {error[:1500]}")
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    if out_dir is not None:
        out_dir.cleanup()
    info.echo = False
    for name, v in checks.items():
        info.append(f"check {name} {v['value']!r} limit {v['limit']!r}")
    if not checks:
        info.append("check: no call of the window finished, nothing "
                    "compared")
    return result, info


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    try:
        cell = spec.cell(args.workload)
        import torch
        if not torch.cuda.is_available():
            raise Refused("CUDA is not available")
        if torch.cuda.device_count() < cell.chips:
            raise Refused(f"{torch.cuda.device_count()} CUDA devices, the "
                          f"cell asks for {cell.chips}")
        result, info = run_cell(cell, args.seed, args.seconds,
                                bool(args.trace), echo=True)
        found = banned_modules()
        if found:
            raise Refused(f"loaded in the process: {found}")
    except (Refused, KeyError, FileNotFoundError, ImportError) as exc:
        print(f"ocean_bench: no result: {exc!r}", file=sys.stderr)
        return 2
    sys.stdout.flush()
    for line in info:
        if line.startswith("check "):
            print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
