#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fesom2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each reported on its own line:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the hand-written CUDA kernels from ``fesom2_tpu_torch/csrc``;
3. each kernel against its plain torch version on the card, at the
   shapes of the soufflet step, in float64 (within 1e-12 of max|plain|)
   and float32 (1e-5); fct_bounds bitwise; then both timed with CUDA
   events (median of 30 after warm-up);
4. 20 float64 steps of the soufflet channel (2,875 nodes, 40 layers)
   through ``run.run_soufflet``, with sanity bounds, linfs volume
   conservation and a launch count above 0 for every kernel;
5. 5 float64 steps on the card (kernels) against 5 on the CPU (plain
   versions) from the same state, within 1e-9 of max|CPU|;
6. setup seconds, then throughput of 30 float32 and 30 float64 steps
   after 2 warm-up steps, alternately and twice each, and a profile of 5
   float32 steps (information, not a gate).

Any failure exits non-zero before the last line.  The last line is
``{"ok": true, "device": {...}}``.  It needs one card and exits non-zero
where CUDA is not available.
"""
import json
import subprocess
import sys
import time


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str):
    print(msg, flush=True)


def timed(fn, reps: int = 30, warmup: int = 5):
    """Median milliseconds of fn() on the card, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_kernels(prof):
    """The CUDA kernel events of a profile, without the device-side copies
    of ``record_function`` spans (the ``step.*`` annotations)."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.key.startswith("step.")]


def device_us(fn, calls: int = 20) -> str:
    """Device time per call of fn(): the summed self time of the CUDA
    kernels it launches, from torch.profiler, over ``calls`` calls."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in device_kernels(prof)) / calls
    # the profiler has been seen to drop every kernel event of a run
    return f"{us:.2f}" if us > 0 else "not measured"


def max_abs(a, b):
    return float((a - b).abs().max())


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA GPU")
    # the port, from the checkout this script lies in
    import numpy as np
    from fesom2_tpu_torch import kernels
    from fesom2_tpu_torch.kernels import build
    from fesom2_tpu_torch.core import ops, tracers
    from fesom2_tpu_torch.model import setup_soufflet_model
    from fesom2_tpu_torch.run import run_soufflet

    # phase 1 ------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    say(f"phase 1 card: {card} | torch {torch.__version__} | "
        f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # phase 2 ------------------------------------------------------------
    t0 = time.perf_counter()
    path = build.build()
    kernels.library()
    say(f"phase 2 build: {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in build.ptxas_report().splitlines():
        say(f"  {line.strip()}")

    # phase 3 ------------------------------------------------------------
    model64 = setup_soufflet_model(device=dev, dtype=torch.float64)
    mesh64 = model64.mesh
    N, E, Ed, L = mesh64.n_nodes, mesh64.n_elems, mesh64.n_edges, mesh64.nl - 1
    say(f"phase 3 mesh: N={N} E={E} Ed={Ed} layers={L} "
        f"K={mesh64.nod_in_elem.shape[1]} KE={mesh64.node_edges.shape[1]}")
    rng = np.random.default_rng(20261016)
    meshes = {torch.float64: mesh64,
              torch.float32: setup_soufflet_model(device=dev,
                                                  dtype=torch.float32).mesh}

    def rand(*shape, lo=-1.0, hi=1.0, dtype=torch.float64):
        return torch.as_tensor(rng.uniform(lo, hi, shape), device=dev).to(dtype)

    def cases(dtype, mesh):
        """(kernel, label, wrapper call, plain call, exact) at the slice's
        shapes."""
        out = []
        for R in ((), (L,), (2, L)):
            f = rand(*R, Ed, dtype=dtype)
            out.append(("node_edge_reduce", f"div {list(f.shape)}",
                        lambda f=f: ops.edge_divergence(f, mesh),
                        lambda f=f: ops.edge_divergence_plain(f, mesh), False))
        f = rand(2, L, Ed, dtype=dtype)
        out.append(("node_edge_reduce", f"pair {list(f.shape)}",
                    lambda: ops.edge_signed_reduce2(f, mesh),
                    lambda: ops.edge_signed_reduce2_plain(f, mesh), False))
        xs = rand(2, E, dtype=dtype)
        out.append(("elem_to_node_mean", f"flat {list(xs.shape)}",
                    lambda: ops.elem_to_node_mean_flat(xs, mesh),
                    lambda: ops.elem_to_node_mean_flat_plain(xs, mesh), False))
        for shape, lev in (((2, L, E), True), ((2, L, E), False),
                           ((2, 2, L, E), True)):
            x = rand(*shape, dtype=dtype)
            out.append(("elem_to_node_mean", f"levels={lev} {list(shape)}",
                        lambda x=x, lev=lev: ops.elem_to_node_mean(x, mesh, lev),
                        lambda x=x, lev=lev: ops.elem_to_node_mean_plain(
                            x, mesh, lev), False))
        for X in (N, E):
            a = rand(L, X, lo=-0.4, hi=0.0, dtype=dtype)
            c = rand(L, X, lo=-0.4, hi=0.0, dtype=dtype)
            b = rand(L, X, lo=1.0, hi=2.0, dtype=dtype)
            d = rand(2, L, X, dtype=dtype)
            out.append(("tridiag_solve", f"a,b,c {[L, X]} d {[2, L, X]}",
                        lambda a=a, b=b, c=c, d=d: ops.tridiag_solve(a, b, c, d),
                        lambda a=a, b=b, c=c, d=d: ops.tridiag_solve_plain(
                            a, b, c, d), False))
        ttf = rand(2, L, N, lo=0.0, hi=30.0, dtype=dtype)
        lo_ = rand(2, L, N, lo=0.0, hi=30.0, dtype=dtype)
        out.append(("fct_bounds", f"ttf,lo {[2, L, N]}",
                    lambda: tracers.fct_bounds(ttf, lo_, mesh),
                    lambda: tracers.fct_bounds_plain(ttf, lo_, mesh), True))
        return out

    summary = {k: {"max_abs_err": 0.0} for k in kernels.KERNELS}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        tag = str(dtype).replace("torch.", "")
        for name, label, kern, plain, exact in cases(dtype, meshes[dtype]):
            got, want = kern(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(max_abs(g, w) for g, w in zip(got, want))
            scale = max(float(w.abs().max()) for w in want)
            if exact:
                ok = all(torch.equal(g, w) for g, w in zip(got, want))
            else:
                ok = err <= tol * scale
            if not ok or not all(torch.isfinite(g).all() for g in got):
                fail(f"{name} {label} {tag}: kernel vs plain max abs err "
                     f"{err:.3e} (scale {scale:.3e}, tol "
                     f"{'bitwise' if exact else tol})")
            k_ms = timed(kern)
            p_ms = timed(plain)
            say(f"phase 3 {name:18s} {tag} {label:34s} max_abs_err={err:.3e} "
                f"kernel_us={k_ms * 1e3:.1f} plain_us={p_ms * 1e3:.1f} "
                f"device: kernel_us={device_us(kern)} "
                f"plain_us={device_us(plain)}")
            if dtype == torch.float64:
                s = summary[name]
                s["max_abs_err"] = max(s["max_abs_err"], err)
                # the largest shape of each kernel on the main path is timed
                # last among its f64 cases
                s["ms"], s["plain_ms"] = k_ms, p_ms

    # a NaN in ttf must spread through fct_bounds as through torch.maximum
    for dtype in (torch.float64, torch.float32):
        mesh = meshes[dtype]
        ttf = rand(2, L, N, lo=0.0, hi=30.0, dtype=dtype)
        lo_ = rand(2, L, N, lo=0.0, hi=30.0, dtype=dtype)
        ttf[0, L // 2, N // 2] = float("nan")
        got = tracers.fct_bounds(ttf, lo_, mesh)
        want = tracers.fct_bounds_plain(ttf, lo_, mesh)
        n_nan = [int(w.isnan().sum()) for w in want]
        same = all(torch.equal(g.isnan(), w.isnan())
                   and torch.equal(g[~g.isnan()], w[~w.isnan()])
                   for g, w in zip(got, want))
        say(f"phase 3 fct_bounds NaN input {dtype}: NaN outputs {n_nan}, "
            f"kernel equals plain: {same}")
        if not same or min(n_nan) == 0:
            fail("phase 3: fct_bounds does not propagate NaN as plain does")

    # phase 4 ------------------------------------------------------------
    kernels.reset_launches()
    model, state, timers = run_soufflet(20, model=model64, verbose=False)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    say(f"phase 4 soufflet 20 steps float64: {timers.step:.3f} s stepping, "
        f"launches {launches}")
    m = model.mesh
    nmask = m.node_layer_mask
    for name in ("u", "v", "eta", "hbar", "tr", "w"):
        if not torch.isfinite(getattr(state, name)).all():
            fail(f"phase 4: {name} is not finite")
    umax = float(state.u.abs().max())
    etamax = float(state.eta.abs().max())
    T = state.tr[0][nmask]
    a = m.area[0]
    hbar_int = float((state.hbar * a).sum() / a.sum())
    say(f"phase 4 |u|max={umax:.4f} |eta|max={etamax:.4f} "
        f"T=[{float(T.min()):.4f}, {float(T.max()):.4f}] "
        f"mean hbar={hbar_int:.3e}")
    if not (umax < 3.0 and etamax < 2.0 and float(T.min()) > 0.0
            and float(T.max()) < 26.0):
        fail("phase 4: fields outside the sanity bounds")
    if abs(hbar_int) >= 1e-6:
        fail(f"phase 4: area-mean hbar {hbar_int:.3e} (linfs volume)")
    idle = [k for k, v in launches.items() if v <= 0]
    if idle:
        fail(f"phase 4: kernels never launched on the main path: {idle}")

    # phase 5 ------------------------------------------------------------
    model_cpu = setup_soufflet_model(device="cpu", dtype=torch.float64)
    s_gpu = model64.initial_state()
    s_cpu = model_cpu.initial_state()
    _, s_gpu, _ = run_soufflet(5, model=model64, state=s_gpu, verbose=False)
    _, s_cpu, _ = run_soufflet(5, model=model_cpu, state=s_cpu, verbose=False)
    for name in ("u", "v", "eta", "hbar", "tr"):
        ref = getattr(s_cpu, name)
        rel = max_abs(getattr(s_gpu, name).cpu(), ref) / float(ref.abs().max())
        say(f"phase 5 card vs cpu {name}: {rel:.3e} of max|cpu|")
        if not rel <= 1e-9:
            fail(f"phase 5: {name} card vs CPU {rel:.3e} > 1e-9")

    # phase 6 ------------------------------------------------------------
    # the step is host-bound, so its rate drifts with the shared host: the
    # two dtypes are measured alternately, twice each
    runs = {}
    for dtype in (torch.float32, torch.float64):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mdl = setup_soufflet_model(device=dev, dtype=dtype)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        st = mdl.initial_state()
        _, st, _ = run_soufflet(2, model=mdl, state=st, verbose=False)
        runs[dtype] = [mdl, st]
        say(f"phase 6 setup {str(dtype).replace('torch.', '')}: {setup_s:.3f} s "
            f"(mesh tables, tracer statics, dense SSH inverse)")
    for _ in range(2):
        for dtype, run in runs.items():
            mdl, st = run
            torch.cuda.synchronize()
            n = 30
            t0 = time.perf_counter()
            _, st, _ = run_soufflet(n, model=mdl, state=st, verbose=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run[1] = st
            if not torch.isfinite(st.eta).all():
                fail("phase 6: eta is not finite")
            wet = int(mdl.mesh.node_layer_mask.sum())
            say(f"phase 6 throughput {str(dtype).replace('torch.', '')}: "
                f"{n / wall:.3f} steps/s, {wet * n / wall:.6e} wet "
                f"node-levels/s ({wet} wet node-levels; {card})")
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    mdl, st = runs[torch.float32]
    torch.cuda.synchronize()
    n = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, st, _ = run_soufflet(n, model=mdl, state=st, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = device_kernels(prof)
    dev_us = sum(e.self_device_time_total for e in kern)
    say(f"phase 6 profile float32 {n} steps: wall {wall * 1e3:.1f} ms, device "
        f"kernel time {dev_us / 1e3:.1f} ms, busy share "
        f"{dev_us / 1e3 / (wall * 1e3):.3f}, kernels launched "
        f"{sum(e.count for e in kern) / n:.0f}/step ({card})")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        say(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")
    for e in sorted((e for e in prof.key_averages()
                     if e.key.startswith("step.")
                     and e.device_type == DeviceType.CPU), key=lambda e: e.key):
        say(f"phase 6 span {e.key:14s} host {e.cpu_time_total / 1e3 / n:8.3f} "
            f"ms/step")

    # result -------------------------------------------------------------
    sources = {"node_edge_reduce": "fesom2_tpu/core/ops.py:154",
               "elem_to_node_mean": "fesom2_tpu/core/ops.py:328",
               "tridiag_solve": "fesom2_tpu/core/ops.py:389",
               "fct_bounds": "fesom2_tpu/core/tracers.py:584"}
    say(json.dumps({"kernels": [
        {"name": k, "route": "cuda",
         "source": f"fesom2_tpu_torch/csrc/{k}.cu",
         "replaces": sources[k], "launches": launches[k],
         "max_abs_err": summary[k]["max_abs_err"],
         "ms": summary[k]["ms"], "plain_ms": summary[k]["plain_ms"]}
        for k in kernels.KERNELS]}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
