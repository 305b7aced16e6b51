"""What the kernel timing scripts share: the card's name, CUDA-event and
profiler timers, bit-for-bit comparison and digests of outputs, and the
loop that holds each case against its plain version, times it and prints
one JSON object per case.

A script that compares two checkouts in turns runs as a file with the other
checkout leading ``PYTHONPATH``; it then imports this module from its own
directory (``import timing``), not from the package on the path.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import subprocess
from typing import Callable

import torch


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]


def events_ms(fn, reps: int, warmup: int = 5) -> float:
    """Median milliseconds of single calls of fn(), each between a pair of
    CUDA events, after ``warmup`` calls."""
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
    return sorted(times)[len(times) // 2]


def batch_ms(fn, calls: int = 20, batches: int = 1) -> float:
    """Median over ``batches`` of the milliseconds a call of fn() takes,
    ``calls`` calls between one pair of CUDA events: the device's time
    where a call outlasts its enqueue, the host's enqueue rate where it
    does not.  ``torch.profiler``'s device times drift late in a long
    process; a batch between two events does not."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return sorted(times)[len(times) // 2]


def kernel_us(fn, name, calls: int = 20, flush=None) -> float:
    """Device microseconds per call of the CUDA kernels of fn() whose name
    holds ``name`` (or any of a tuple of names), from torch.profiler;
    ``flush`` (a large tensor) is overwritten before every call, so each
    call finds a cold L2."""
    names = (name,) if isinstance(name, str) else tuple(name)
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    fn()
    torch.cuda.synchronize()
    for _ in range(3):                  # a dropped trace is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                if flush is not None:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and any(n in e.key for n in names)) / calls
        if us > 0:
            return us
    return float("nan")


def load_checkout_library(root: str):
    """Build (if needed) and load the kernel library of the checkout at
    ``root`` from its own sources, beside this checkout's; the caller sets
    the argument types of the entries it calls."""
    import ctypes
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "checkout_kernels_build",
        Path(root) / "fesom2_tpu_torch" / "kernels" / "build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return ctypes.CDLL(str(mod.build()))


def build_source_variant(source: str, name: str, replacements,
                         out_dir) -> tuple:
    """(library path, ptxas lines) of the package's ``csrc/<source>`` with
    each (old, new) of ``replacements`` replaced (one that no longer
    matches the source raises), built alone with the package's nvcc flags
    into ``out_dir/lib<name>.so``; raises with the compiler's output on
    failure."""
    from pathlib import Path
    from fesom2_tpu_torch.kernels import build
    src = (build.SRC_DIR / source).read_text()
    for old, new in replacements:
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} not in {source}")
        src = src.replace(old, new)
    out_dir = Path(out_dir)
    cu, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    cu.write_text(src)
    res = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS,
                          f"-I{build.SRC_DIR}", "-shared", "-o", str(lib),
                          str(cu)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"variant {name}: nvcc failed\n{res.stderr}")
    return lib, [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
                 if "registers" in ln or "spill" in ln or "stack" in ln]


def device_kernels_us(fn, calls: int = 10) -> dict:
    """Device microseconds per call of each CUDA kernel fn() launches."""
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / calls
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def as_tuple(x) -> tuple:
    """A call's outputs as a tuple, without the None entries."""
    return tuple(v for v in x if v is not None) if isinstance(x, tuple) \
        else (x,)


def same_bits(a, b) -> bool:
    """Equal bit for bit, NaN where the other is NaN."""
    return bool(torch.equal(a.isnan(), b.isnan())
                and torch.equal(a.nan_to_num(), b.nan_to_num()))


def digest(outs) -> str:
    """The first 16 hex digits of the SHA-256 of the outputs' bytes."""
    h = hashlib.sha256()
    for o in outs:
        h.update(o.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class Case:
    """One call to time: the kernel's wrapper, its plain version, whether
    the two must agree bit for bit (else within the tolerance of
    max|plain|), the JSON fields that name the case, and its ``*_work``
    counter where the script prices it against the bound."""
    kern: Callable
    plain: Callable
    exact: bool
    fields: dict
    work: object = None


def run_cases(cases, tol: float, timings: Callable, **common) -> bool:
    """Hold each case against its plain version, time it with
    ``timings(case) -> dict`` and print one JSON object per case with
    ``common``; False at the first case that disagrees."""
    for c in cases:
        got, want = as_tuple(c.kern()), as_tuple(c.plain())
        torch.cuda.synchronize()
        bitwise = all(same_bits(g, w) for g, w in zip(got, want))
        rel = 0.0 if bitwise else max(
            float((g - w).abs().max()) / max(float(w.abs().max()), 1e-300)
            for g, w in zip(got, want))
        ok = bitwise if c.exact else rel <= tol
        print(json.dumps({**common, **c.fields, "agrees": ok,
                          "bitwise": bitwise, "rel_err": rel,
                          "sha256": digest(got), **timings(c)}), flush=True)
        if not ok:
            return False
    return True
