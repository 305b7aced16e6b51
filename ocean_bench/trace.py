"""What the benchmark reads from a ``torch.profiler`` trace of a few steps:
the device's operations, the device-side and host-side ``step.*`` spans,
the busy time, the idle gaps and the breakdown of a traced result line.

Times are microseconds on the profiler's clock, on which host and device
events lie together.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Readings:
    """Everything a per-layer metric's reader may read (``metrics/*.py``).

    ``kernels``: the CUDA kernels of the profiled steps, (name, start, end);
    ``device_ops``: those and the copies and fills, (name, start, end);
    ``dev_spans`` / ``host_spans``: the ``step.*`` spans on the device's and
    the host's timeline, (name, start, end); ``stretch_s``: the profiled
    stretch's wall seconds; ``n_steps``: its steps; ``ssh_iters``: the
    program's CG iterations after each of its steps; ``launches``: the
    hand-written kernels' launches, (name, (bytes, flops, itemsize) or
    None) from ``work.launch_work``; ``window_step_s``: the untraced window's
    seconds a step in this run; ``sizes``: the configuration's sizes from
    its mesh files (``check.mesh_sizes``); ``config`` and ``traffic``: the
    cell's files; ``itemsize``: bytes of the configuration's float;
    ``card``: the card's name and power limit as nvidia-smi reads them;
    ``notes``: lines a reader leaves for the run's standard error."""
    n_steps: int
    kernels: list
    device_ops: list
    dev_spans: list
    host_spans: list
    stretch_s: float
    ssh_iters: list = field(default_factory=list)
    launches: list = field(default_factory=list)
    window_step_s: float = 0.0
    sizes: dict = field(default_factory=dict)
    config: dict = field(default_factory=dict)
    traffic: dict = field(default_factory=dict)
    itemsize: int = 8
    card: Optional[str] = None
    notes: list = field(default_factory=list)


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def readings_from_profile(prof, n_steps: int, stretch_s: float) -> Readings:
    """The device operations and ``step.*`` spans of a finished profile."""
    from torch.autograd import DeviceType
    kernels, ops, dev_spans, host_spans = [], [], [], []
    for e in prof.events():
        tr = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith("step."):
                dev_spans.append(tr)
            else:
                ops.append(tr)
                if not _is_copy(e.name):
                    kernels.append(tr)
        elif e.name.startswith("step."):
            host_spans.append(tr)
    return Readings(n_steps=n_steps, kernels=kernels, device_ops=ops,
                    dev_spans=dev_spans, host_spans=host_spans,
                    stretch_s=stretch_s)


def span_device_ms(kernels: list, dev_spans: list, n: int,
                   counts: Optional[dict] = None) -> dict:
    """Device ms a step of the kernels under each ``step.*`` span: a kernel
    belongs to the innermost span whose device-side range holds its start;
    kernels outside every span count as "outside spans".  With a dict
    ``counts``, also fills it with the kernels a step under each span.

    Frozen copy of ``chip_smoke.py:492-526`` (``span_device_ms``) at git
    e5ef625, reading (name, start, end) tuples in place of the profiler's
    events."""
    spans = sorted(dev_spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    out = {}
    for name_k, start, end in kernels:
        # the innermost span that holds the kernel's start: the latest
        # started of those that hold it (spans nest or are disjoint)
        i = bisect.bisect_right(starts, start) - 1
        name = "outside spans"
        while i >= 0:
            if start < spans[i][2]:
                name = spans[i][0]
                break
            i -= 1
        out[name] = out.get(name, 0.0) + (end - start)
        if counts is not None:
            counts[name] = counts.get(name, 0) + 1 / n
    return {k: v / 1e3 / n for k, v in sorted(out.items(),
                                              key=lambda kv: -kv[1])}


def union_us(intervals: list) -> float:
    """Microseconds covered by the union of (name, start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for _, s, e in sorted(intervals, key=lambda t: t[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(ops: list, host_spans: list) -> list:
    """The device's idle gaps between its first and last operation, as
    (host span, seconds), longest first: each named by the innermost
    host-side ``step.*`` span that holds the gap's start ("outside spans"
    where none does)."""
    gaps, cur_e = [], None
    for _, s, e in sorted(ops, key=lambda t: t[1]):
        if cur_e is not None and s > cur_e:
            gaps.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    spans = sorted(host_spans, key=lambda t: t[1])
    starts = [t[1] for t in spans]
    out = []
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0) - 1
        name = "outside spans"
        while i >= 0:
            if g0 < spans[i][2]:
                name = spans[i][0]
                break
            i -= 1
        out.append((name, (g1 - g0) / 1e6))
    return sorted(out, key=lambda t: -t[1])


def breakdown(r: Readings, top: int = 10) -> dict:
    """The traced line's breakdown: the device operations that took most
    time in the profiled stretch (seconds, summed by name) and its longest
    idle gaps on the device (named by what the host was doing)."""
    by_name = {}
    for name, s, e in r.device_ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:200], v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in
                          idle_gaps(r.device_ops, r.host_spans)[:top]]}
