"""device_idle_share: the share of the untraced window's time a step in
which no operation ran on the card, in percent: 1 - (the union of the
device's operations in the profiled steps, a step) / (the window's seconds
a step).  The device's work a step comes from the trace; the time a step
from the window, which runs without the profiler, so the profiler's own
host cost stays out."""
from ocean_bench.trace import union_us


def read(r):
    if not r.device_ops or r.n_steps <= 0 or r.window_step_s <= 0.0:
        return None
    busy = union_us(r.device_ops) / 1e6 / r.n_steps
    return 100.0 * (1.0 - busy / r.window_step_s)
