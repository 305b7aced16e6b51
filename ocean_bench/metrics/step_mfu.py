"""step_mfu: the whole coupled step's share of the card's peak, in percent:
its least time over the untraced window's time a step.  The least time is
the bytes any implementation must move (``work.step_state_bytes``: the
state carried from step to step, read and written once, and one forcing
record, from the configuration's sizes) over the peak bandwidth.
Operations are not counted: the step's hand-written kernels are bound by
bytes but for the EVP subcycles and BL99, about 1 ms of a step's device
time.  Read beside the card's power limit (``device`` in the run's
standard error)."""
from ocean_bench.work import PEAK_BYTES_PER_S, step_state_bytes


def read(r):
    if not r.sizes or r.window_step_s <= 0.0:
        return None
    nbytes = step_state_bytes(r.sizes, len(r.traffic["tracer_ID"]),
                              r.config.get("icepack"))
    return 100.0 * nbytes / PEAK_BYTES_PER_S / r.window_step_s
