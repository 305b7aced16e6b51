"""launches.icepack: CUDA kernels a step under the ``step.icepack.*`` spans,
counted from the trace: what a CUDA graph or a fusion of the thermo1 and
ridging stages would cut."""
from ocean_bench.trace import span_device_ms


def read(r):
    if not r.dev_spans:
        return None
    counts = {}
    span_device_ms(r.kernels, r.dev_spans, r.n_steps, counts)
    found = [v for k, v in counts.items() if k.startswith("step.icepack.")]
    return sum(found) if found else None
