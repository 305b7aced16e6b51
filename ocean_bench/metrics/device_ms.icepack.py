"""device_ms.icepack: device ms a step of the kernels under the
``step.icepack.*`` spans (``ice/icepack/driver.py``)."""
from ocean_bench.trace import span_device_ms


def read(r):
    if not r.dev_spans:
        return None
    ms = span_device_ms(r.kernels, r.dev_spans, r.n_steps)
    found = [v for k, v in ms.items() if k.startswith("step.icepack.")]
    return sum(found) if found else None
