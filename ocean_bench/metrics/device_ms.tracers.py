"""device_ms.tracers: device ms a step of the kernels under ``step.tracers``
(``model.solve_tracers``, ``core/tracers.py``) and its sub-spans, by the
innermost device-side span that holds each kernel's start."""
from ocean_bench.trace import span_device_ms


def read(r):
    if not r.dev_spans:
        return None
    ms = span_device_ms(r.kernels, r.dev_spans, r.n_steps)
    found = [v for k, v in ms.items()
             if k == "step.tracers" or k.startswith("step.tracers.")]
    return sum(found) if found else None
