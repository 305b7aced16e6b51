"""launches_per_step: the CUDA kernels of the profiled steps, a step (the
host dispatches each; copies and fills are not counted)."""


def read(r):
    if not r.kernels:
        return None
    return len(r.kernels) / r.n_steps
