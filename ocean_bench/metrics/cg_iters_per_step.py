"""cg_iters_per_step: the mean of ``Model.ssh_iters`` (the CG iterations of
the step's SSH solve, ``core/ssh.py``) over the profiled steps; nothing
where the model solves densely (0 iterations)."""


def read(r):
    iters = list(r.ssh_iters)
    if not iters or not any(iters):
        return None
    return sum(iters) / len(iters)
