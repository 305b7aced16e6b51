"""kernels_roofline: the hand-written kernels' least time over their device
time in the profiled steps, in percent, summed over every hand-written
kernel there: the least time of each launch from its bytes and operations
(the frozen ``*_work`` counters, ``work.launch_work``) against the card's
published peaks; the device time of the CUDA functions the trace names for
those kernels (``work.CUDA_NAMES``).  Each kernel's least time, device
time and launches read and unread go to the run's notes.  Nothing is read
where any hand-written kernel is not read whole: a launch whose arguments
the counters cannot read, a launched kernel with no device time under the
names the trace is read by, or device time of a kernel with no launch."""
from ocean_bench.work import kernel_of, least_s


def read(r):
    least, read_, unread, spent = {}, {}, {}, {}
    for name, w in r.launches:
        if w is None:
            unread[name] = unread.get(name, 0) + 1
            continue
        read_[name] = read_.get(name, 0) + 1
        least[name] = least.get(name, 0.0) + least_s(*w)
    for cuda_name, start, end in r.kernels:
        k = kernel_of(cuda_name)
        if k is not None:
            spent[k] = spent.get(k, 0.0) + (end - start) / 1e6
    names = sorted(set(read_) | set(unread) | set(spent))
    whole = []
    for k in names:
        ok = not unread.get(k) and k in least and spent.get(k, 0.0) > 0.0
        whole.append(ok)
        r.notes.append(
            f"kernels_roofline {k}: least {least.get(k, 0.0) * 1e3:.6f} ms, "
            f"device {spent.get(k, 0.0) * 1e3:.6f} ms over {r.n_steps} "
            f"steps; launches read {read_.get(k, 0)}, unread "
            f"{unread.get(k, 0)}{'' if ok else '; not read whole'}")
    if not names or not all(whole):
        return None
    return 100.0 * sum(least.values()) / sum(spent.values())
