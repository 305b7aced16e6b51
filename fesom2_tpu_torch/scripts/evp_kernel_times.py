"""Time ``mevp_subcycles`` (the mEVP subcycle loop in one cooperative
launch) against another checkout's kernel, the EVP and aEVP
instantiations beside it, and ``ring_spmv`` at the repository's two ring
widths against its kernel.

    python -m fesom2_tpu_torch.scripts.evp_kernel_times [--parent DIR]
        [--level 7] [--n-sub 120] [--reps 10] [--out FILE]
    PYTHONPATH=DIR python fesom2_tpu_torch/scripts/evp_kernel_times.py
        --loop-only --label NAME

On one CUDA card, one process, one JSON object per line on standard output
(and in ``--out``), float64 then float32.  The mEVP inputs: seeded ice on
the globe of ``mesh/globe.py`` at ``--level`` (7: 114,033 nodes), its
tables built by ``evp.mevp_setup`` on the |lat| > 40 subdomain (36,153
nodes, 70,523 elements), as the coupled step builds them.

* ``mevp_subcycles`` after 1, 8 and ``--n-sub`` subcycles, held bit for
  bit against the loop of ``mevp_subcycle_plain`` and, with ``--parent``,
  against the other checkout's kernel: its ``fesom_mevp_subcycles`` where
  it has one (one launch, the same arguments; its plan beside this one's),
  else its ``fesom_mevp_stress`` and ``fesom_mevp_node`` (the first
  design: two launches a subcycle), with the SHA-256 of the outputs; the
  launch plan (grid, shared bytes, whether the constants are staged);
* both timed in turns (new, parent, parent, new) for ``--n-sub``
  subcycles: the profiler's device microseconds (hot: the
  tables in L2 from the call before; cold: a 256 MB overwrite before each
  call), and the milliseconds from before the first launch to the end of
  the last, by CUDA events (the loop's wall time as a step sees it; the
  parent's pair is called through ctypes here, without its Python
  wrappers, so ``--loop-only`` gives the loop as the step runs it);
* beside them, never on the path: a CUDA-graph replay of the first
  design's 2 x ``--n-sub`` launches, and the latency floor, an empty cooperative
  kernel on the same grid crossing the same barriers;
* the bounds: ``mevp_subcycles_work``'s, and the first design's two
  per-subcycle bounds summed over the subcycles;
* the kernel's standard- and adaptive-EVP instantiations
  (``evp_subcycles``, ``aevp_subcycles``) on the same seeded inputs (aEVP
  with the state's alpha and beta): bit for bit against their plain
  loops after 1, 8 and ``--n-sub`` subcycles, device us hot and cold and
  events ms twice each, plan, barrier floor and bound;
* ``ring_spmv`` on the ALE ring of the 46,000-node zstar channel [8, N]
  and of the level-7 globe [10, N] (values rebuilt from a 0.5 m hbar
  perturbation, as a step does), bit for bit against the plain version
  and the parent's kernel, timed in turns (new, old, old, new), hot and
  with the L2 flushed before each call, against ``ring_spmv_work``'s
  bound.

``--loop-only`` times the package that leads ``PYTHONPATH`` as
``mevp_dynamics`` runs its subcycles (this checkout: one call of
``evp.mevp_subcycles``; a checkout of the first design: ``--n-sub`` calls of
``evp.mevp_subcycle``), wall milliseconds by the host clock around the
loop and a synchronise, and device microseconds; run it for both
checkouts in turns, one process each.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import sys
import time

import numpy as np
import torch

try:
    from .timing import (card_name, digest, events_ms, kernel_us,
                         load_checkout_library, same_bits)
except ImportError:                 # run as a file: python .../evp_kernel_times.py
    from timing import (card_name, digest, events_ms, kernel_us,
                        load_checkout_library, same_bits)

MESH = dict(force_rotation=True, cyclic_length_deg=360.0,
            use_partial_cell=True)


def seeded_subdomain_inputs(path: str, dtype, seed: int = 5,
                            aevp: bool = False):
    """(ice, forcing, surf, sub): a seeded ice state, forcing and ocean
    surface on the globe's ice subdomain (with aEVP's alpha and beta)."""
    from fesom2_tpu_torch.ice import evp
    from fesom2_tpu_torch.ice.state import (OceanSurface, allocate_ice,
                                            zero_ice_forcing)
    from fesom2_tpu_torch.ice.subdomain import build_ice_subdomain
    from fesom2_tpu_torch.mesh import build_mesh
    from fesom2_tpu_torch.model import pi_config
    m = build_mesh(path, device="cuda", dtype=dtype, **MESH)
    sub = build_ice_subdomain(m, 40.0)
    rng = np.random.default_rng(seed)
    N, E = m.n_nodes, m.n_elems
    put = lambda a: torch.as_tensor(a, device="cuda").to(dtype)
    u = lambda lo, hi, n=N: put(rng.uniform(lo, hi, n))
    ice = dataclasses.replace(
        allocate_ice(m, dtype), u_ice=u(-0.1, 0.1), v_ice=u(-0.1, 0.1),
        m_ice=u(0.0, 2.0), a_ice=u(0.0, 1.0), m_snow=u(0.0, 0.3),
        sigma11=u(-100.0, 100.0, E), sigma12=u(-100.0, 100.0, E),
        sigma22=u(-100.0, 100.0, E))
    forcing = dataclasses.replace(zero_ice_forcing(m, dtype),
                                  stress_atmice_x=u(-0.2, 0.2),
                                  stress_atmice_y=u(-0.2, 0.2))
    surf = OceanSurface(T_oc=u(-1.0, 1.0), S_oc=u(33.0, 35.0),
                        u_w=u(-0.05, 0.05), v_w=u(-0.05, 0.05),
                        elevation=u(-0.3, 0.3))
    if aevp:
        return (*evp.subdomain_inputs(ice, sub, forcing, surf, aevp=True),
                sub)
    return (*evp.subdomain_inputs(ice, sub, forcing, surf), sub)


def seeded_subdomain_tables(path: str, dtype, seed: int = 5):
    """(tab, uv, sig, sub): mEVP's tables on the globe's ice subdomain from
    the seeded inputs of ``seeded_subdomain_inputs``."""
    from fesom2_tpu_torch.ice import evp
    from fesom2_tpu_torch.model import pi_config
    ice, forcing, surf, sub = seeded_subdomain_inputs(path, dtype, seed)
    tab = evp.mevp_setup(ice, sub, forcing, surf, pi_config())
    return (tab, torch.stack([ice.u_ice, ice.v_ice]),
            torch.stack([ice.sigma11, ice.sigma12, ice.sigma22]), sub)


def variant_rows(path, dtype, n, reps, flush):
    """The standard- and adaptive-EVP instantiations of the subcycle kernel
    on the seeded inputs: bit for bit against their plain loops after 1, 8
    and n subcycles, device us hot and cold and events ms for n (two
    readings each), the plan and the barrier floor of each one's grid, the
    bound.  Yields one dict a variant."""
    from fesom2_tpu_torch import kernels
    from fesom2_tpu_torch.ice import evp
    from fesom2_tpu_torch.model import pi_config
    size = torch.empty((), dtype=dtype).element_size()
    for which, rheo, setup, kern, plain, work in (
            (0, "evp", evp.evp_setup, evp.evp_subcycles,
             evp.evp_subcycles_plain, evp.evp_subcycles_work),
            (2, "aevp", evp.aevp_setup, evp.aevp_subcycles,
             evp.aevp_subcycles_plain, evp.aevp_subcycles_work)):
        ice, forcing, surf, sub = seeded_subdomain_inputs(
            path, dtype, aevp=which == 2)
        cfg = pi_config()
        cfg.ice.whichEVP = which
        tab = setup(ice, sub, forcing, surf, cfg)
        uv0 = torch.stack([ice.u_ice, ice.v_ice])
        sig0 = torch.stack([ice.sigma11, ice.sigma12, ice.sigma22])
        N, E, K = sub.n_nodes, sub.n_elems, sub.elem_slot.shape[0]
        bitwise = {}
        for m in sorted({1, 8, n}):
            want = plain(uv0, sig0, tab, sub, m)
            got = kern(uv0.clone(), sig0.clone(), tab, sub, m)
            torch.cuda.synchronize()
            bitwise[m] = same_bits(got[0], want[0]) \
                and same_bits(got[1], want[1])
        uv, sig = uv0.clone(), sig0.clone()
        f = lambda: kern(uv, sig, tab, sub, n)
        name = f"{rheo}_subcycles"
        times = [{"device_us": kernel_us(f, f"{name}_kernel", calls=5),
                  "cold_device_us": kernel_us(f, f"{name}_kernel", calls=5,
                                              flush=flush),
                  "events_ms": events_ms(f, reps=reps, warmup=2)}
                 for _ in range(2)]
        nb = evp.mevp_subcycles_barriers(n)
        b_ms, bound_by = kernels.bound_ms(work(N, E, K, size, n), dtype)
        yield dict(
            kernel=name, dtype=str(dtype).replace("torch.", ""), n_sub=n,
            shape=f"uv [2, {N}] sig [3, {E}] K={K}", bitwise_plain=bitwise,
            plan=evp.mevp_subcycles_plan("cuda", dtype, N, E, K, rheo),
            bound_us=b_ms * 1e3, bound_by=bound_by, times=times,
            barrier_floor={"barriers": nb, "device_us": kernel_us(
                lambda: evp.mevp_barrier_floor("cuda", dtype, N, E, K, nb,
                                               rheo), "barrier_kernel",
                calls=5)})


def parent_launch(lib, tab, sub):
    """The other checkout's loop on these tables, in place on (uv, sig):
    a function of (uv, sig, m) for m subcycles, and its plan (or None).
    A checkout with ``fesom_mevp_subcycles`` (one launch for all m) is
    called with this checkout's arguments; an older one through its pair
    of kernels a subcycle."""
    if not hasattr(lib, "fesom_mevp_subcycles"):
        old = parent_pair(lib, tab, sub)

        def loop(uv, sig, m):
            for _ in range(m):
                old(uv, sig)
            return uv, sig
        return loop, None
    from fesom2_tpu_torch import kernels
    from fesom2_tpu_torch.constants import density_0
    from fesom2_tpu_torch.core.ops import elem_slot_of
    fn = lib.fesom_mevp_subcycles
    fn.argtypes = kernels._ARGTYPES["mevp_subcycles"]
    fn.restype = ctypes.c_int
    slot = elem_slot_of(sub)
    N, E, K = sub.n_nodes, sub.n_elems, slot.shape[0]
    code = int(tab.elem_c.dtype == torch.float64)

    def loop(uv, sig, m):
        err = fn(uv.data_ptr(), sig.data_ptr(), tab.fuv.data_ptr(),
                 tab.en.data_ptr(), slot.data_ptr(), tab.elem_c.data_ptr(),
                 tab.node_c.data_ptr(), N, E, K, m, tab.det1, tab.vale,
                 tab.delta_min, tab.rdt, tab.rdt_cd, density_0, tab.beta,
                 code, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent mevp_subcycles: CUDA error {err}")
        return uv, sig
    out = (ctypes.c_int * 4)()
    if hasattr(lib, "fesom_subcycles_plan"):        # the rheology first
        lib.fesom_subcycles_plan.argtypes = [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        lib.fesom_subcycles_plan(1, N, E, K, code, ctypes.addressof(out))
    else:
        lib.fesom_mevp_subcycles_plan.argtypes = [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.fesom_mevp_subcycles_plan(N, E, K, code, ctypes.addressof(out))
    return loop, dict(zip(("grid", "block", "smem_bytes", "staged"), out))


def parent_pair(lib, tab, sub):
    """One subcycle of the first design's two kernels (in place on uv,
    sig), as a function of (uv, sig)."""
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.fesom_mevp_stress.argtypes = [P, I, P, I, P, P, P, D, D, D, I, P]
    lib.fesom_mevp_node.argtypes = [P, I, P, I, P, P, I, P, D, D, D, D, I, P]
    lib.fesom_mevp_stress.restype = lib.fesom_mevp_node.restype = ctypes.c_int
    from fesom2_tpu_torch.constants import density_0
    N, E = sub.n_nodes, sub.n_elems
    K = sub.nod_in_elem.shape[1]
    code = int(tab.elem_c.dtype == torch.float64)
    fuv = torch.empty((2, 3, E), dtype=tab.elem_c.dtype, device="cuda")

    def subcycle(uv, sig):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fesom_mevp_stress(
            uv.data_ptr(), N, tab.en.data_ptr(), E, tab.elem_c.data_ptr(),
            sig.data_ptr(), fuv.data_ptr(), tab.det1, tab.vale,
            tab.delta_min, code, stream)
        err = err or lib.fesom_mevp_node(
            uv.data_ptr(), N, fuv.data_ptr(), E, sub.nod_in_elem.data_ptr(),
            sub.nod_in_elem_slot.data_ptr(), K, tab.node_c.data_ptr(),
            tab.rdt, tab.rdt_cd, density_0, tab.beta, code, stream)
        if err:
            raise RuntimeError(f"parent mEVP kernels: CUDA error {err}")
    return subcycle


def loop_only(args, emit) -> int:
    """The subcycle loop of the package on the path, as mevp_dynamics runs
    it: wall ms (host clock, synchronised) and device us."""
    from fesom2_tpu_torch.ice import evp
    from fesom2_tpu_torch.mesh import globe
    path = globe.write_globe(f"{args.mesh_dir}_l{args.level}",
                             level=args.level)
    one_launch = hasattr(evp, "mevp_subcycles")
    for dtype in (torch.float64, torch.float32):
        tab, uv0, sig0, sub = seeded_subdomain_tables(path, dtype)
        uv, sig = uv0.clone(), sig0.clone()

        def loop():
            if one_launch:
                evp.mevp_subcycles(uv, sig, tab, sub, args.n_sub)
            else:
                u, s = uv, sig
                for _ in range(args.n_sub):
                    u, s = evp.mevp_subcycle(u, s, tab, sub)
        loop()
        torch.cuda.synchronize()
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            loop()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        emit(kind="loop", label=args.label, dtype=str(dtype)[6:],
             n_sub=args.n_sub, one_launch=one_launch,
             wall_ms=sorted(walls)[len(walls) // 2], wall_ms_all=walls,
             device_us=kernel_us(loop, "mevp_", calls=5))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--level", type=int, default=7)
    ap.add_argument("--parent", default="")
    ap.add_argument("--n-sub", type=int, default=120)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--label", default="")
    ap.add_argument("--loop-only", action="store_true")
    ap.add_argument("--mesh-dir", default="build/evp_kernel_times/globe")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("evp_kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    card = card_name()
    sink = open(args.out, "a") if args.out else None

    def emit(**row):
        line = json.dumps({"card": card, **row})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    if args.loop_only:
        return loop_only(args, emit)

    from fesom2_tpu_torch import kernels
    from fesom2_tpu_torch.core import ssh
    from fesom2_tpu_torch.ice import evp
    from fesom2_tpu_torch.mesh import build_mesh, globe
    from fesom2_tpu_torch.mesh.channel import channel_raw_mesh, write_mesh
    from fesom2_tpu_torch.model import pi_config, setup_soufflet_model

    kernels.library()
    parent = load_checkout_library(args.parent) if args.parent else None
    path = globe.write_globe(f"{args.mesh_dir}_l{args.level}",
                             level=args.level)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    n = args.n_sub
    failed = False
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        size = torch.empty((), dtype=dtype).element_size()
        tab, uv0, sig0, sub = seeded_subdomain_tables(path, dtype)
        N, E, K = sub.n_nodes, sub.n_elems, sub.elem_slot.shape[0]
        old_loop, parent_plan = parent_launch(parent, tab, sub) \
            if parent else (None, None)
        old = old_loop

        # bit for bit: the kernel and the parent against the plain loop
        for m in sorted({1, 8, n}):
            want = evp.mevp_subcycles_plain(uv0, sig0, tab, sub, m)
            outs = {"new": evp.mevp_subcycles(uv0.clone(), sig0.clone(), tab,
                                              sub, m)}
            if old:
                outs["parent"] = old_loop(uv0.clone(), sig0.clone(), m)
            torch.cuda.synchronize()
            equal = {k: same_bits(v[0], want[0]) and same_bits(v[1], want[1])
                     for k, v in outs.items()}
            failed |= not all(equal.values())
            emit(kernel="mevp_subcycles", dtype=tag, n_sub=m,
                 shape=f"uv [2, {N}] sig [3, {E}] K={K}",
                 bitwise_plain=equal, sha256=digest(want),
                 moved=float((want[0] - uv0).abs().max()))

        b_ms, bound_by = kernels.bound_ms(
            evp.mevp_subcycles_work(N, E, K, size, n), dtype)
        # the first design's two counters (PR 6), summed over n subcycles
        stress = ((2 * N + 22 * E) * size + 3 * E * 4, 70 * E)
        node = ((6 * E + 17 * N) * size + 2 * N * K * 4, (2 * K + 45) * N)
        parent_bound = n * sum(kernels.bound_ms(w, dtype)[0]
                               for w in (stress, node))
        uv, sig = uv0.clone(), sig0.clone()
        calls = {"new": lambda uv=uv, sig=sig: evp.mevp_subcycles(
            uv, sig, tab, sub, n)}
        if old:
            uv, sig = uv0.clone(), sig0.clone()
            calls["parent"] = lambda uv=uv, sig=sig: old_loop(uv, sig, n)
        turns = list(calls) + list(calls)[::-1]
        times = {k: [] for k in calls}
        for k in turns:
            f = calls[k]
            times[k].append({
                "device_us": kernel_us(f, "mevp_", calls=5),
                "cold_device_us": kernel_us(f, "mevp_", calls=5, flush=flush),
                "events_ms": events_ms(f, reps=args.reps, warmup=2)})
        nb = evp.mevp_subcycles_barriers(n)
        floor = {"barriers": nb, "device_us": [
            kernel_us(lambda: evp.mevp_barrier_floor(
                "cuda", dtype, N, E, K, nb), "barrier_kernel", calls=5)
            for _ in range(2)]}
        graph = None
        if old and parent_plan is None:
            uv, sig = uv0.clone(), sig0.clone()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                old_loop(uv, sig, n)
            torch.cuda.current_stream().wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                old_loop(uv, sig, n)
            graph = {"device_us": kernel_us(g.replay, "mevp_", calls=5),
                     "events_ms": events_ms(g.replay, reps=args.reps,
                                            warmup=2)}
        for row in variant_rows(path, dtype, n, args.reps, flush):
            failed |= not all(row["bitwise_plain"].values())
            emit(**row)
        emit(kernel="mevp_subcycles", dtype=tag, n_sub=n,
             plan=evp.mevp_subcycles_plan("cuda", dtype, N, E, K),
             parent_plan=parent_plan,
             bound_us=b_ms * 1e3, bound_by=bound_by,
             parent_bounds_summed_us=parent_bound * 1e3, times=times,
             barrier_floor=floor, parent_graph_replay=graph)

        # ring_spmv at the two ring widths, in turns with the parent's
        rng = np.random.default_rng(29)
        chan = setup_soufflet_model(
            write_mesh(channel_raw_mesh(nx=100, ny=460),
                       f"{args.mesh_dir}_channel_100x460"),
            device="cuda", dtype=dtype, which_ale="zstar")
        gmesh = build_mesh(path, device="cuda", dtype=dtype, **MESH)
        for label, ring, mesh in (
                ("channel", chan.ssh_ring, chan.mesh),
                ("globe", ssh.build_ssh_ring_ale(gmesh, pi_config(),
                                                 dtype=dtype), gmesh)):
            hbar_e = torch.as_tensor(rng.uniform(-0.5, 0.5, mesh.n_elems),
                                     device="cuda").to(dtype)
            op = ring.materialize(hbar_e)
            Kr, Nr = op.cols.shape
            x = torch.as_tensor(rng.standard_normal(Nr),
                                device="cuda").to(dtype)
            new_f = lambda op=op, x=x: op(x)
            fns = {"new": new_f}
            if parent:
                y = torch.empty_like(x)
                parent.fesom_ring_spmv.argtypes = [ctypes.c_void_p] * 3 + [
                    ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_void_p]

                def old_f(op=op, x=x, y=y, Kr=Kr, Nr=Nr):
                    err = parent.fesom_ring_spmv(
                        op.cols.data_ptr(), op.vals.data_ptr(), x.data_ptr(),
                        Kr, Nr, y.data_ptr(), int(dtype == torch.float64),
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"parent ring_spmv: error {err}")
                    return y
                fns["old"] = old_f
            want = ssh.ring_spmv_plain(op.cols, op.vals, x)
            equal = {k: same_bits(f(), want) for k, f in fns.items()}
            failed |= not all(equal.values())
            b_ms, bound_by = kernels.bound_ms(ssh.ring_spmv_work(Kr, Nr, size),
                                              dtype)
            order = ["new", "old", "old", "new"] if parent else ["new", "new"]
            rtimes = {k: [] for k in fns}
            for k in order:
                rtimes[k].append({
                    "device_us": kernel_us(fns[k], "ring_spmv"),
                    "cold_device_us": kernel_us(fns[k], "ring_spmv",
                                                flush=flush)})
            emit(kernel="ring_spmv", dtype=tag, ring=label, shape=[Kr, Nr],
                 templated=Kr in ssh.RING_TEMPLATED, bitwise=equal,
                 sha256=digest((want,)), bound_us=b_ms * 1e3,
                 bound_by=bound_by, times=rtimes)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
