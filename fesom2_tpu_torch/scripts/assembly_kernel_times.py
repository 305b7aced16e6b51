"""Time ``elem_contrib_to_nodes`` at the coupled step's shapes, against
another checkout's kernel, and ``ring_spmv`` at the globe's ALE ring.

    python -m fesom2_tpu_torch.scripts.assembly_kernel_times [--level 7]
        [--parent DIR] [--target-blocks 512,1024,2048,8192] [--calls 20]
        [--batches 5] [--mesh-dir DIR] [--out FILE]

On one CUDA card, one process, one JSON object per line on standard output
(and in ``--out``), for float64 and float32 on the globe of
``mesh/globe.py`` at ``--level`` (7: 114,033 nodes, 225,854 elements) and
its |lat| > 40 ice subdomain:

* ``elem_contrib_to_nodes`` at the six shapes a coupled step launches
  (``[2, Es, 3]`` on the subdomain; ``[6, 3, E]``, ``[9, E, 3]``, ``[6, E,
  3]``, ``[2, 3, E, 3]``, ``[3, E, 3]`` on the globe) and at the four the
  step launched as eleven separate calls (``[Es, 3]`` twice, ``[3, 3, E]``
  twice, ``[3, E, 3]`` six times, ``[2, 3, E, 3]`` once), each held bit
  for bit against the plain version and, with ``--parent``, against the
  other checkout's kernel, with the SHA-256 of its output;
* each timed four ways: the profiler's device microseconds of the kernel
  (``device_us``), the same with the 50 MB L2 cache flushed before every
  call (``cold_device_us``: what a call finds in a step, where other
  kernels ran in between), microseconds per call of ``--calls`` calls
  between one pair of CUDA events (the median of ``--batches``), and the
  card's least time from ``elem_contrib_to_nodes_work``; with
  ``--parent`` the two kernels in turns (new, old, old, new);
* ``--target-blocks``: the stacked shapes' device us with
  ``cluster.ASSEMBLY_TARGET_BLOCKS`` (the blocks a launch aims at, hence
  the rows a thread walks) set to each value;
* the calls a coupled step makes, priced at these times: the six stacked
  calls against the eleven of the earlier layout, hot and cold;
* ``ring_spmv`` on the globe's ALE ring ``[Kr, N]`` (values rebuilt from a
  0.5 m hbar perturbation, as a step does), hot and cold, against its
  bound from ``ring_spmv_work`` and a CSR product.

``--parent DIR`` names a checkout of another commit (``git archive`` into
an ignored directory) whose ``fesom_elem_contrib_to_nodes`` takes the two
``[N, K]`` incidence tables (the first design's C signature); its library
is built from its own sources and loaded beside this one's.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

from .timing import batch_ms, card_name, digest, same_bits

MESH = dict(force_rotation=True, cyclic_length_deg=360.0,
            use_partial_cell=True)
# (tables, leading rows, vertex-major, calls a coupled step)
STACKED = (("subdomain", (2,), False, 1), ("globe", (6,), True, 1),
           ("globe", (9,), False, 1), ("globe", (6,), False, 1),
           ("globe", (2, 3), False, 1), ("globe", (3,), False, 1))
EARLIER = (("subdomain", (), False, 2), ("globe", (3,), True, 2),
           ("globe", (3,), False, 6), ("globe", (2, 3), False, 1))


def load_parent_library(root: str) -> ctypes.CDLL:
    """Build and load the kernel library of the checkout at ``root``."""
    spec = importlib.util.spec_from_file_location(
        "parent_kernels_build",
        Path(root) / "fesom2_tpu_torch" / "kernels" / "build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = ctypes.CDLL(str(mod.build()))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.fesom_elem_contrib_to_nodes.argtypes = [P, I, I, P, P, I, I, I, P, I,
                                                P]
    lib.fesom_elem_contrib_to_nodes.restype = ctypes.c_int
    return lib


def parent_assembly(lib, x, tables, vertex_major: bool):
    """The first design's kernel: one thread per (row, node) on the
    ``nod_in_elem`` and ``nod_in_elem_slot`` tables."""
    E = tables.n_elems
    N, K = tables.nod_in_elem.shape
    flat = x.reshape(-1, 3 * E).contiguous()
    out = torch.empty((flat.shape[0], N), dtype=x.dtype, device=x.device)
    err = lib.fesom_elem_contrib_to_nodes(
        flat.data_ptr(), flat.shape[0], E, tables.nod_in_elem.data_ptr(),
        tables.nod_in_elem_slot.data_ptr(), N, K, int(vertex_major),
        out.data_ptr(), int(x.dtype == torch.float64),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent elem_contrib_to_nodes: CUDA error {err}")
    return out.reshape(x.shape[:-2] + (N,))


def kernel_us(fn, name: str, calls: int = 20, flush=None) -> float:
    """Device microseconds per call of the CUDA kernels of fn() whose name
    holds ``name``, from torch.profiler; ``flush`` (a large tensor) is
    overwritten before every call, so each call finds a cold L2."""
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    fn()
    torch.cuda.synchronize()
    for _ in range(3):                  # a dropped trace is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                if flush is not None:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and name in e.key) / calls
        if us > 0:
            return us
    return float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--level", type=int, default=7)
    ap.add_argument("--parent", default="")
    ap.add_argument("--target-blocks", default="",
                    help="comma-separated ASSEMBLY_TARGET_BLOCKS to sweep")
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--mesh-dir", default="build/assembly_kernel_times/globe")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("assembly_kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    from fesom2_tpu_torch import kernels
    from fesom2_tpu_torch.core import ops, ssh
    from fesom2_tpu_torch.ice.subdomain import build_ice_subdomain
    from fesom2_tpu_torch.mesh import build_mesh, cluster, globe
    from fesom2_tpu_torch.model import pi_config

    card = card_name()
    dev = torch.device("cuda", 0)
    sink = open(args.out, "w") if args.out else None

    def emit(**row):
        line = json.dumps({"card": card, **row})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    kernels.library()
    parent = load_parent_library(args.parent) if args.parent else None
    path = globe.write_globe(f"{args.mesh_dir}_l{args.level}",
                             level=args.level)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    default_target = cluster.ASSEMBLY_TARGET_BLOCKS
    sweep = [int(v) for v in args.target_blocks.split(",") if v]
    failed = False
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        size = torch.empty((), dtype=dtype).element_size()
        mesh = build_mesh(path, device=dev, dtype=dtype, **MESH)
        tables = {"globe": mesh, "subdomain": build_ice_subdomain(mesh, 40.0)}
        rng = np.random.default_rng(23)
        step = {"stacked": {}, "earlier": {}}
        for layout, shapes in (("stacked", STACKED), ("earlier", EARLIER)):
            for which, lead, vertex_major, calls in shapes:
                t = tables[which]
                E, N, K = t.n_elems, t.n_nodes, t.nod_in_elem.shape[1]
                x = torch.as_tensor(rng.standard_normal(
                    lead + ((3, E) if vertex_major else (E, 3))),
                    device=dev).to(dtype)
                fn = ops.elem_contrib_to_nodes_3e if vertex_major \
                    else ops.elem_contrib_to_nodes
                new = lambda x=x, t=t, fn=fn: fn(x, t)
                old = (lambda x=x, t=t, vm=vertex_major:
                       parent_assembly(parent, x, t, vm)) if parent else None
                got = new()
                want = ops.elem_contrib_to_nodes_plain(x, t, vertex_major)
                equal = same_bits(got, want) and (
                    old is None or same_bits(old(), got))
                failed |= not equal
                rows = x.numel() // (3 * E)
                b_ms, _ = kernels.bound_ms(ops.elem_contrib_to_nodes_work(
                    rows, E, N, K, size), dtype)
                turns = [("new", new)] + ([("old", old), ("old", old)]
                                          if old else []) + [("new", new)]
                times = {"new": [], "old": []}
                for name, f in turns:
                    times[name].append({
                        "device_us": kernel_us(f, "elem_contrib_to_nodes"),
                        "cold_device_us": kernel_us(
                            f, "elem_contrib_to_nodes", flush=flush),
                        "batch_us": batch_ms(f, args.calls,
                                             args.batches) * 1e3})
                shape = f"{which} {list(x.shape)}"
                step[layout][shape] = (calls, times)
                emit(kernel="elem_contrib_to_nodes", dtype=tag, layout=layout,
                     shape=shape, calls_a_coupled_step=calls,
                     bitwise_plain_and_parent=equal, sha256=digest((got,)),
                     bound_us=b_ms * 1e3,
                     row_chunk=cluster.assembly_row_chunk(
                         rows, -(-N // kernels.BLOCK_THREADS)), **times)
                if layout == "stacked":
                    for target in sweep:
                        cluster.ASSEMBLY_TARGET_BLOCKS = target
                        emit(kernel="elem_contrib_to_nodes", dtype=tag,
                             shape=shape, target_blocks=target,
                             row_chunk=cluster.assembly_row_chunk(
                                 rows, -(-N // kernels.BLOCK_THREADS)),
                             device_us=[kernel_us(new, "elem_contrib_to_nodes")
                                        for _ in range(2)])
                    cluster.ASSEMBLY_TARGET_BLOCKS = default_target
        # the calls of a coupled step priced at these times (first turn)
        for layout, rows_ in step.items():
            for which in ("new", "old"):
                if not all(times[which] for _, times in rows_.values()):
                    continue
                emit(kernel="elem_contrib_to_nodes", dtype=tag,
                     step_layout=layout, kernel_of=which, launches=sum(
                         c for c, _ in rows_.values()), **{
                         key: sum(c * times[which][0][key]
                                  for c, times in rows_.values())
                         for key in ("device_us", "cold_device_us")})

        # ring_spmv at the globe's ALE ring
        ring = ssh.build_ssh_ring_ale(mesh, pi_config(), dtype=dtype)
        hbar_e = torch.as_tensor(rng.uniform(-0.5, 0.5, mesh.n_elems),
                                 device=dev).to(dtype)
        op = ring.materialize(hbar_e)
        Kr, N = op.cols.shape
        x = torch.as_tensor(rng.standard_normal(N), device=dev).to(dtype)
        got = op(x)
        want = ssh.ring_spmv_plain(op.cols, op.vals, x)
        rel = float((got - want).abs().max() / want.abs().max())
        failed |= not rel <= (1e-12 if dtype == torch.float64 else 1e-5)
        csr = torch.sparse_coo_tensor(
            torch.stack([torch.arange(N, device=dev).repeat(Kr),
                         op.cols.long().reshape(-1)]),
            op.vals.reshape(-1), (N, N)).coalesce().to_sparse_csr()
        xcol = x[:, None].contiguous()
        b_ms, bound_by = kernels.bound_ms(ssh.ring_spmv_work(Kr, N, size),
                                          dtype)
        emit(kernel="ring_spmv", dtype=tag, shape=[Kr, N], rel_err=rel,
             bound_us=b_ms * 1e3, bound_by=bound_by,
             device_us=[kernel_us(lambda: op(x), "ring_spmv")
                        for _ in range(2)],
             cold_device_us=[kernel_us(lambda: op(x), "ring_spmv",
                                       flush=flush) for _ in range(2)],
             batch_us=batch_ms(lambda: op(x), args.calls, args.batches) * 1e3,
             csr_product_batch_us=batch_ms(lambda: csr @ xcol, args.calls,
                                           args.batches) * 1e3)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
