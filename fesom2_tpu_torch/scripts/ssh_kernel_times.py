"""Time ``block_schwarz`` on the packed layout against another checkout's
kernel on the padded tables, in turns, at the preconditioners the CG solve
applies: the level-7 globe's (445 blocks) and the 46,000-node channel's.

    python -m fesom2_tpu_torch.scripts.ssh_kernel_times [--parent DIR]
        [--level 7] [--calls 20] [--batches 5] [--tile-rows 8,16,24]
        [--out FILE]

``--parent DIR`` is a checkout of another commit (``git archive`` of the
parent into a directory that ``.gitignore`` lists) whose
``fesom_block_schwarz`` takes the padded ``[nb, K, K]`` inverses (the first
design's C signature); its kernel library is built from its own sources
and called through ctypes with that argument list.  On one CUDA card, one
process.  It prints the card's name and power limit first, then one JSON
object per line (also written to ``--out``), float64 then float32, for each
preconditioner:

* the kernel held against the plain version on the padded tables (f64
  1e-12, f32 1e-5 of max|plain|) and against the other checkout's kernel
  (the largest difference: the two sum in other orders);
* each kernel timed in turns (new, old, old, new): the profiler's device us
  of its ``__global__`` functions (two; the first design's three) hot and
  with the 50 MB L2 flushed (a 256 MB overwrite) before each call, and us
  a call of ``--calls`` calls between two CUDA events (the median of
  ``--batches``), hot and flushed (the flushes' own time taken off); the
  device us of each function of the first turn;
* the packed and the padded bound from ``block_schwarz_packed_work`` and
  ``block_schwarz_work``, the plain version's and one ``torch.bmm`` over the
  padded inverses (the local solves only) device us, the blocks' sizes and
  tiles, and the registers ``ptxas`` gave each build's kernels;
* ``--tile-rows``: the kernel's device us, hot and flushed, on tiles of at
  most each number of rows (``pack_block_schwarz(pc, tile_rows)``; the
  kernel reads its tiles from the table, so no build per value).

Run it through the card tool, not from ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

try:
    from .timing import (batch_ms, card_name, device_kernels_us, kernel_us,
                         load_checkout_library)
except ImportError:     # run as a file: python .../ssh_kernel_times.py
    from timing import (batch_ms, card_name, device_kernels_us, kernel_us,
                        load_checkout_library)

P, I = ctypes.c_void_p, ctypes.c_int
NEW_KERNELS = ("::schwarz_local_kernel<", "::schwarz_combine_kernel<")
OLD_KERNELS = ("::local_solve_kernel<", "::coarse_solve_kernel<",
               "::combine_kernel<")


def ptxas_registers(log: Path) -> dict:
    """{entry function: registers} of the block-Schwarz kernels in a build
    log's ptxas lines."""
    regs, current = {}, None
    if not log.exists():
        return regs
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current and re.search(
                r"(schwarz|local_solve|coarse_solve|combine)_kernel", current):
            regs[current] = int(m.group(1))
            current = None
    return regs


def parent_block_schwarz(lib, pc, x):
    """The first design's kernel: the padded tables, one CUDA block per
    Schwarz block."""
    fn = lib.fesom_block_schwarz
    fn.argtypes = [P, I, P, P, I, I, P, P, I, P, I, P, P, P, P, P, P, I, P]
    fn.restype = ctypes.c_int
    N = x.shape[0]
    nb, K = pc.block_ids.shape
    yb = torch.empty(nb * K, dtype=x.dtype, device=x.device)
    r0 = torch.empty(nb, dtype=x.dtype, device=x.device)
    y0 = torch.empty(nb, dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    err = fn(x.data_ptr(), N, pc.block_ids.data_ptr(),
             pc.inv_blocks.data_ptr(), nb, K, pc.node_slots.data_ptr(),
             pc.node_slot_valid.data_ptr(), pc.node_slots.shape[1],
             pc.coarse_ids.data_ptr(), pc.coarse_ids.shape[1],
             pc.coarse_inv.data_ptr(), pc.coarse_part.data_ptr(),
             yb.data_ptr(), r0.data_ptr(), y0.data_ptr(), y.data_ptr(),
             int(x.dtype == torch.float64),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent block_schwarz: CUDA error {err}")
    return y


def preconditioners(level: int, dev) -> dict:
    """{label: float64 BlockSchwarz} of the level-``level`` globe's CI model
    and the 46,000-node zstar channel's, as ``chip_smoke.py`` builds them."""
    from fesom2_tpu_torch.mesh import globe
    from fesom2_tpu_torch.mesh.channel import channel_raw_mesh, write_mesh
    from fesom2_tpu_torch.model import setup_pi_model, setup_soufflet_model
    root = Path("build") / "ssh_kernel_times"
    gpath = globe.write_globe(str(root / f"globe_l{level}"), level=level)
    cpath = write_mesh(channel_raw_mesh(nx=100, ny=460),
                       str(root / "channel_100x460"))
    gm, _ = setup_pi_model(gpath, device=dev, dtype=torch.float64)
    cm = setup_soufflet_model(cpath, device=dev, dtype=torch.float64,
                              which_ale="zstar")
    return {f"globe l{level}": gm.ssh_block_pc, "channel 46k":
            cm.ssh_block_pc}


def as_dtype(pc, dtype):
    """The same preconditioner with its floats in ``dtype`` (the builder
    rounds its float64 tables so), packed anew."""
    from fesom2_tpu_torch.core import ssh
    cast = lambda t: t.to(dtype) if t.is_floating_point() else t
    out = ssh.BlockSchwarz(cast(pc.block_ids), cast(pc.inv_blocks),
                           pc.node_slots, pc.node_slot_valid, pc.coarse_ids,
                           cast(pc.coarse_inv), pc.coarse_part)
    out.packed = ssh.pack_block_schwarz(out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default="")
    ap.add_argument("--level", type=int, default=7)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--tile-rows", default="",
                    help="comma-separated tile rows to sweep")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sweep = [int(v) for v in args.tile_rows.split(",") if v]
    if not torch.cuda.is_available():
        print("ssh_kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    from fesom2_tpu_torch import kernels
    from fesom2_tpu_torch.core import ssh
    from fesom2_tpu_torch.kernels import build

    card = card_name()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    sink = open(args.out, "w") if args.out else None

    def emit(**row):
        line = json.dumps({"card": card, **row})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    kernels.library()
    parent = load_checkout_library(args.parent) if args.parent else None
    emit(registers={"new": ptxas_registers(
        build.library_path().with_suffix(".log")), "old": ptxas_registers(
        Path(parent._name).with_suffix(".log")) if parent else None})
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    flush_ms = batch_ms(flush.zero_, args.calls, args.batches)
    failed = False
    pcs = preconditioners(args.level, dev)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        tag = str(dtype).replace("torch.", "")
        size = torch.empty((), dtype=dtype).element_size()
        rng = np.random.default_rng(21)
        for label, pc64 in pcs.items():
            pc = as_dtype(pc64, dtype)
            N = pc.node_slots.shape[0]
            nb, K = pc.block_ids.shape
            x = torch.as_tensor(rng.uniform(-1, 1, N), device=dev).to(dtype)
            new = lambda pc=pc, x=x: ssh.block_schwarz(pc, x)
            old = (lambda pc=pc, x=x: parent_block_schwarz(parent, pc, x)) \
                if parent else None
            got, want = new(), ssh.block_schwarz_plain(pc, x)
            scale = float(want.abs().max())
            rel = float((got - want).abs().max()) / scale
            rel_old = float((old() - got).abs().max()) / scale if old \
                else None
            failed |= not rel <= tol
            sizes = np.diff(pc.packed.row_off.cpu().numpy())
            packed = kernels.bound_ms(ssh.block_schwarz_packed_work(
                N, sizes, pc.packed.node_slots.shape[1],
                pc.coarse_ids.shape[1], size), dtype)
            padded = kernels.bound_ms(ssh.block_schwarz_work(
                N, nb, K, pc.node_slots.shape[1], pc.coarse_ids.shape[1],
                size), dtype)
            rb = x[pc.block_ids.long().clamp_min(0)][..., None].contiguous()
            turns = [("new", new, NEW_KERNELS)] + (
                [("old", old, OLD_KERNELS)] * 2 if old else []) + [
                ("new", new, NEW_KERNELS)]
            times = {"new": [], "old": []}
            for name, f, names in turns:
                times[name].append({
                    "device_us": kernel_us(f, names, args.calls),
                    "cold_device_us": kernel_us(f, names, args.calls,
                                                flush=flush),
                    "batch_us": batch_ms(f, args.calls, args.batches) * 1e3,
                    "cold_batch_us": (batch_ms(
                        lambda f=f: (flush.zero_(), f()), args.calls,
                        args.batches) - flush_ms) * 1e3})
            by_function = {
                name: {k: v for k, v in device_kernels_us(f).items()
                       if any(n.strip(":<") in k for n in names)}
                for name, f, names in turns[:2]}
            emit(kernel="block_schwarz", dtype=tag, tables=label,
                 padded=[nb, K, K], block_nodes=[int(sizes.min()),
                                                 float(np.median(sizes)),
                                                 int(sizes.max())],
                 packed_entries=int(pc.packed.inv.numel()),
                 padded_entries=int(pc.inv_blocks.numel()),
                 tiles=int(pc.packed.tiles.shape[0]), rel_err_plain=rel,
                 agrees=rel <= tol, rel_diff_parent=rel_old,
                 packed_bound_us=packed[0] * 1e3, padded_bound_us=padded[0]
                 * 1e3, bound_by=packed[1],
                 plain_device_us=kernel_us(
                     lambda: ssh.block_schwarz_plain(pc, x), "", args.calls),
                 bmm_device_us=kernel_us(
                     lambda: torch.bmm(pc.inv_blocks, rb), "", args.calls),
                 bmm_batch_us=batch_ms(lambda: torch.bmm(pc.inv_blocks, rb),
                                       args.calls, args.batches) * 1e3,
                 by_function=by_function, **times)
            for rows in sweep:
                pk = ssh.pack_block_schwarz(pc, rows)
                f = lambda pk=pk, pc=pc, x=x: ssh._block_schwarz_launch(
                    pc, pk, x)
                emit(kernel="block_schwarz", dtype=tag, tables=label,
                     tile_rows=rows, tiles=int(pk.tiles.shape[0]),
                     same_bits=bool(torch.equal(f(), got)),
                     device_us=[kernel_us(f, NEW_KERNELS, args.calls)
                                for _ in range(2)],
                     cold_device_us=[kernel_us(f, NEW_KERNELS, args.calls,
                                               flush=flush)
                                     for _ in range(2)])
            del pc
            torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
