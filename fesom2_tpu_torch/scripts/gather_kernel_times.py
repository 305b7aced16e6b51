"""Time the gather kernels on both numberings of the code-built globe, and
``node_edge_reduce`` and ``onehot_gather`` against another checkout's.

    python -m fesom2_tpu_torch.scripts.gather_kernel_times [--level 7]
        [--reps 30] [--parent DIR] [--mesh-dir DIR] [--row-target-blocks B]
        [--skip-channels] [--out FILE]

On one CUDA card, one process, one JSON object per line on standard output
(and in ``--out``):

* per mesh (the globe of ``mesh/globe.py`` at ``--level`` numbered along
  the curve and by subdivision, the 25 x 115 and 100 x 460 channels): what
  a tile of 256 consecutive nodes touches through ``node_edges``,
  ``nod_in_elem`` and ``node_neighbors`` (distinct entries, 32-byte sectors
  of a float64 and a float32 field row, sectors summed over its warps'
  gather instructions: ``cluster.table_tile_stats``) and the seconds
  ``build_mesh`` took;
* ``node_edge_reduce`` as ``ops.edge_divergence`` and
  ``ops.edge_signed_reduce2`` on ``[2, nl - 1, Ed]`` (and the divergence of
  one row), float64 and float32, held against the plain version (1e-12 and
  1e-5 of max|plain|) and timed with CUDA events (median of ``--reps``)
  and ``torch.profiler`` (device microseconds per call);
* on the globe also ``ops.elem_to_node_mean`` ``[2, nl - 1, E]`` and
  ``tracers.fct_bounds`` ``[2, nl - 1, N]``, and one PyTorch gather of the
  same size (``flux[..., node_edges]``), so the numberings compare on
  every gather of the step;
* ``onehot_gather`` at the probe's shapes: against ``window_gather`` and
  the plain version bitwise, with three indices outside the window, and
  what it returns for -0.0 and for values under 2^-109; its time beside
  ``window_gather``'s and ``torch.bmm``'s on a prebuilt one-hot;
* every time three ways: the profiler's device microseconds, microseconds
  per call of a batch of calls between one pair of events (20 calls, 50
  for ``torch.bmm``), and the median of single calls between events;
* ``--row-target-blocks`` sets ``mesh.cluster.ROW_TARGET_BLOCKS`` (the
  blocks a ``node_edge_reduce`` launch aims at, hence its rows per thread)
  for the run.

``--parent DIR`` names a checkout of another commit (``git archive`` into
an ignored directory).  Its kernel library is built from its own sources
and loaded beside this one's, and its ``fesom_node_edge_reduce`` (the first
design's C signature: the ``node_edges`` and ``node_edge_sign`` tables) and
``fesom_onehot_gather`` are called on the same tensors, in turns (new, old,
old, new); the outputs of the two libraries must be equal bit for bit.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .timing import (as_tuple, batch_ms, card_name, device_kernels_us,
                     events_ms, same_bits)


def load_parent_library(root: str) -> ctypes.CDLL:
    """Build and load the kernel library of the checkout at ``root``."""
    spec = importlib.util.spec_from_file_location(
        "parent_kernels_build",
        Path(root) / "fesom2_tpu_torch" / "kernels" / "build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = ctypes.CDLL(str(mod.build()))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.fesom_node_edge_reduce.argtypes = [P, I, I, P, P, I, I, P, P, I, I, P]
    lib.fesom_onehot_gather.argtypes = [P, P, I, I, I, I, P, P]
    for fn in (lib.fesom_node_edge_reduce, lib.fesom_onehot_gather):
        fn.restype = ctypes.c_int
    return lib


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def parent_node_edge_reduce(lib, flux, mesh, pair: bool):
    """The first design's kernel: one thread per (row, node) on the
    ``node_edges`` and ``node_edge_sign`` tables."""
    f = flux.reshape(-1, flux.shape[-1]).contiguous()
    R, Ed = f.shape
    N, KE = mesh.node_edges.shape
    out0 = torch.empty((R, N), dtype=f.dtype, device=f.device)
    out1 = torch.empty_like(out0) if pair else None
    err = lib.fesom_node_edge_reduce(
        f.data_ptr(), R, Ed, mesh.node_edges.data_ptr(),
        mesh.node_edge_sign.data_ptr(), N, KE, out0.data_ptr(),
        out1.data_ptr() if pair else None, int(pair),
        int(f.dtype == torch.float64), _stream())
    if err:
        raise RuntimeError(f"parent node_edge_reduce: CUDA error {err}")
    shape = flux.shape[:-1] + (N,)
    if pair:
        return out0.reshape(shape), out1.reshape(shape)
    return out0.reshape(shape)


def parent_onehot_gather(lib, vals, idx):
    G, W, NL = vals.shape
    T = idx.shape[1]
    out = torch.empty((G, T, NL), dtype=torch.float32, device=vals.device)
    err = lib.fesom_onehot_gather(vals.data_ptr(), idx.data_ptr(), G, W, T,
                                  NL, out.data_ptr(), _stream())
    if err:
        raise RuntimeError(f"parent onehot_gather: CUDA error {err}")
    return out


def device_us(fn) -> float:
    """Device microseconds per call: all CUDA kernels fn() launches."""
    return sum(device_kernels_us(fn).values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--level", type=int, default=7)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--parent", default="")
    ap.add_argument("--mesh-dir", default="build/gather_kernel_times")
    ap.add_argument("--row-target-blocks", type=int, default=0)
    ap.add_argument("--skip-channels", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gather_kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    from fesom2_tpu_torch import kernels
    from fesom2_tpu_torch.core import ops, tracers
    from fesom2_tpu_torch.mesh import build_mesh, build_mesh_from_raw, cluster
    from fesom2_tpu_torch.mesh.channel import channel_raw_mesh
    from fesom2_tpu_torch.mesh.globe import NUMBERINGS, write_globe
    from fesom2_tpu_torch.scripts import gather_cost_model as probe
    cluster.ROW_TARGET_BLOCKS = (args.row_target_blocks
                                 or cluster.ROW_TARGET_BLOCKS)
    torch.backends.cuda.matmul.allow_tf32 = False

    card = card_name()
    dev = torch.device("cuda", 0)
    sink = open(args.out, "w") if args.out else None
    failed = []

    def emit(**row):
        line = json.dumps({"card": card,
                           "row_target_blocks": cluster.ROW_TARGET_BLOCKS,
                           **row})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    kernels.library()
    parent = load_parent_library(args.parent) if args.parent else None
    rng = np.random.default_rng(5)

    def in_turns(new, old):
        """new, old, old, new: device us (profiler), us per call of a batch
        between two events, median us of single calls between events."""
        runs = [("new", new)] + ([("old", old), ("old", old)] if old else []) \
            + [("new", new)]
        out = {"new": [], "old": []}
        for name, fn in runs:
            out[name].append({"device_us": device_us(fn),
                              "batch_us": batch_ms(fn) * 1e3,
                              "events_us": events_ms(fn, args.reps) * 1e3})
        return out

    # ---- the mesh kernels ------------------------------------------------
    def mesh_of(label, dtype):
        if label.startswith("channel"):
            nx, ny = map(int, label.split()[1].split("x"))
            return build_mesh_from_raw(channel_raw_mesh(nx, ny),
                                       cyclic_length_deg=4.5, dtype=dtype,
                                       device=dev)
        path = write_globe(f"{args.mesh_dir}/l{args.level}_{label.split()[1]}",
                           level=args.level, numbering=label.split()[1])
        return build_mesh(path, force_rotation=True, cyclic_length_deg=360.0,
                          use_partial_cell=True, dtype=dtype, device=dev)

    labels = [f"globe {n}" for n in NUMBERINGS]
    if not args.skip_channels:
        labels += ["channel 25x115", "channel 100x460"]
    for label in labels:
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            tag = str(dtype).replace("torch.", "")
            t0 = time.perf_counter()
            mesh = mesh_of(label, dtype)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            L, N, E, Ed = mesh.nl - 1, mesh.n_nodes, mesh.n_elems, mesh.n_edges
            if dtype == torch.float64:
                for what, table in (("edges", mesh.node_edges),
                                    ("elements", mesh.nod_in_elem),
                                    ("neighbour nodes", mesh.node_neighbors)):
                    emit(mesh=label, nodes=N, table=what,
                         build_mesh_s=setup_s, per_tile_of_256={
                             f"float{8 * b}": cluster.table_tile_stats(
                                 table, 256, b) for b in (8, 4)})

            def rand(*shape, lo=-1.0, hi=1.0):
                return torch.as_tensor(rng.uniform(lo, hi, shape),
                                       device=dev).to(dtype)

            flux = rand(2, L, Ed)
            cases = [
                ("node_edge_reduce div", flux, False),
                ("node_edge_reduce pair", flux, True),
                ("node_edge_reduce div one row", flux[0, 0].contiguous(),
                 False)]
            for name, f, pair in cases:
                new = (lambda f=f: ops.edge_signed_reduce2(f, mesh)) if pair \
                    else (lambda f=f: ops.edge_divergence(f, mesh))
                plain = (ops.edge_signed_reduce2_plain if pair
                         else ops.edge_divergence_plain)
                old = None
                if parent is not None:
                    old = lambda f=f, pair=pair: parent_node_edge_reduce(
                        parent, f, mesh, pair)
                got, want = as_tuple(new()), as_tuple(plain(f, mesh))
                rel = max(float((g - w).abs().max() / w.abs().max())
                          for g, w in zip(got, want))
                equal_old = None if old is None else all(
                    same_bits(g, o) for g, o in zip(got, as_tuple(old())))
                work = ops.node_edge_reduce_work(
                    f.numel() // Ed, Ed, N, mesh.node_edges.shape[1], pair,
                    f.element_size())
                emit(mesh=label, case=f"{name} {list(f.shape)}", dtype=tag,
                     rel_err=rel, agrees=rel <= tol,
                     equals_parent_bitwise=equal_old,
                     bound_us=kernels.bound_ms(work, dtype)[0] * 1e3,
                     **in_turns(new, old))
                if rel > tol or equal_old is False:
                    failed.append(f"{label} {name} {tag}")
            if label.startswith("channel"):
                continue
            x = rand(2, L, E)
            ttf, lo_ = rand(2, L, N, lo=0, hi=30), rand(2, L, N, lo=0, hi=30)
            ne = mesh.node_edges.long().clamp_min(0).T.contiguous()
            ct = mesh.cluster
            for name, fn, work in (
                    (f"elem_to_node_mean {[2, L, E]}",
                     lambda: ops.elem_to_node_mean(x, mesh),
                     ops.elem_to_node_mean_work(
                         2, L, E, N, mesh.nod_in_elem.shape[1],
                         x.element_size(), ct.mean_tile_elems.numel(),
                         ct.tile_nodes)),
                    (f"fct_bounds {[2, L, N]}",
                     lambda: tracers.fct_bounds(ttf, lo_, mesh),
                     tracers.fct_bounds_work(
                         2, L, N, ct.fct_slot.shape[0], x.element_size(),
                         ct.fct_tile_nodes.numel(), ct.tile_nodes)),
                    (f"torch gather flux[..., node_edges] {[2, L, Ed]}",
                     lambda: flux[..., ne], None)):
                emit(mesh=label, case=name, dtype=tag,
                     bound_us=work and kernels.bound_ms(work, dtype)[0] * 1e3,
                     **in_turns(fn, None))

    # ---- the probe's one-hot product --------------------------------------
    vals, idx = (torch.as_tensor(a, device=dev)
                 for a in probe.probe_inputs(**probe.PROBE_SHAPE))
    G, W, NL = vals.shape
    T = idx.shape[1]
    out_of_window = idx.clone()
    out_of_window[0, 0], out_of_window[7, 100] = W, W + 1000
    out_of_window[300, 255] = -W - 1
    checks = {}
    for name, i in (("in_window", idx), ("three_outside", out_of_window)):
        outs = [probe.onehot_gather(vals, i), probe.window_gather(vals, i),
                probe.window_gather_plain(vals, i),
                probe.onehot_gather_plain(vals, i)]
        if parent is not None:
            outs.append(parent_onehot_gather(parent, vals, i))
        checks[name] = all(same_bits(outs[0], o) for o in outs[1:])
        checks[name + "_nan_rows"] = int(outs[0].isnan().any(-1).sum())
    if not all(v for k, v in checks.items() if not k.endswith("rows")):
        failed.append("onehot_gather")
    # what a product cannot return as the gather does
    odd = vals.clone()
    odd[0, :, 0] = -0.0
    odd[1] = odd[1] * 2.0 ** -120
    got, want = probe.onehot_gather(odd, idx), probe.window_gather(odd, idx)
    checks["minus_zero_comes_out_positive"] = not bool(
        torch.signbit(got[0, :, 0]).any())
    checks["rest_of_tile_0_bitwise"] = same_bits(got[0, :, 1:], want[0, :, 1:])
    checks["tiny_tile_max_abs_diff"] = float((got[1] - want[1]).abs().max())
    checks["tiny_tile_emulation_bitwise"] = same_bits(
        got[1], probe.onehot_gather_emulation(odd[1:2], idx[1:2])[0])
    onehot = (idx.long()[..., None] == torch.arange(W, device=dev)).to(
        vals.dtype)
    old = None
    if parent is not None:
        old = lambda: parent_onehot_gather(parent, vals, idx)
    turns = in_turns(lambda: probe.onehot_gather(vals, idx), old)
    bmm = lambda: torch.bmm(onehot, vals)
    rows_read = int(torch.unique(
        idx.long() + W * torch.arange(G, device=dev)[:, None]).numel())
    emit(case="onehot_gather G,W,T,NL " + ",".join(
        map(str, probe.PROBE_SHAPE.values())), dtype="float32", checks=checks,
        gather_bound_us=kernels.bound_ms(probe.window_gather_work(
            G, T, NL, rows_read), torch.float32)[0] * 1e3,
        method_bound_us=kernels.bound_ms(
            probe.onehot_gather_work(G, W, T, NL), torch.float32,
            kernels.PEAK_TENSOR_FLOPS[torch.bfloat16])[0] * 1e3,
        window_gather=in_turns(lambda: probe.window_gather(vals, idx),
                               None)["new"],
        torch_bmm=[{"device_us": device_kernels_us(bmm),
                    "batch_us": batch_ms(bmm, 50) * 1e3,
                    "events_us": events_ms(bmm, args.reps) * 1e3}
                   for _ in range(2)],
        **turns)
    if sink:
        sink.close()
    if failed:
        print(f"gather_kernel_times: FAILED {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
