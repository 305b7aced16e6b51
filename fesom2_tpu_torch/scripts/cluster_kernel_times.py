"""Time the two ``nod_in_elem`` cluster kernels on a code-built globe.

    python -m fesom2_tpu_torch.scripts.cluster_kernel_times [--level 7]
        [--reps 30] [--label NAME] [--mesh-dir DIR] [--tile NODES]
        [--target-blocks B] [--min-planes P] [--channel NXxNY]

On one CUDA card: builds the globe of ``mesh/globe.py`` at ``--level``
(7: 114,033 nodes, 47 layers), then for float64 and float32 holds
``ops.elem_to_node_mean`` (layered with 1, 2 and 4 rows, the level mask on
and off; flat) and ``tracers.fct_bounds`` (1 and 2 tracers) against their
plain versions and times each with CUDA events (median of ``--reps`` after
warm-up), with the device time of every CUDA kernel the call launches
from ``torch.profiler``.  One JSON object per case on standard output.
``--tile`` rebuilds the mesh's cluster tables for that many nodes per
block of the tiled kernels (default: ``mesh.cluster.TILE_NODES``);
``--target-blocks`` and ``--min-planes`` set the two constants of
``mesh.cluster.level_chunk`` (levels per block) for this run; ``--channel
25x115`` times the soufflet channel of that many nodes across and along
(40 layers; 25x115 and 100x460 are the two ``chip_smoke.py`` runs) in
place of the globe.

It calls only the wrappers and ``mesh.build_mesh``, so the same file
times another checkout of the package when that checkout leads
``PYTHONPATH``: run two versions in turns within one job to compare them
on one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

if __package__:
    from . import timing
else:                   # run as a file, another checkout leading PYTHONPATH
    import timing


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--level", type=int, default=7)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--label", default="")
    ap.add_argument("--mesh-dir", default="build/cluster_kernel_times/globe")
    ap.add_argument("--tile", type=int, default=0)
    ap.add_argument("--target-blocks", type=int, default=0)
    ap.add_argument("--min-planes", type=int, default=0)
    ap.add_argument("--channel", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cluster_kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    from fesom2_tpu_torch.core import ops, tracers
    from fesom2_tpu_torch.mesh import build_mesh, build_mesh_from_raw, cluster
    from fesom2_tpu_torch.mesh.channel import channel_raw_mesh
    from fesom2_tpu_torch.mesh.globe import write_globe
    cluster.TARGET_BLOCKS = args.target_blocks or cluster.TARGET_BLOCKS
    cluster.MIN_PLANES = args.min_planes or cluster.MIN_PLANES

    card = timing.card_name()
    dev = torch.device("cuda", 0)
    if not args.channel:
        path = write_globe(f"{args.mesh_dir}_l{args.level}", level=args.level)
    rng = np.random.default_rng(4)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        if args.channel:
            nx, ny = map(int, args.channel.split("x"))
            mesh = build_mesh_from_raw(channel_raw_mesh(nx, ny),
                                       cyclic_length_deg=4.5, dtype=dtype,
                                       device=dev)
        else:
            mesh = build_mesh(path, force_rotation=True,
                              cyclic_length_deg=360.0, use_partial_cell=True,
                              dtype=dtype, device=dev)
        if args.tile:
            mesh = dataclasses.replace(
                mesh, cluster=cluster.build_cluster_tables(mesh, args.tile))
        L, N, E = mesh.nl - 1, mesh.n_nodes, mesh.n_elems

        def rand(*shape, lo=-1.0, hi=1.0):
            return torch.as_tensor(rng.uniform(lo, hi, shape),
                                   device=dev).to(dtype)

        Case = timing.Case
        cases = []
        for rows, lev in ((1, True), (2, True), (4, True), (2, False)):
            x = rand(rows, L, E)
            cases.append(Case(
                lambda x=x, lev=lev: ops.elem_to_node_mean(x, mesh, lev),
                lambda x=x, lev=lev: ops.elem_to_node_mean_plain(x, mesh, lev),
                False, {"case": f"elem_to_node_mean levels={lev} "
                                f"{[rows, L, E]}"}))
        xs = rand(2, E)
        cases.append(Case(lambda: ops.elem_to_node_mean_flat(xs, mesh),
                          lambda: ops.elem_to_node_mean_flat_plain(xs, mesh),
                          False, {"case": f"elem_to_node_mean flat {[2, E]}"}))
        for ntr in (1, 2):
            ttf, lo_ = rand(ntr, L, N, lo=0, hi=30), rand(ntr, L, N, lo=0,
                                                          hi=30)
            ttf[0, L // 2, N // 2] = float("nan")
            cases.append(Case(
                lambda a=ttf, b=lo_: tracers.fct_bounds(a, b, mesh),
                lambda a=ttf, b=lo_: tracers.fct_bounds_plain(a, b, mesh),
                True, {"case": f"fct_bounds {[ntr, L, N]}"}))

        def timings(c):
            return {"kernel_ms": timing.events_ms(c.kern, args.reps),
                    "plain_ms": timing.events_ms(c.plain,
                                                 max(args.reps // 6, 3), 1),
                    "device_us": timing.device_kernels_us(c.kern)}
        if not timing.run_cases(
                cases, tol, timings, label=args.label, tile=args.tile,
                target_blocks=cluster.TARGET_BLOCKS,
                min_planes=cluster.MIN_PLANES, card=card,
                dtype=str(dtype).replace("torch.", "")):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
