"""The readings that the limits of ``check.py`` are set from, in one
process: for each seed, the program's gaps against the plain reference
(the lower readings) and, for the control seeds, the control's: the
reference itself computed in float32, the next precision below the
configuration's float64, put in the program's place (the upper readings).

    python -m ocean_bench.control --workload NAME --seeds 1 2 3 ... \\
        [--control-seeds 1 2 3] [--calls 3]

For each seed the program runs its warm-up call from step 0 and ``calls``
more (as a window would), then one last call; the reference runs its own
first call from its own set-up (``start_gap``) and the last call from the
program's state before it (``step_gap``).  The tables of the program and of
both references are built once and serve every seed (only the atmosphere
and the initial state depend on the seed).  One JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import check, spec
from .run import Program


def readings(cell, seeds, control_seeds=(), calls: int = 3,
             device="cuda", level=None, fields: bool = False,
             witness=()):
    """Yield one dict a seed: the program's gaps (``check.gaps``), and,
    for a control seed, the float32 control's; with ``fields``, each
    field's gaps too (``check.gap_table``); for a seed in ``witness``,
    each field's gaps between the reference and itself, from its own
    initial state and from the program's state before the last call, each
    nudged by one rounding unit."""
    dev = torch.device(device)
    dtype = getattr(torch, cell.config["physics"]["dtype"])
    c = cell.traffic["steps_per_call"]
    prog = Program(cell, dev, seeds[0], level)
    mdir = str(prog.mdir)
    ref = check.Reference(mdir, cell, seeds[0], dev, dtype)
    low = check.Reference(mdir, cell, seeds[0], dev, torch.float32) \
        if control_seeds else None
    for seed in seeds:
        t = time.perf_counter()
        prog.reseed(seed)
        out = prog.call(prog.initial(), 0, c)
        first = check.snapshot(*out)
        for i in range(calls):
            out = prog.call(out, (1 + i) * c, c)
        k = (1 + calls) * c
        before = check.snapshot(*out)
        after = check.snapshot(*prog.call(out, k, c))
        del out
        ref.reseed(seed)
        r_first = check.snapshot(*ref.steps(*ref.initial(), 0, c))
        r_after = check.snapshot(*ref.steps(*ref.load(before), k, c))
        row = {"seed": seed, "step": k}
        row.update(check.gaps(cell, first, r_first, after, r_after))
        if fields:
            row["start_fields"] = check.gap_table(first, r_first)
            row["step_fields"] = check.gap_table(after, r_after)
        if seed in control_seeds:
            low.reseed(seed)
            l_first = check.snapshot(*low.steps(*low.initial(), 0, c))
            l_after = check.snapshot(*low.steps(*low.load(before), k, c))
            row.update({f"control_{n}": v for n, v in check.gaps(
                cell, l_first, r_first, l_after, r_after).items()})
            if fields:
                row["control_start_fields"] = check.gap_table(l_first,
                                                              r_first)
                row["control_step_fields"] = check.gap_table(l_after,
                                                             r_after)
        if seed in witness:
            # the reference against itself, its start nudged by one
            # rounding unit: how far rounding alone moves each field
            def nudged(snap):
                return ref.load({g: {n: v * (1 + torch.finfo(v.dtype).eps)
                                     if v.is_floating_point() else v
                                     for n, v in fields_.items()}
                                 for g, fields_ in snap.items()})
            n_first = check.snapshot(*ref.steps(
                *nudged(check.snapshot(*ref.initial())), 0, c))
            n_after = check.snapshot(*ref.steps(*nudged(before), k, c))
            row["witness_start_fields"] = check.gap_table(n_first, r_first)
            row["witness_step_fields"] = check.gap_table(n_after, r_after)
        row["seconds"] = time.perf_counter() - t
        yield row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--calls", type=int, default=3)
    p.add_argument("--fields", action="store_true",
                   help="print each field's gaps too")
    p.add_argument("--witness", type=int, nargs="*", default=[],
                   help="seeds whose reference is also run against itself "
                        "from states nudged by one rounding unit")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: CUDA is not available", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    for row in readings(cell, args.seeds, args.control_seeds, args.calls,
                        fields=args.fields, witness=args.witness):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
