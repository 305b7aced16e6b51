"""Time ``csrc/kpp_column.cu`` beside copies of it with one phase cut out,
to see what each phase costs on the card.

    python -m fesom2_tpu_torch.scripts.kpp_variants [--level 7]
        [--turns 2] [--variants kernel,no_ab,no_c]

Each variant is the kernel's source with a few lines replaced (a
replacement that no longer matches the source fails the script); each is
built by its own ``nvcc`` (all started together, the package's flags)
into ``build/kpp_variants/`` and called through the package's wrapper in
place of the package's library.  On the level-7 globe of
``scripts/column_kernel_times.py`` (its state and inputs), float64 and
float32, double diffusion off and on, the variants are timed in turns:
the profiler's device time over 10 calls and us a call over a batch of
20 calls between two events.  One JSON object per variant and case, with
the outputs' SHA-256 (a cut variant computes other numbers), then one per
variant with the ``ptxas`` lines of its build.

- ``kernel``: the source as it is;
- ``no_ab``: phase (a, b) (interior mixing, bulk Richardson number) left
  out: the staged N^2 and dbsfc stand in for its results;
- ``no_c``: phases (c1) to (c3) left out: kbl is min(nlevels - 1, 3) and
  the per-column values are what shared memory holds.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from . import timing
from .column_kernel_times import globe_state, kpp_inputs

VARIANTS = {
    "kernel": [],
    "no_ab": [("  if (active) {\n    const T sigma0",
               "  if (false) {\n    const T sigma0")],
    "no_c": [("  if (active && ty == 0) {\n    const int first",
              "  if (false) {\n    const int first"),
             ("  if (active && ty % kRowsPerWarp == 0 && ty / kRowsPerWarp < 7)",
              "  if (false)"),
             ("  if (active && ty % kRowsPerWarp == 0 && ty / kRowsPerWarp "
              "< (dd ? 3 : 2))", "  if (false)"),
             ("  const int kbl = active ? kbl_s[tx] : 0;",
              "  const int kbl = nln1 > 3 ? 3 : nln1;")],
}


def build_variant(name: str, out_dir: Path) -> tuple:
    """(library path, ptxas lines) of one variant, built with the
    package's nvcc flags; raises with the compiler's output on failure."""
    return timing.build_source_variant("kpp_column.cu", name, VARIANTS[name],
                                       out_dir)


def as_library(path: Path):
    """A stand-in for the package's library that holds kpp_column only."""
    from fesom2_tpu_torch import kernels
    fn = ctypes.CDLL(str(path)).fesom_kpp_column
    fn.argtypes = kernels._ARGTYPES["kpp_column"]
    fn.restype = ctypes.c_int
    return types.SimpleNamespace(fesom_kpp_column=fn,
                                 fesom_error_string=lambda err: b"")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--level", type=int, default=7)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--mesh-dir", default="build/column_kernel_times/globe")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kpp_variants: needs a CUDA card", file=sys.stderr)
        return 1
    from fesom2_tpu_torch import kernels
    from fesom2_tpu_torch.core.mixing import kpp
    from fesom2_tpu_torch.mesh import globe

    names = args.variants.split(",")
    out_dir = Path("build/kpp_variants")
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(
            lambda v: build_variant(v, out_dir), names)))
    libs = {v: as_library(lib) for v, (lib, _) in built.items()}
    package = kernels.library()
    card = timing.card_name()
    dev = torch.device("cuda", 0)
    path = globe.write_globe(f"{args.mesh_dir}_l{args.level}",
                             level=args.level)
    for dtype in (torch.float64, torch.float32):
        kernels._LIB = package
        mesh, st, dref, fx, cfg = globe_state(path, dtype, dev,
                                              np.random.default_rng(7))
        for dd in (False, True):
            kernels._LIB = package
            inputs = kpp_inputs(mesh, st, dref, fx, cfg, dd)
            call = lambda: kpp.kpp_column(*inputs)
            rows = {}
            for _ in range(args.turns):
                for v, lib in libs.items():
                    kernels._LIB = lib
                    outs = timing.as_tuple(call())
                    device = sum(us for key, us in timing.device_kernels_us(
                        call).items() if "kpp_column" in key)
                    batch = timing.batch_ms(call, 20, 3) * 1e3
                    row = rows.setdefault(v, {"device_us": [],
                                              "batch_us": []})
                    row["device_us"].append(device)
                    row["batch_us"].append(batch)
                    row["sha256"] = timing.digest(outs)
            for v, row in rows.items():
                print(json.dumps({"variant": v, "card": card,
                                  "dtype": str(dtype).replace("torch.", ""),
                                  "dd": dd, **row}), flush=True)
    kernels._LIB = package
    for v, (_, ptxas) in built.items():
        print(json.dumps({"variant": v, "ptxas": ptxas}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
