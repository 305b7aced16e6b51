"""fcheck-style golden checking of run output: the mean of every output
field of a run against a golden set (the reference CI's ``fcheck .``
against the ``fcheck:`` block of ``setups/test_pi/setup.yml``).

The port of ``fesom2_tpu/post/fcheck.py``, read through the port's
``io/netcdf.py``.  Usage:

    python -m fesom2_tpu_torch.post.fcheck RESULT_DIR GOLDEN_YAML [--rtol 1e-4]
    python -m fesom2_tpu_torch.post.fcheck RESULT_DIR GOLDEN_YAML --record

The JAX ``field_means`` skips any file or variable that fails to read; this one
skips only what is not one of the run's mean streams (the mesh
description ``fesom.mesh.diag*.nc`` and files not named as a stream,
``<variable>.<runid>.<year>.nc``, such as ``restart.nc``) and raises on a
stream file it cannot read: a broken output file must not turn into a
missing mean.
"""
from __future__ import annotations

import glob
import os
import re
import sys

import numpy as np

from ..io.netcdf import list_vars, read_vars

# <variable>.<runid>.<year>.nc (io/streams.py: OutputStreams.flush)
_STREAM_FILE = re.compile(r"^.+\.[^.]+\.\d+\.nc$")


def field_means(result_path: str) -> dict:
    """Mean over all finite values of every variable of every stream file
    under ``result_path`` (the time axis and ``*_bnds`` excluded); a later
    file's variable of the same name replaces an earlier one's, as in the
    JAX function."""
    means = {}
    for path in sorted(glob.glob(os.path.join(result_path, "*.nc"))):
        base = os.path.basename(path)
        if base.startswith("fesom.mesh.diag") or not _STREAM_FILE.match(base):
            continue
        for name in list_vars(path):
            if name == "time" or name.endswith("_bnds"):
                continue
            arr = np.asarray(read_vars(path, [name])[name], dtype=float)
            ok = np.isfinite(arr)
            if ok.any():
                means[name] = float(arr[ok].mean())
    return means


def load_goldens(path: str) -> dict:
    """Parse the flat ``fcheck:``-style mapping from a (simple) yaml file:
    lines of ``  name: value`` under an ``fcheck:`` key, or a whole-file
    flat mapping."""
    gold = {}
    in_block = None
    with open(path) as f:
        for line in f:
            stripped = line.split("#")[0].rstrip()
            if not stripped:
                continue
            body = stripped.strip()
            if body.endswith(":") and ":" not in body[:-1]:
                in_block = body[:-1]
                continue
            if ":" in body:
                k, v = body.split(":", 1)
                try:
                    val = float(v.strip())
                except ValueError:
                    in_block = None
                    continue
                if in_block in (None, "fcheck"):
                    gold[k.strip()] = val
    return gold


def fcheck(result_path: str, golden_path: str, rtol: float = 1e-4,
           atol: float = 1e-12, verbose: bool = True) -> bool:
    """Compare a run's output means to the goldens; True if all pass (a
    golden without an output field fails)."""
    means = field_means(result_path)
    gold = load_goldens(golden_path)
    ok_all = True
    for name, val in sorted(gold.items()):
        if name not in means:
            ok_all = False
            if verbose:
                print(f"MISSING  {name}: golden {val} but no output field")
            continue
        got = means[name]
        ok = abs(got - val) <= rtol * abs(val) + atol
        ok_all &= ok
        if verbose:
            mark = "OK  " if ok else "FAIL"
            print(f"{mark}  {name}: got {got!r}, golden {val!r}")
    return ok_all


def write_goldens(result_path: str, out_path: str):
    """Record a run's output means as a golden yaml (an fcheck block)."""
    means = field_means(result_path)
    with open(out_path, "w") as f:
        f.write("fcheck:\n")
        for k, v in sorted(means.items()):
            f.write(f"  {k}: {v!r}\n")


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="golden-mean output check")
    p.add_argument("result")
    p.add_argument("golden")
    p.add_argument("--rtol", type=float, default=1e-4)
    p.add_argument("--record", action="store_true",
                   help="write goldens from the result instead of checking")
    args = p.parse_args(argv)
    if args.record:
        write_goldens(args.result, args.golden)
        return
    ok = fcheck(args.result, args.golden, rtol=args.rtol)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
