"""The mean of every output field of a run, for the golden check of
``mkrun``.

The port of ``field_means`` of ``fesom2_tpu/post/fcheck.py:21-44``, read
through the port's ``io/netcdf.py``; the rest of ``post/`` is not ported.
The JAX function skips any file or variable that fails to read; this one
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
