"""Async forcing prefetch: background-thread lookahead of the next forcing
timestep while the current one is consumed.

Reference: ``src/forcing_provider_async_module.F90:35-133`` (per-variable
double-buffered readers + one prefetch thread each),
``forcing_lookahead_reader_module.F90:41-127`` (timestep cache),
``forcing_provider_netcdf_module.F90:24-154`` (netCDF record access).

Design note: the default pipeline (``forcing/atmos.py``) preloads a whole
year of forcing to the device and interpolates it in time there, with no
host read in the step.  This provider covers the reference's use case of
forcing series too large to preload: host-side record streaming with the
next record read on a Python thread (file IO releases the GIL) so the
read overlaps device compute.  The coupled step wires neither it nor the
JAX package's copy.

The port's own copy of ``fesom2_tpu/forcing/prefetch.py``, kept
line for line (the port imports nothing of the JAX package;
``tests/test_torch_forcing_files.py`` holds the two equal).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np

PREFETCH_SIZE = 1      # how many steps ahead to read (ref :96)


class TimestepReader:
    """Random access to one record variable of a netCDF file
    (ref forcing_provider_netcdf_module).  mmap keeps records lazy."""

    def __init__(self, filepath: str, varname: str):
        from scipy.io import netcdf_file
        self.filepath = filepath
        self.varname = varname
        self._nc = netcdf_file(filepath, "r", mmap=True)
        self._var = self._nc.variables[varname]
        self.n_timesteps = self._var.shape[0]

    def read(self, time_index: int) -> np.ndarray:
        return np.array(self._var[time_index])

    def close(self):
        self._var = None       # release the mmap view so close() is clean
        try:
            self._nc.close()
        except Exception:
            pass


class LookaheadReader:
    """Single-variable reader with a one-slot prefetch cache filled by a
    background thread (ref forcing_lookahead_reader_module:41-127)."""

    def __init__(self, filepath: str, varname: str, async_allowed: bool = True):
        self._reader = TimestepReader(filepath, varname)
        self.n_timesteps = self._reader.n_timesteps
        self._async = async_allowed
        self._cache: Dict[int, np.ndarray] = {}
        self._thread: Optional[threading.Thread] = None
        self._thread_index = -1
        self._lock = threading.Lock()

    # -- internal ----------------------------------------------------------
    def _join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            self._thread_index = -1

    def _prefetch_target(self, idx: int):
        data = self._reader.read(idx)
        with self._lock:
            self._cache = {idx: data}          # single-slot cache

    # -- API ----------------------------------------------------------------
    def yield_data(self, time_index: int) -> np.ndarray:
        """Return record ``time_index``; from cache if the prefetch thread
        already fetched it, else synchronously.  Then kick off the read of
        ``time_index + PREFETCH_SIZE`` in the background."""
        if self._thread_index == time_index:
            self._join()
        with self._lock:
            data = self._cache.pop(time_index, None)
        if data is None:
            self._join()                       # don't race the mmap handle
            data = self._reader.read(time_index)
        nxt = time_index + PREFETCH_SIZE
        if self._thread is None and nxt < self.n_timesteps:
            if self._async:
                self._thread_index = nxt
                self._thread = threading.Thread(
                    target=self._prefetch_target, args=(nxt,), daemon=True)
                self._thread.start()
            else:
                self._prefetch_target(nxt)
        return data

    def close(self):
        self._join()
        self._reader.close()


class AsyncForcingProvider:
    """Registry of per-(file, variable) lookahead readers
    (ref get_forcingdata, forcing_provider_async_module.F90:35-103).
    Re-opens on a year (file path) change like the reference."""

    def __init__(self, async_allowed: bool = True):
        self._async = async_allowed
        self._readers: Dict[str, Tuple[str, LookaheadReader]] = {}

    def get(self, filepath: str, varname: str, time_index: int) -> np.ndarray:
        key = varname
        entry = self._readers.get(key)
        if entry is None or entry[0] != filepath:
            if entry is not None:
                entry[1].close()
            entry = (filepath, LookaheadReader(filepath, varname,
                                               self._async))
            self._readers[key] = entry
        return entry[1].yield_data(time_index)

    def close(self):
        for _, r in self._readers.values():
            r.close()
        self._readers.clear()
