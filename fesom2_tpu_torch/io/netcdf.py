"""Minimal netCDF access: classic (netCDF3) via scipy, netCDF4/HDF5 via h5py.

Replaces the reference's netCDF helper layer (``gen_modules_read_NetCDF.F90``,
``forcing_provider_netcdf_module.F90``); output files are written as classic
netCDF3 which every downstream tool reads.

The port's own copy of ``fesom2_tpu/io/netcdf.py``, kept
line for line (the port imports nothing of the JAX package;
``tests/test_torch_forcing_files.py`` holds the two equal).
"""
from __future__ import annotations

import numpy as np


def read_vars(path: str, names, missing_ok: bool = False):
    """Read variables (dict name->ndarray). Tries netCDF3 then HDF5.

    missing_ok: skip names absent from the file (restart files written by
    older revisions may lack newly-added state fields)."""
    try:
        from scipy.io import netcdf_file
        nc = netcdf_file(path, "r", mmap=False)
        try:
            out = {}
            for n in names:
                if missing_ok and n not in nc.variables:
                    continue
                v = nc.variables[n]
                out[n] = np.array(v[:])
            return out
        finally:
            nc.close()
    except Exception:
        import h5py
        out = {}
        with h5py.File(path, "r") as h:
            for n in names:
                if missing_ok and n not in h:
                    continue
                out[n] = np.array(h[n])
        return out


def list_vars(path: str):
    try:
        from scipy.io import netcdf_file
        nc = netcdf_file(path, "r", mmap=False)
        names = list(nc.variables)
        nc.close()
        return names
    except Exception:
        import h5py
        with h5py.File(path, "r") as h:
            return list(h.keys())


def write_dataset(path: str, dims: dict, variables: dict, attrs: dict = None):
    """Write a classic netCDF3 file.

    dims: {name: size or None (unlimited)}
    variables: {name: (dim_names tuple, ndarray)}
    """
    from scipy.io import netcdf_file
    nc = netcdf_file(path, "w")
    for d, s in dims.items():
        nc.createDimension(d, s)
    for name, (dnames, arr) in variables.items():
        arr = np.asarray(arr)
        if arr.dtype == np.int64:
            arr = arr.astype(np.int32)     # classic netCDF has no 64-bit int
        elif arr.dtype == np.float16:
            arr = arr.astype(np.float32)
        elif arr.dtype == np.bool_:
            arr = arr.astype(np.int8)
        var = nc.createVariable(name, arr.dtype, dnames)
        var[:] = arr
    if attrs:
        for k, v in attrs.items():
            setattr(nc, k, v)
    nc.close()
