"""Registry and loader of the hand-written CUDA kernels.

``LAUNCHES`` counts, per kernel, the launches made by its wrapper (the
wrappers live beside their plain torch versions, in ``core/ops.py`` and
``core/tracers.py``).  The library is built and loaded on the first
launch, never at import: the CPU path needs neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes

import torch

KERNELS = ("node_edge_reduce", "elem_to_node_mean", "tridiag_solve",
           "fct_bounds")
LAUNCHES = {name: 0 for name in KERNELS}

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures, in argument order (see csrc/*.cu); the last is the stream
_ARGTYPES = {
    "node_edge_reduce": [_P, _I, _I, _P, _P, _I, _I, _P, _P, _I, _I, _P],
    "elem_to_node_mean": [_P, _I, _I, _I, _P, _I, _I, _P, _P, _P, _I, _P],
    "tridiag_solve": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _P],
    "fct_bounds": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P,
                   _P, _P, _P, _I, _P],
}
_LIB = None


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    global _LIB
    if _LIB is None:
        from .build import build
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, "fesom_" + name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.fesom_error_string.argtypes = [ctypes.c_int]
        lib.fesom_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def require(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of this shape, dtype and
    device (what a kernel reads through a raw pointer)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def float_code(dtype) -> int:
    """1 for float64, 0 for float32; any other dtype raises."""
    if dtype == torch.float64:
        return 1
    if dtype == torch.float32:
        return 0
    raise ValueError(f"kernels take float32 or float64, not {dtype}")


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel ``name`` on the current stream of ``device``: tensors
    are passed as pointers, ints as ints.  Raises on a refused launch."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                 for a in args]
        err = getattr(lib, "fesom_" + name)(*cargs, stream)
    if err != 0:
        raise RuntimeError(f"kernel {name}: CUDA error {err} "
                           f"({lib.fesom_error_string(err).decode()})")
    LAUNCHES[name] += 1


def cuda_only(x: torch.Tensor, what: str) -> None:
    """Raise unless ``x`` lies on a CUDA device (the only non-CPU device
    the kernels serve)."""
    if x.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {x.device}")
