"""Registry and loader of the hand-written CUDA kernels.

``LAUNCHES`` counts, per kernel, the launches made by its wrapper (the
wrappers live beside their plain torch versions, in ``core/ops.py``,
``core/tracers.py``, ``core/ssh.py``, ``core/eos.py``,
``core/mixing/kpp.py`` and ``scripts/gather_cost_model.py``).  The library is built and loaded on the first
launch, never at import: the CPU path needs neither ``nvcc`` nor a card.

Beside each wrapper a ``*_work`` function counts, from shapes alone, the
bytes the function must move and the operations it does; ``bound_ms``
turns the pair into the card's least time for the call.
"""
from __future__ import annotations

import ctypes

import torch

KERNELS = ("node_edge_reduce", "elem_to_node_mean", "tridiag_solve",
           "fct_bounds", "ring_spmv", "block_schwarz", "window_gather",
           "onehot_gather", "pressure_bv", "kpp_column",
           "elem_contrib_to_nodes", "mevp_stress", "mevp_node")
# the source of each kernel under csrc/, where it is not <name>.cu
SOURCES = {"mevp_stress": "mevp_subcycle.cu", "mevp_node": "mevp_subcycle.cu"}
LAUNCHES = {name: 0 for name in KERNELS}

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# C signatures by entry point, in argument order (see csrc/*.cu); the last
# is the stream
_ARGTYPES = {
    "node_edge_reduce": [_P, _I, _I, _P, _I, _I, _I, _P, _P, _I, _I, _P],
    "elem_to_node_mean": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I,
                          _I, _P, _I, _P],
    "elem_to_node_mean_flat": [_P, _I, _I, _P, _I, _I, _P, _P, _I, _P],
    "tridiag_solve": [_P, _P, _P, _P, _I, _I, _I, _P, _I, _P],
    "fct_bounds": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                   _P, _P, _I, _P],
    "ring_spmv": [_P, _P, _P, _I, _I, _P, _I, _P],
    "block_schwarz": [_P, _I, _P, _P, _I, _I, _P, _P, _I, _P, _I, _P, _P,
                      _P, _P, _P, _P, _I, _P],
    "window_gather": [_P, _P, _I, _I, _I, _I, _P, _P],
    "onehot_gather": [_P, _P, _I, _I, _I, _I, _P, _P],
    "pressure_bv": [_P] * 7 + [_I, _I, _I, _D, _D] + [_P] * 5 + [_I, _P],
    "kpp_column": [_P] * 15 + [_I] * 3 + [_D] * 8 + [_P] * 4 + [_I, _P],
    "elem_contrib_to_nodes": [_P, _I, _I, _P, _I, _I, _I, _I, _P, _I, _P],
    "mevp_stress": [_P, _I, _P, _I, _P, _P, _P, _D, _D, _D, _I, _P],
    "mevp_node": [_P, _I, _P, _I, _P, _P, _I, _P, _D, _D, _D, _D, _I, _P],
}
_LIB = None
BLOCK_THREADS = 256     # threads per block of the one-thread-per-item kernels


# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
# rates): device memory, float32 and float64 arithmetic outside the tensor
# cores, and bf16 products with float32 sums on them (onehot_gather's
# method; no other kernel here uses them).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
PEAK_TENSOR_FLOPS = {torch.bfloat16: 989e12}


def bound_ms(work, dtype, peak_flops=None) -> tuple:
    """The least milliseconds the card could take for ``work`` = (bytes,
    flops) of a kernel's ``*_work`` counter (each input byte read once,
    each output byte written once), and which of the two binds.  The
    operations run at ``PEAK_FLOPS[dtype]`` unless ``peak_flops`` names
    another rate (the tensor cores')."""
    nbytes, flops = work
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_flops = flops / (peak_flops or PEAK_FLOPS[dtype]) * 1e3
    if by_bytes >= by_flops:
        return by_bytes, "bytes"
    return by_flops, "operations"


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


def launch(name: str, device: torch.device, *args, entry: str = "") -> None:
    """Call kernel ``name`` (its C entry ``fesom_<name><entry>``) on the
    current stream of ``device``: tensors are passed as pointers (None as
    a null pointer), ints and floats as the C signature's int and double.
    Raises on a refused launch."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                 for a in args]
        err = getattr(lib, "fesom_" + name + entry)(*cargs, stream)
    if err != 0:
        raise RuntimeError(f"kernel {name}: CUDA error {err} "
                           f"({lib.fesom_error_string(err).decode()})")
    LAUNCHES[name] += 1


def cuda_only(x: torch.Tensor, what: str) -> None:
    """Raise unless ``x`` lies on a CUDA device (the only non-CPU device
    the kernels serve)."""
    if x.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {x.device}")
