"""Gather cost model on the card: is a gather bound per index or per value?

The port of ``scripts/gather_cost_model.py``.  The model's gathers share
index tables (mesh incidence), so whether stacking operands that share an
index table along a leading F axis is free decides how to merge them:

- per-INDEX bound: an [F, N] operand with the same [K, N] indices costs
  the same for F=47 and F=94  ->  merge everything that shares indices;
- per-VALUE bound: cost ~ F  ->  only fewer gathered values help.

``main()`` scans operand width, dtype width, index count, 1-D gathers,
index locality and fused consumers with torch's own indexing (the JAX
probe timed XLA gathers there).  ``gather_probe()`` runs the two
hand-written kernels that replace the JAX probe's Pallas kernels: a row
gather from a per-tile window (``window_gather``) and the same gather as a
one-hot product (``onehot_gather``), each checked against the probe's
reference.

    python -m fesom2_tpu_torch.scripts.gather_cost_model [--probe-only]

It needs a CUDA card and raises without one.  Nothing is caught: a failed
build, launch or check exits non-zero.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .. import kernels


# --------------------------------------------------------------------------
# the probe's two kernels and their plain torch versions
# --------------------------------------------------------------------------
def _check_probe_args(vals: torch.Tensor, idx: torch.Tensor):
    if vals.dim() != 3 or idx.dim() != 2 or idx.shape[0] != vals.shape[0]:
        raise ValueError(f"vals [G, W, NL] and idx [G, T] expected, got "
                         f"{tuple(vals.shape)} and {tuple(idx.shape)}")
    G, W, NL = vals.shape
    return G, W, idx.shape[1], NL


def _fill_out_of_window(out, idx, W):
    """NaN rows where idx lies outside [0, W)."""
    valid = (idx >= 0) & (idx < W)
    return torch.where(valid[..., None], out, float("nan"))


def window_gather_plain(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    G, W, T, NL = _check_probe_args(vals, idx)
    safe = idx.long().clamp(0, max(W - 1, 0))
    out = torch.gather(vals, 1, safe[..., None].expand(G, T, NL))
    return _fill_out_of_window(out, idx, W)


def onehot_gather_plain(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """onehot(idx) @ vals as a batched matrix product (TF32 must be off
    on the card, as ``chip_smoke.py`` sets it, for an exact result)."""
    G, W, T, NL = _check_probe_args(vals, idx)
    cols = torch.arange(W, device=idx.device)
    onehot = (idx.long()[..., None] == cols).to(vals.dtype)   # [G, T, W]
    return _fill_out_of_window(torch.bmm(onehot, vals), idx, W)


def _probe_kernel(name: str, vals: torch.Tensor, idx: torch.Tensor):
    kernels.cuda_only(vals, name)
    G, W, T, NL = _check_probe_args(vals, idx)
    dev = vals.device
    kernels.require(vals, "vals", (G, W, NL), torch.float32, dev)
    kernels.require(idx, "idx", (G, T), torch.int32, dev)
    if name == "window_gather":
        if NL % 4 or vals.data_ptr() % 16:
            raise ValueError("window_gather: rows of 16-byte multiples, "
                             "16-byte aligned (NL % 4 == 0) expected")
        if T * 4 > 48 * 1024:
            raise ValueError(f"window_gather: T={T} indices exceed 48 KB "
                             "of shared memory")
    out = torch.empty((G, T, NL), dtype=torch.float32, device=dev)
    kernels.launch(name, dev, vals, idx, G, W, T, NL, out)
    return out


def window_gather_work(G: int, T: int, NL: int, rows_read: int) -> tuple:
    """(bytes, flops) of one gather: the [G, T] int32 indices, the
    ``rows_read`` distinct window rows of NL float32 that these indices
    name, the [G, T, NL] output; no arithmetic."""
    return 4 * (G * T + rows_read * NL + G * T * NL), 0


SPLIT_PIECES = 3    # bf16 pieces of a float32 value (8 + 8 + 8 bits)


def onehot_gather_work(G: int, W: int, T: int, NL: int) -> tuple:
    """(bytes, flops) of the one-hot product as a method, not of the
    function it computes (that is ``window_gather_work``'s gather, which
    needs no arithmetic): the indices, the whole [G, W, NL] window (a
    product reads all of it), the output; a product and an add per
    (g, t, w, nl) and bf16 piece, on the tensor cores
    (``kernels.PEAK_TENSOR_FLOPS``)."""
    return (4 * (G * T + G * W * NL + G * T * NL),
            SPLIT_PIECES * 2 * G * T * W * NL)


def split_bf16x3(vals: torch.Tensor) -> tuple:
    """(hi, mid, lo), float32 tensors that bf16 holds exactly and that add
    up to ``vals``: hi is vals with the low 16 bits of its word cut, mid
    the remainder cut the same way, lo what is left.  Each difference is
    exact in float32.  Cutting (not rounding) keeps hi finite up to the
    largest float32.  A value below 2^-109 in magnitude has bits under
    bf16's smallest subnormal and loses them in lo."""
    def cut(x):
        return (x.contiguous().view(torch.int32) & -65536).view(torch.float32)
    hi = cut(vals)
    rest = vals - hi
    mid = cut(rest)
    return hi, mid, cut(rest - mid)


def onehot_gather_emulation(vals: torch.Tensor,
                            idx: torch.Tensor) -> torch.Tensor:
    """``onehot_gather`` as its kernel computes it: one one-hot product per
    bf16 piece of vals, each into a float32 accumulator of its own, added
    as (hi + mid) + lo; NaN rows outside the window."""
    G, W, T, NL = _check_probe_args(vals, idx)
    cols = torch.arange(W, device=idx.device)
    onehot = (idx.long()[..., None] == cols).to(torch.bfloat16)
    hi, mid, lo = (torch.bmm(onehot.float(), p.to(torch.bfloat16).float())
                   for p in split_bf16x3(vals))
    return _fill_out_of_window((hi + mid) + lo, idx, W)


def window_gather(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[g, t, :] = vals[g, idx[g, t], :] for vals [G, W, NL] float32 and
    idx [G, T] int32.  An index outside [0, W) gives a NaN row (as
    jnp.take's fill mode does past the end; a negative index is not
    wrapped).  Kernel ``window_gather`` on a CUDA tensor."""
    if vals.device.type == "cpu":
        return window_gather_plain(vals, idx)
    return _probe_kernel("window_gather", vals, idx)


def onehot_gather(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The same gather as ``window_gather``, computed as the one-hot product
    onehot(idx[g], W) @ vals[g]; bit-equal to it.  Kernel
    ``onehot_gather`` on a CUDA tensor."""
    if vals.device.type == "cpu":
        return onehot_gather_plain(vals, idx)
    return _probe_kernel("onehot_gather", vals, idx)


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------
def bench(name: str, fn, *args, n: int = 5) -> float:
    """Seconds per call of fn(*args): 2 warm-up calls, then the mean of n
    calls between two CUDA events.  Prints one line."""
    fn(*args)
    fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn(*args)
    end.record()
    end.synchronize()
    dt = start.elapsed_time(end) / 1e3 / n
    print(f"  {name:44s}: {dt * 1e3:9.3f} ms", flush=True)
    return dt


def _require_card() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("the gather cost model needs a CUDA card: it "
                           "measures the card and has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def take_last(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """jnp.take(a, i, axis=-1): a[..., i]."""
    return a[..., i]


def three_reds(a, i):
    v = take_last(a, i)
    return v.amax(-2), v.amin(-2), v.sum(-2)


def three_gathers(a, i):
    return (take_last(a, i).amax(-2), take_last(a + 1.0, i).amin(-2),
            take_last(a + 2.0, i).sum(-2))


def windowed_indices(rng: np.random.RandomState, K: int, N: int, Ed: int):
    """[K, N] indices within 256 of each output's position scaled to Ed."""
    base = np.arange(N, dtype=np.int64) * Ed // N
    return (base[None, :] + rng.randint(0, 256, (K, N))) % Ed


def main():
    dev = _require_card()
    N = 188_661
    Ed = 566_000
    K = 8
    rng = np.random.RandomState(0)
    idxK = torch.as_tensor(rng.randint(0, Ed, (K, N)).astype(np.int64),
                           device=dev)
    idx1 = torch.as_tensor(rng.randint(0, Ed, (Ed,)).astype(np.int64),
                           device=dev)
    # operands are drawn on the card: their values do not matter here
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    print("== F scaling, operand [F, Ed] f32, idx [8, N] (1.51M indices) ==")
    for F in (2, 8, 16, 32, 47, 94, 141, 188):
        bench(f"F={F:<3d} [F,Ed] idx[8,N]", take_last, randn(F, Ed), idxK)

    print("== dtype width, operand [47, Ed], idx [8, N] ==")
    for dt_ in (torch.float32, torch.bfloat16, torch.float64, torch.int8):
        op = randn(47, Ed, dtype=torch.float64).to(dt_)
        bench(f"dtype={str(dt_).replace('torch.', ''):8s}", take_last, op,
              idxK)

    print("== index count scaling, operand [47, Ed] f32 ==")
    op47 = randn(47, Ed)
    for frac in (1, 2, 4, 8):
        bench(f"idx[8,N/{frac}]", take_last, op47,
              idxK[:, : N // frac].contiguous())

    print("== 1-D edge-index gathers (edge endpoint loads) ==")
    bench("[47,Ed] idx[Ed] 1-D", take_last, op47, idx1)
    bench("[47,Ed] idx[2,Ed/2]", take_last, op47, idx1.reshape(2, -1))

    print("== sorted vs random indices (locality sensitivity) ==")
    idx_sorted = torch.sort(idxK, dim=-1).values
    bench("idx[8,N] random", take_last, op47, idxK)
    bench("idx[8,N] sorted per row", take_last, op47, idx_sorted)
    idx_local = torch.as_tensor(windowed_indices(rng, K, N, Ed), device=dev)
    bench("idx[8,N] windowed-local", take_last, op47, idx_local)

    print("== fused consumers: 1 gather feeding 3 reductions ==")
    bench("gather + max/min/sum", three_reds, op47, idxK)
    bench("3 gathers (distinct ops)", three_gathers, op47, idxK)


PROBE_SHAPE = dict(G=512, W=1024, T=256, NL=48)


def probe_inputs(G: int, W: int, T: int, NL: int, seed: int = 1):
    """vals [G, W, NL] float32 and idx [G, T] int32, as numpy, from the
    probe's seed."""
    rng = np.random.RandomState(seed)
    vals = rng.randn(G, W, NL).astype(np.float32)
    idx = rng.randint(0, W, (G, T)).astype(np.int32)
    return vals, idx


def probe_reference(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The JAX probe's check: take_along_axis over the window axis."""
    G, W, T, NL = _check_probe_args(vals, idx)
    return torch.take_along_dim(vals, idx.long()[..., None].expand(G, T, NL),
                                dim=1)


def gather_probe():
    """Run both kernels at the probe's shapes (G=512, W=1024, T=256,
    NL=48, seed 1), time them, and check each against the reference.
    Returns {kernel: (seconds per call, max abs error)}; raises if either
    disagrees with the reference."""
    dev = _require_card()
    print("== hand-written local-gather probe ==")
    vals_np, idx_np = probe_inputs(**PROBE_SHAPE)
    vals = torch.as_tensor(vals_np, device=dev)
    idx = torch.as_tensor(idx_np, device=dev)
    ref = probe_reference(vals, idx)
    out = {}
    for name, fn in (("window_gather", window_gather),
                     ("onehot_gather", onehot_gather)):
        dt = bench(f"{name} [W,NL] idx[T]", fn, vals, idx)
        got = fn(vals, idx)
        err = float((got - ref).abs().max())
        print(f"  {name} correctness max err: {err:.2e}", flush=True)
        if not torch.equal(got, ref):
            raise RuntimeError(f"{name} differs from the reference gather "
                               f"(max err {err:.2e})")
        out[name] = (dt, err)
    return out


if __name__ == "__main__":
    _require_card()
    print("devices:", [torch.cuda.get_device_name(i)
                       for i in range(torch.cuda.device_count())], flush=True)
    if "--probe-only" not in sys.argv:
        main()
    gather_probe()
