"""Each hand-written CUDA kernel against its plain torch version, on the
card, at a small size (the channel of 8 x 24 nodes, 10 layers).

These tests need an NVIDIA GPU and skip without one.  They import no JAX,
so they run on a machine that has only torch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerance: 1e-12 (float64) and 1e-5 (float32) of max|plain|; fct_bounds
bitwise.  ``chip_smoke.py`` makes the same comparison at full size.
"""
import dataclasses

import numpy as np
import pytest
import torch

from fesom2_tpu_torch.core import ops, tracers
from fesom2_tpu_torch.mesh import build_mesh_from_raw
from fesom2_tpu_torch.mesh.channel import channel_raw_mesh

NLAY = 10


@pytest.fixture(scope="module")
def mesh():
    return build_mesh_from_raw(channel_raw_mesh(8, 24, NLAY, dz=400.0),
                               cyclic_length_deg=4.5, device="cpu")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _cuda_mesh(tm, dtype):
    dev = torch.device("cuda")
    kw = {}
    for f in dataclasses.fields(tm):
        v = getattr(tm, f.name)
        if isinstance(v, torch.Tensor):
            v = v.to(dev)
            if v.is_floating_point():
                v = v.to(dtype)
        kw[f.name] = v
    return type(tm)(**kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_kernels_match_plain_on_card(mesh, rng, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    m = _cuda_mesh(mesh, dtype)
    dev = torch.device("cuda")

    def r(*shape, lo=-1.0, hi=1.0):
        return torch.as_tensor(rng.uniform(lo, hi, shape), device=dev).to(dtype)

    def check(got, want):
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert float((g - w).abs().max()) <= tol * float(w.abs().max())

    f = r(2, NLAY, m.n_edges)
    check(ops.edge_divergence(f, m), ops.edge_divergence_plain(f, m))
    check(ops.edge_signed_reduce2(f, m), ops.edge_signed_reduce2_plain(f, m))
    x = r(2, NLAY, m.n_elems)
    for respect in (True, False):
        check(ops.elem_to_node_mean(x, m, respect),
              ops.elem_to_node_mean_plain(x, m, respect))
    check(ops.elem_to_node_mean_flat(x[0], m),
          ops.elem_to_node_mean_flat_plain(x[0], m))
    a, c = r(NLAY, 50, lo=-0.4, hi=0.0), r(NLAY, 50, lo=-0.4, hi=0.0)
    b, d = r(NLAY, 50, lo=1.0, hi=2.0), r(2, NLAY, 50)
    check(ops.tridiag_solve(a, b, c, d), ops.tridiag_solve_plain(a, b, c, d))
    ttf, lo = r(2, NLAY, m.n_nodes), r(2, NLAY, m.n_nodes)
    got = tracers.fct_bounds(ttf, lo, m)
    want = tracers.fct_bounds_plain(ttf, lo, m)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    ttf[0, 3, 50] = float("nan")        # a NaN spreads as in torch.maximum
    got = tracers.fct_bounds(ttf, lo, m)
    want = tracers.fct_bounds_plain(ttf, lo, m)
    for g, w in zip(got, want):
        assert torch.equal(g.isnan(), w.isnan()) and bool(w.isnan().any())
        assert torch.equal(g[~g.isnan()], w[~w.isnan()])
