"""The port's mesh operators against the JAX package's, on the same inputs.

On the CPU each kernel-backed operator runs its plain torch version; the
inputs are drawn from a seeded numpy generator and handed to both
packages.  Tolerance: 1e-12 of the largest JAX magnitude (both sum the
same terms in float64, in possibly different orders); ``fct_bounds``
(max/min and one subtraction) must match exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fesom2_tpu.mesh import build_mesh as jax_build_mesh
from fesom2_tpu.core import ops as jax_ops
from fesom2_tpu.core import tracers as jax_tracers

from fesom2_tpu_torch import kernels
from fesom2_tpu_torch.core import ops, tracers
from fesom2_tpu_torch.mesh import build_mesh
from fesom2_tpu_torch.mesh.channel import channel_raw_mesh, write_mesh

NX, NY, NLAY = 8, 24, 10


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    torch.set_num_threads(1)
    raw = channel_raw_mesh(NX, NY, NLAY, dz=4000.0 / NLAY)
    path = write_mesh(raw, str(tmp_path_factory.mktemp("channel")))
    return (jax_build_mesh(path, cyclic_length_deg=4.5),
            build_mesh(path, cyclic_length_deg=4.5, device="cpu"))


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def assert_close(port, ref, tol=1e-12):
    ref = np.asarray(ref)
    got = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"max abs err {err:.3e} vs scale {scale:.3e}"


@pytest.mark.parametrize("lead", [(), (NLAY,), (2, NLAY)])
def test_edge_divergence(meshes, rng, lead):
    jm, tm = meshes
    f = rng.standard_normal(lead + (tm.n_edges,))
    assert_close(ops.edge_divergence(_t(f), tm),
                 jax_ops.edge_divergence(jnp.asarray(f), jm))


def test_edge_signed_reduce2(meshes, rng):
    jm, tm = meshes
    f = rng.standard_normal((2, NLAY, tm.n_edges))
    plus, minus = ops.edge_signed_reduce2(_t(f), tm)
    jplus, jminus = jax_ops.edge_signed_reduce2(jnp.asarray(f), jm)
    assert_close(plus, jplus)
    assert_close(minus, jminus)


@pytest.mark.parametrize("lead,respect", [((2,), True), ((2,), False),
                                          ((2, 2), True)])
def test_elem_to_node_mean(meshes, rng, lead, respect):
    jm, tm = meshes
    x = rng.standard_normal(lead + (NLAY, tm.n_elems))
    assert_close(ops.elem_to_node_mean(_t(x), tm, respect_levels=respect),
                 jax_ops.elem_to_node_mean(jnp.asarray(x), jm,
                                           respect_levels=respect))


def test_elem_to_node_mean_flat(meshes, rng):
    jm, tm = meshes
    x = rng.standard_normal((3, tm.n_elems))
    assert_close(ops.elem_to_node_mean_flat(_t(x), tm),
                 jax_ops.elem_to_node_mean_flat(jnp.asarray(x), jm))


@pytest.mark.parametrize("batched_abc", [False, True])
def test_tridiag_solve(rng, batched_abc):
    L, X = NLAY, 37
    lead = (2,) if batched_abc else ()
    a = rng.uniform(-0.4, 0.0, lead + (L, X))
    c = rng.uniform(-0.4, 0.0, lead + (L, X))
    b = rng.uniform(1.0, 2.0, lead + (L, X))
    d = rng.standard_normal((2, L, X))
    got = ops.tridiag_solve(_t(a), _t(b), _t(c), _t(d))
    for i in range(2):
        ai, bi, ci = (z[i] if batched_abc else z for z in (a, b, c))
        assert_close(got[i], jax_ops.tridiag_solve(
            jnp.asarray(ai), jnp.asarray(bi), jnp.asarray(ci),
            jnp.asarray(d[i])))


def test_cumsum_bottom_up(rng):
    x = rng.standard_normal((NLAY + 1, 7))
    assert_close(ops.cumsum_bottom_up(_t(x)),
                 jax_ops.cumsum_bottom_up(jnp.asarray(x)))


def test_edge_transport(meshes, rng):
    jm, tm = meshes
    uh = rng.standard_normal((NLAY, tm.n_elems))
    vh = rng.standard_normal((NLAY, tm.n_elems))
    assert_close(ops.edge_transport(_t(uh), _t(vh), tm),
                 jax_ops.edge_transport(jnp.asarray(uh), jnp.asarray(vh), jm))


@pytest.mark.parametrize("lead", [(), (2, NLAY)])
def test_scalar_gradient_and_elem_mean(meshes, rng, lead):
    jm, tm = meshes
    f = rng.standard_normal(lead + (tm.n_nodes,))
    gx, gy = ops.scalar_gradient(_t(f), tm)
    jgx, jgy = jax_ops.scalar_gradient(jnp.asarray(f), jm)
    assert_close(gx, jgx)
    assert_close(gy, jgy)
    assert_close(ops.elem_mean_node(_t(f), tm),
                 jax_ops.elem_mean_node(jnp.asarray(f), jm))


def _jax_fct_bounds(ttf, lo, jm, areasvol):
    """(inc_max, inc_min) of the JAX fct_limiter, read exactly.

    With dt = 1, no horizontal flux and a vertical flux equal to the
    layer volume on every interface, the limiter's denominators are
    exactly +1 and -1, so its ratios min(1, inc_max / 1) and
    min(1, inc_min / -1) are the increments themselves (|inc| < 1 here).
    The ratios are read off the JAX function's own jnp.minimum calls."""
    seen = []

    class Spy:
        def __getattr__(self, name):
            return getattr(jnp, name)

        def minimum(self, a, b):
            if isinstance(a, float) and a == 1.0:
                seen.append(np.asarray(b))
            return jnp.minimum(a, b)

    nl = areasvol.shape[0]
    av = np.where(areasvol[:-1] > 0, areasvol[:-1], 1.0)
    adf_v = np.concatenate([av, av[-1:]], 0)[None].repeat(ttf.shape[0], 0)
    adf_h = np.zeros((ttf.shape[0], nl - 1, jm.n_edges))
    real = jax_tracers.jnp
    jax_tracers.jnp = Spy()
    try:
        jax_tracers.fct_limiter(jnp.asarray(ttf), jnp.asarray(lo),
                                jnp.asarray(adf_h), jnp.asarray(adf_v), jm,
                                1.0)
    finally:
        jax_tracers.jnp = real
    inc_max, neg_inc_min = seen[:2]
    return inc_max, -neg_inc_min


def test_fct_bounds_exact(meshes, rng):
    jm, tm = meshes
    shape = (2, NLAY, tm.n_nodes)
    ttf = rng.uniform(0.0, 0.45, shape)
    lo = rng.uniform(0.0, 0.45, shape)
    inc_max, inc_min = tracers.fct_bounds(_t(ttf), _t(lo), tm)
    j_max, j_min = _jax_fct_bounds(ttf, lo, jm, np.asarray(jm.areasvol))
    assert np.array_equal(inc_max.numpy(), j_max)
    assert np.array_equal(inc_min.numpy(), j_min)
    assert (inc_max.numpy() > 0).any() and (inc_min.numpy() < 0).any()


def test_fct_bounds_nan_propagates(meshes, rng):
    """A NaN in ttf spreads through the bounds exactly as in JAX (the
    card's kernel is held to the same pattern in test_torch_kernels)."""
    jm, tm = meshes
    shape = (2, NLAY, tm.n_nodes)
    ttf = rng.uniform(0.0, 0.45, shape)
    lo = rng.uniform(0.0, 0.45, shape)
    ttf[0, 3, 50] = np.nan
    inc_max, inc_min = tracers.fct_bounds(_t(ttf), _t(lo), tm)
    j_max, j_min = _jax_fct_bounds(ttf, lo, jm, np.asarray(jm.areasvol))
    assert np.isnan(inc_max.numpy()).any() and np.isnan(inc_min.numpy()).any()
    assert np.array_equal(inc_max.numpy(), j_max, equal_nan=True)
    assert np.array_equal(inc_min.numpy(), j_min, equal_nan=True)


def test_fct_limiter(meshes, rng):
    jm, tm = meshes
    shape = (2, NLAY, tm.n_nodes)
    ttf = rng.uniform(5.0, 20.0, shape)
    lo = ttf + rng.normal(0.0, 0.1, shape)
    adf_h = rng.standard_normal((2, NLAY, tm.n_edges)) * 1e3
    adf_v = rng.standard_normal((2, NLAY + 1, tm.n_nodes)) * 1e3
    got = tracers.fct_limiter(_t(ttf), _t(lo), _t(adf_h), _t(adf_v), tm,
                              1200.0)
    ref = jax_tracers.fct_limiter(*(jnp.asarray(z) for z in
                                    (ttf, lo, adf_h, adf_v)), jm, 1200.0)
    for g, r in zip(got, ref):
        assert_close(g, r)


def test_cpu_path_launches_no_kernel(meshes, rng):
    _, tm = meshes
    kernels.reset_launches()
    ops.edge_divergence(_t(rng.standard_normal(tm.n_edges)), tm)
    ops.elem_to_node_mean(_t(rng.standard_normal((NLAY, tm.n_elems))), tm)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


@pytest.mark.parametrize("wrapper", ["edge_divergence", "edge_signed_reduce2",
                                     "elem_to_node_mean",
                                     "elem_to_node_mean_flat",
                                     "tridiag_solve", "fct_bounds"])
def test_wrappers_refuse_other_devices(meshes, wrapper):
    """A tensor on neither the CPU nor a CUDA card has no kernel: the
    wrapper raises rather than falling back to the plain version."""
    _, tm = meshes

    def meta(*shape):
        return torch.empty(shape, dtype=torch.float64, device="meta")

    calls = {
        "edge_divergence": lambda: ops.edge_divergence(meta(tm.n_edges), tm),
        "edge_signed_reduce2": lambda: ops.edge_signed_reduce2(
            meta(NLAY, tm.n_edges), tm),
        "elem_to_node_mean": lambda: ops.elem_to_node_mean(
            meta(NLAY, tm.n_elems), tm),
        "elem_to_node_mean_flat": lambda: ops.elem_to_node_mean_flat(
            meta(2, tm.n_elems), tm),
        "tridiag_solve": lambda: ops.tridiag_solve(
            *(meta(NLAY, 5) for _ in range(4))),
        "fct_bounds": lambda: tracers.fct_bounds(
            meta(1, NLAY, tm.n_nodes), meta(1, NLAY, tm.n_nodes), tm),
    }
    with pytest.raises(RuntimeError, match="no kernel"):
        calls[wrapper]()
    assert all(v == 0 for v in kernels.LAUNCHES.values())
