"""The ported gather cost probe against the JAX probe's expressions.

The JAX probe runs only on a TPU, so its Pallas kernels cannot run here.
Their plain versions in the port (``window_gather_plain`` and
``onehot_gather_plain``, what the wrappers run for a CPU tensor) are held
against the probe's own reference, ``jnp.take_along_axis`` over the window
axis, at G=16, W=64, T=32, NL=8: bitwise, an index outside [0, W) giving a
NaN row in both (jnp's fill mode).  The gathers ``main()`` times are held
against ``jnp.take(a, i, axis=-1)`` at small shapes; ``main()`` itself runs
only on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fesom2_tpu_torch.scripts import gather_cost_model as probe

SHAPE = dict(G=16, W=64, T=32, NL=8)


@pytest.fixture(scope="module")
def inputs():
    vals, idx = probe.probe_inputs(**SHAPE)
    # out of the window: past the end, and below -W (jnp wraps [-W, 0))
    idx[0, 0], idx[3, 7], idx[5, 31] = 64, 1000, -70
    return vals, idx


def _jax_reference(vals, idx):
    return np.asarray(jnp.take_along_axis(
        jnp.asarray(vals), jnp.asarray(idx)[:, :, None].repeat(
            vals.shape[-1], -1), axis=1))


def _assert_same(got, ref):
    got = got.numpy()
    assert got.shape == ref.shape
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.array_equal(np.nan_to_num(got), np.nan_to_num(ref))


@pytest.mark.parametrize("fn", [probe.window_gather_plain,
                                probe.onehot_gather_plain,
                                probe.window_gather, probe.onehot_gather],
                         ids=["window_plain", "onehot_plain",
                              "window_wrapper_cpu", "onehot_wrapper_cpu"])
def test_probe_gathers_match_take_along_axis(inputs, fn):
    vals, idx = inputs
    ref = _jax_reference(vals, idx)
    assert int(np.isnan(ref).any(-1).sum()) == 3
    _assert_same(fn(torch.as_tensor(vals), torch.as_tensor(idx)), ref)


def test_probe_reference_matches_jax():
    vals, idx = probe.probe_inputs(**SHAPE)
    got = probe.probe_reference(torch.as_tensor(vals), torch.as_tensor(idx))
    assert np.array_equal(got.numpy(), _jax_reference(vals, idx))


def test_probe_inputs_are_the_jax_probes():
    """The same numpy draws as scripts/gather_cost_model.py:111-113."""
    rng = np.random.RandomState(1)
    vals = rng.randn(4, 16, 8).astype(np.float32)
    idx = rng.randint(0, 16, (4, 8)).astype(np.int32)
    v, i = probe.probe_inputs(G=4, W=16, T=8, NL=8)
    assert np.array_equal(v, vals) and np.array_equal(i, idx)
    assert v.dtype == np.float32 and i.dtype == np.int32


def _operands():
    rng = np.random.RandomState(0)
    Ed, N, K = 300, 100, 8
    a = rng.randn(5, Ed).astype(np.float32)
    idxK = rng.randint(0, Ed, (K, N))
    idx1 = rng.randint(0, Ed, (Ed,))
    return a, idxK, idx1, probe.windowed_indices(rng, K, N, Ed)


CASES = {
    "take_KN": lambda a, iK, i1, iw: (probe.take_last, a, iK),
    "take_1d": lambda a, iK, i1, iw: (probe.take_last, a, i1),
    "take_2xhalf": lambda a, iK, i1, iw: (probe.take_last, a,
                                          i1.reshape(2, -1)),
    "take_sorted": lambda a, iK, i1, iw: (probe.take_last, a,
                                          np.sort(iK, axis=-1)),
    "take_windowed": lambda a, iK, i1, iw: (probe.take_last, a, iw),
    "three_reds": lambda a, iK, i1, iw: (probe.three_reds, a, iK),
    "three_gathers": lambda a, iK, i1, iw: (probe.three_gathers, a, iK),
}


def _jax_case(name, a, i):
    take = lambda x: jnp.take(jnp.asarray(x), jnp.asarray(i), axis=-1)
    if name == "three_reds":
        v = take(a)
        return v.max(-2), v.min(-2), v.sum(-2)
    if name == "three_gathers":
        return take(a).max(-2), take(a + 1.0).min(-2), take(a + 2.0).sum(-2)
    return take(a)


@pytest.mark.parametrize("name", list(CASES))
def test_main_gathers_match_jnp_take(name):
    a, iK, i1, iw = _operands()
    fn, x, i = CASES[name](a, iK, i1, iw)
    got = fn(torch.as_tensor(x), torch.as_tensor(i))
    ref = _jax_case(name, x, i)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape
        assert np.allclose(g.numpy(), r, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("dtype,jdtype", [
    (torch.bfloat16, jnp.bfloat16), (torch.float64, jnp.float64),
    (torch.int8, jnp.int8)], ids=["bf16", "f64", "int8"])
def test_main_gather_dtypes(dtype, jdtype):
    """The dtype scan: operands cast as the JAX probe casts them, gathered
    exactly in every width."""
    a, iK, _, _ = _operands()
    a = a * 3.0
    got = probe.take_last(torch.as_tensor(a).to(dtype), torch.as_tensor(iK))
    ref = jnp.take(jnp.asarray(a).astype(jdtype), jnp.asarray(iK), axis=-1)
    assert got.dtype == dtype
    assert np.array_equal(got.to(torch.float64).numpy(),
                          np.asarray(ref.astype(jnp.float64)))


@pytest.mark.parametrize("entry", ["main", "gather_probe"])
def test_probe_needs_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA card"):
        getattr(probe, entry)()
