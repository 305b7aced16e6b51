"""The port's smoothing and integrals (``fesom2_tpu_torch/utils/
support.py``) against ``fesom2_tpu/utils/support.py`` on the level-3 globe
with 12 layers, float64 on the CPU, where ``smooth_nod`` and
``smooth_elem`` run the plain version of ``elem_to_node_mean``'s
one-thread-per-output form: node and element fields, 2D and layered,
1 and 3 passes, within 1e-12 of max|JAX|; the integrals within 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fesom2_tpu.mesh import build_mesh as jax_build_mesh
from fesom2_tpu.utils import support as jsupport

from fesom2_tpu_torch.mesh import build_mesh, globe
from fesom2_tpu_torch.utils import support

TOL = 1e-12


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    torch.set_num_threads(1)
    path = globe.write_globe(str(tmp_path_factory.mktemp("globe")), level=3,
                             n_layers=12, dz_bottom=1000.0)
    kw = dict(force_rotation=True, cyclic_length_deg=360.0,
              use_partial_cell=True)
    return jax_build_mesh(path, **kw), build_mesh(path, **kw, device="cpu")


def _close(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err <= TOL, err


@pytest.mark.parametrize("layered", [False, True])
@pytest.mark.parametrize("n_smooth", [1, 3])
def test_smooth_nod_equals_jax(meshes, layered, n_smooth):
    jm, tm = meshes
    rng = np.random.default_rng(n_smooth)
    shape = ((tm.nl - 1,) if layered else ()) + (tm.n_nodes,)
    x = rng.normal(size=shape)
    _close(support.smooth_nod(torch.as_tensor(x), n_smooth, tm),
           jsupport.smooth_nod(jnp.asarray(x), n_smooth, jm))


@pytest.mark.parametrize("layered", [False, True])
@pytest.mark.parametrize("n_smooth", [1, 3])
def test_smooth_elem_equals_jax(meshes, layered, n_smooth):
    jm, tm = meshes
    rng = np.random.default_rng(10 + n_smooth)
    shape = ((tm.nl - 1,) if layered else ()) + (tm.n_elems,)
    x = rng.normal(size=shape)
    _close(support.smooth_elem(torch.as_tensor(x), n_smooth, tm),
           jsupport.smooth_elem(jnp.asarray(x), n_smooth, jm))


def test_smoothing_keeps_constants_and_damps_noise(meshes):
    _, tm = meshes
    c = torch.full((tm.n_nodes,), 3.5, dtype=torch.float64)
    assert torch.allclose(support.smooth_nod(c, 3, tm), c, rtol=1e-14)
    ce = torch.full((tm.n_elems,), -1.25, dtype=torch.float64)
    assert torch.allclose(support.smooth_elem(ce, 2, tm), ce, rtol=1e-14)
    noise = torch.as_tensor(np.random.default_rng(0).normal(
        size=tm.n_nodes))
    assert float(support.smooth_nod(noise, 2, tm).std()) \
        < 0.6 * float(noise.std())


def test_integrals_equal_jax(meshes):
    jm, tm = meshes
    rng = np.random.default_rng(5)
    d2 = rng.normal(size=tm.n_nodes)
    got = support.integrate_nod_2d(torch.as_tensor(d2), tm)
    want = jsupport.integrate_nod_2d(jnp.asarray(d2), jm)
    assert abs(float(got) - float(want)) <= TOL * abs(float(want))
    d3 = rng.uniform(0.5, 1.5, size=(tm.nl - 1, tm.n_nodes))
    h = rng.uniform(10.0, 200.0, size=(tm.nl - 1, tm.n_nodes))
    got = support.integrate_nod_3d(torch.as_tensor(d3), torch.as_tensor(h),
                                   tm)
    want = jsupport.integrate_nod_3d(jnp.asarray(d3), jnp.asarray(h), jm)
    assert abs(float(got) - float(want)) <= TOL * abs(float(want))
    # a field of ones integrates to the surface area and the wet volume
    one = torch.ones(tm.n_nodes, dtype=torch.float64)
    assert float(support.integrate_nod_2d(one, tm)) == float(tm.area[0].sum())
