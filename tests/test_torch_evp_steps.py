"""Three coupled CI steps of the port against the JAX package under
standard EVP (``whichEVP = 0``) and adaptive EVP (2), on the level-3 globe
with 12 layers (CPU, float64, dense SSH, 120 subcycles on the polar-cap
subdomain): every ocean and ice field and the fluxes handed to the ocean
within 1e-9 of max|JAX|, as ``test_torch_coupled.py`` holds mEVP.  No
kernel is launched on the CPU path."""
import pytest
import torch

from fesom2_tpu_torch import kernels
from fesom2_tpu_torch.mesh import globe
from fesom2_tpu_torch.model import pi_config

from test_torch_coupled import (assert_coupled_close, assert_ice_alive,
                                coupled_pair, run_both)


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    torch.set_num_threads(1)
    return globe.write_globe(str(tmp_path_factory.mktemp("globe")), level=3,
                             n_layers=12, dz_bottom=1000.0)


@pytest.mark.parametrize("which", [0, 2])
def test_three_coupled_steps_match_jax(path, which):
    cfg = pi_config()
    cfg.ice.whichEVP = which
    p = coupled_pair(path, cfg)
    assert p.tm.ssh_dense_inv is not None and p.tm.ice_sub is not None
    kernels.reset_launches()
    jax_out, port_out = run_both(p, 3)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    assert_coupled_close(jax_out, port_out, tol=1e-9)
    assert_ice_alive(port_out[1], p.tice0)
    tice = port_out[1]
    if which == 2:
        # the refreshed stability fields: finite, at least 50 where the
        # ice moved them (tests/test_ice.py::test_evp_variants' bound)
        for f in (tice.alpha_aevp, tice.beta_aevp):
            assert bool(torch.isfinite(f).all()) and float(f.min()) >= 50.0
        assert bool((tice.alpha_aevp != p.tice0.alpha_aevp).any())
