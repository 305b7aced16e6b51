"""Three coupled CI steps with Icepack of the port against the JAX package
on the level-3 globe, as ``test_torch_icepack_steps.py`` holds the default
configuration, under the options that switch on other code: the
delta-Eddington shortwave (``shortwave='dEdd'``), the floe-size
distribution (``tr_fsd``) and the skeletal-layer biogeochemistry
(``tr_bgc``).  Every field of the ocean, the ice, the IcepackState and the
fluxes within 1e-9 of max|JAX|; no kernel launched on the CPU path."""
import pytest
import torch

from fesom2_tpu_torch.mesh import globe

from test_torch_icepack_steps import check_three_steps

CASES = {
    "dEdd": dict(shortwave="dEdd"),
    "fsd": dict(tr_fsd=True),
    "bgc": dict(tr_bgc=True),
}


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    torch.set_num_threads(1)
    return globe.write_globe(str(tmp_path_factory.mktemp("globe")), level=3,
                             n_layers=12, dz_bottom=1000.0)


@pytest.mark.parametrize("case", list(CASES))
def test_three_icepack_steps_match_jax(path, case):
    check_three_steps(path, CASES[case], {})
