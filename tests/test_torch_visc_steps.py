"""Three whole steps of the code-built channel (8 x 24 nodes, 10 layers,
zstar, dense SSH solve) for each ``visc_option`` 0-8, in the port against
the JAX package from the same initial state: every field within 1e-9 of
its largest JAX magnitude (CPU, float64), with the CI viscosity
coefficients of ``test_torch_dyn_menus.py``.  Option 8 fills the UKE
reservoir, which both packages carry on the state.
"""
import pytest

from test_torch_dyn_menus import path, three_steps_match_jax  # noqa: F401


@pytest.mark.parametrize("option", range(9))
def test_three_channel_steps_per_visc_option(path, option):  # noqa: F811
    ts = three_steps_match_jax(path, "zstar", dict(visc_option=option))
    if option == 8:
        assert float(ts.uke.abs().max()) > 0.0
