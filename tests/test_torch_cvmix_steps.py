"""Three whole steps of the code-built zstar channel in the port against
the JAX package's jitted step for every ``mix_scheme`` of the CVMix menu
(CPU, float64, dense SSH solve, within 1e-9 of each field's largest JAX
magnitude, tke, iwe and the KPP nonlocal flux included): cvmix_PP,
cvmix_TKE, cvmix_TKE+cvmix_IDEMIX, cvmix_IDEMIX alone, cvmix_KPP,
KPP+cvmix_TIDAL and PP+cvmix_DDIFF+cvmix_CONV, under the wind, heat and
water forcing of ``test_torch_menu_steps.forcing_arrays``.
"""
import pytest

from test_torch_menu_steps import menu_cfg, path, steps_match_jax  # noqa

SCHEMES = ["cvmix_PP", "cvmix_TKE", "cvmix_TKE+cvmix_IDEMIX", "cvmix_IDEMIX",
           "cvmix_KPP", "KPP+cvmix_TIDAL", "PP+cvmix_DDIFF+cvmix_CONV"]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_three_channel_steps_match_jax(path, scheme):  # noqa: F811
    p, ts = steps_match_jax(path, menu_cfg(mix_scheme=scheme))
    if scheme.startswith("cvmix_TKE"):
        assert float(ts.tke.max()) > 0.0
