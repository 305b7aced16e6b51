"""Three coupled ocean + ice steps of the CI configuration on the level-3
globe (12 layers) in the port against the JAX package's jitted
``pi_coupled_step_fn``, through ``test_torch_coupled.coupled_pair``, with
the column-physics menus of this slice (CPU, float64):

* ``cvmix_TKE+cvmix_IDEMIX`` with the salt plume (``SPP``) and six
  tracers (T, S, the rain tracer 101, the strait tracers 301-303), the
  Fram Strait tracer restored on a mask of 12 northern nodes handed to
  both packages (the strait boxes hold no node of this globe): dense SSH
  solve within 1e-9, CG forced (``DENSE_SSH_MAX_NODES = 0``, 8 mEVP
  subcycles) within 1e-8, of each field's largest JAX magnitude;
* ``cvmix_KPP`` with the dense solve, within 1e-9.

The ocean fields of ``test_torch_ci_ocean.FIELDS`` are compared with tke,
iwe and the tracers, the ice state and the fluxes handed to the ocean.
The region tracer stays in [0, 1] to 1e-9 without the Redi terms; with
them (as in the CI configuration) the explicit Redi fluxes, which the FCT
limiter does not see, take it below 0 in both packages.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fesom2_tpu_torch import kernels
from fesom2_tpu_torch.convert import to_numpy
from fesom2_tpu_torch.model import pi_config, pi_coupled_step_fn

from test_torch_coupled import (assert_coupled_close, assert_ice_alive,
                                coupled_pair, path, run_both)  # noqa: F401
from test_torch_kpp import assert_close

SIX = [0, 1, 101, 301, 302, 303]


def menu_config(mix_scheme, six=False, short=False):
    cfg = pi_config()
    cfg.dyn.mix_scheme = mix_scheme
    if six:
        cfg.dyn.SPP = True
        cfg.tra.num_tracers = 6
        cfg.tra.tracer_ID = list(SIX)
    if short:
        cfg.ice.evp_rheol_steps = 8
    return cfg


def with_region(p, n_nodes=12):
    """Both packages restore tracer 3 (id 301) on the same mask of
    ``n_nodes`` northern nodes, from a start at 1 there."""
    lat = p.tm.mesh.geo_coords[:, 1]
    mask = torch.zeros_like(lat, dtype=torch.bool)
    mask[torch.nonzero(lat > 1.0)[:n_nodes, 0]] = True
    assert int(mask.sum()) == n_nodes
    assert p.tm.ptr_idx == [3, 4, 5]
    p.tm.ptr_masks[0] = mask
    p.jm.ptracer_masks = [(i, jnp.asarray(to_numpy(m)))
                          for i, m in zip(p.tm.ptr_idx, p.tm.ptr_masks)]
    held = torch.where(mask[None, :] & p.tm.mesh.node_layer_mask, 1.0, 0.0)
    tr = p.ts0.tr.clone()
    tr[3] = held
    p.ts0 = dataclasses.replace(p.ts0, tr=tr, tr_old=tr)
    p.js0 = dataclasses.replace(p.js0, tr=jnp.asarray(to_numpy(tr)),
                                tr_old=jnp.asarray(to_numpy(tr)))
    return mask


def check_menu(jax_out, port_out, tol):
    assert_coupled_close(jax_out, port_out, tol)
    (js, _, _), (ts, _, _) = jax_out, port_out
    for name in ("tke", "iwe", "Kv_s", "kpp_nonloc"):
        assert_close(getattr(ts, name), getattr(js, name), name, tol=tol)


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "cg_forced"])
def test_tke_idemix_salt_plume_six_tracers(path, dense):  # noqa: F811
    p = coupled_pair(path, menu_config("cvmix_TKE+cvmix_IDEMIX", six=True,
                                       short=not dense),
                     dense_limit=None if dense else 0)
    mask = with_region(p)
    kernels.reset_launches()
    jax_out, port_out = run_both(p, 3)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    check_menu(jax_out, port_out, 1e-9 if dense else 1e-8)
    ts, tice, tof = port_out
    assert_ice_alive(tice, p.tice0)
    nmask = p.tm.mesh.node_layer_mask
    lev = torch.arange(p.tm.mesh.nl)[:, None]
    active = lev <= (p.tm.mesh.nlevels_node - 1)[None, :]
    assert float(ts.tke[active].min()) >= 0.0 and float(ts.tke.max()) > 0.0
    assert float(ts.iwe.min()) >= 0.0
    region = mask[None, :] & nmask
    assert bool((ts.tr[3][region] == 1.0).all())
    assert float(ts.tr[3][nmask & ~region].max()) > 0.0
    assert float(ts.tr[2].sum()) > 0.0 and float(ts.tr[2].min()) >= -1e-9
    assert float(tof.prec_rain.max()) > 0.0


@pytest.mark.parametrize("redi", [False, True], ids=["no_redi", "redi"])
def test_passive_tracer_bounds(path, redi):  # noqa: F811
    """The region tracer stays in [0, 1] to 1e-9 where advection (FCT)
    and the implicit vertical diffusion move it; the explicit Redi fluxes
    are not limited and take it below 0 (the JAX package's step does the
    same: the parity tests above hold it to the port's)."""
    cfg = menu_config("cvmix_TKE+cvmix_IDEMIX", six=True, short=True)
    cfg.dyn.Redi = redi
    p = coupled_pair(path, cfg)
    mask = with_region(p)
    step = pi_coupled_step_fn(p.tm, p.tatm)
    ts, tice = p.ts0, p.tice0
    for k in range(3):
        ts, tice, _ = step(ts, tice, k)
    t = ts.tr[3]
    assert bool((t[mask[None, :] & p.tm.mesh.node_layer_mask] == 1.0).all())
    assert float(t.max()) <= 1.0 + 1e-9
    if redi:
        assert float(t.min()) < -1e-6
    else:
        assert float(t.min()) >= -1e-9
    assert float(ts.tr[2].min()) >= -1e-9


def test_cvmix_kpp(path):  # noqa: F811
    p = coupled_pair(path, menu_config("cvmix_KPP"))
    jax_out, port_out = run_both(p, 3)
    check_menu(jax_out, port_out, 1e-9)
    ts = port_out[0]
    assert float(ts.kpp_nonloc.max()) > 0.0
    assert np.isfinite(to_numpy(ts.mld1)).all()
