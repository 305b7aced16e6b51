"""The contiguous-block placement (``fesom2_tpu_torch/parallel/
sharding.py``) on the CPU, float64, against the port's one-device step and
against the JAX package's GSPMD-sharded step (``fesom2_tpu/parallel/
sharding.py``).

The case is the level-3 globe with 12 layers of ``tests/test_torch_dist.
py`` (the port's distributed step runs the coupled CI step, not the
channel's dense SSH), padded to a multiple of 8 (``setup_pi_model(pad_to=
8)``: 504 nodes), both models under ``prepare_dist_model`` (matrix-free
Jacobi CG, EVP on the whole mesh, 8 subcycles).  As in ``tests/
test_torch_padding.py``, the initial state, the atmosphere and the
relaxation fields are the unpadded model's padded with zeros.  Node ``i``
goes to rank ``i // 126``: 2 coupled steps over 4 gloo ranks (spawned
processes), gathered, hold against the port's one-device steps, and one
ocean step without forcing over the ranks against the port's one-device
step and against JAX's step with the state and forcing sharded over the
conftest's 8 virtual CPU devices (``jax.sharding``, GSPMD), within the
tolerances of ``tests/test_dist.py:152-186`` on the real entities (the
padding's dummies hold scratch).  Every halo slot equals its owner's and
every rank takes the same CG iterations.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fesom2_tpu.model as jmodel
from fesom2_tpu.core import eos as jeos, ssh as jssh
from fesom2_tpu.core.state import initial_z3d as jz3d
from fesom2_tpu.core.tracer_setup import build_tracer_statics as jtst
from fesom2_tpu.core.state import zero_forcing as jax_zero_forcing
from fesom2_tpu.mesh import build_mesh as jax_build_mesh
from fesom2_tpu.parallel import dist as jdist, sharding as jsharding
from fesom2_tpu.parallel.padding import pad_mesh as jax_pad_mesh

from fesom2_tpu_torch.convert import to_numpy
from fesom2_tpu_torch.core.state import zero_forcing
from fesom2_tpu_torch.mesh import globe
from fesom2_tpu_torch.model import (pi_coupled_step_fn, pi_initial_state,
                                    setup_pi_model)
from fesom2_tpu_torch.parallel import dist, sharding

from test_torch_coupled import short_config
from test_torch_padding import _pad_like, _sizes

S, PAD, N_STEPS = 4, 8, 2


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    torch.set_num_threads(1)
    path = globe.write_globe(str(tmp_path_factory.mktemp("globe")), level=3,
                             n_layers=12, dz_bottom=1000.0)
    c = dataclasses.make_dataclass("Case", [])()
    c.path, c.cfg = path, short_config()
    # the unpadded model's initial state, atmosphere and relaxation fields
    # padded with zeros (as tests/test_torch_padding.py pads them)
    m1, atm1 = setup_pi_model(path, device="cpu", cfg=c.cfg, atm_seed=4)
    s1, i1 = pi_initial_state(m1, seed=0)
    c.m, _ = setup_pi_model(path, device="cpu", cfg=c.cfg, atm_seed=4,
                            pad_to=PAD)
    pad = _pad_like(_sizes(m1, c.m))
    c.s0, c.i0, c.atm = pad(s1), pad(i1), pad(atm1)
    for k in ("Ssurf", "Tclim", "Sclim", "relax2clim"):
        setattr(c.m, k, pad(getattr(m1, k)))
    dist.prepare_dist_model(c.m)
    mesh = c.m.mesh
    c.real = {mesh.n_nodes: m1.mesh.n_nodes, mesh.n_elems: m1.mesh.n_elems}
    step = pi_coupled_step_fn(c.m, c.atm)
    s, i = c.s0, c.i0
    for k in range(N_STEPS):
        s, i, _ = step(s, i, k)
    c.ref = (s, i)
    c.ocean = c.m(c.s0, zero_forcing(mesh))
    c.layout = sharding.block_layout(c.m, S)
    # the inputs of dist._halo_checks, whose "ocean" is one ocean step
    # from the initial state without forcing over the ranks
    rng = np.random.default_rng(2)
    checks = sharding.shard_state(c.layout, dict(
        xn=torch.as_tensor(rng.normal(size=(3, mesh.n_nodes))),
        flux=torch.as_tensor(rng.normal(size=(mesh.nl - 1, mesh.n_edges))),
        contrib=torch.as_tensor(rng.normal(size=(3, mesh.n_elems)))))
    checks["x_loc"] = torch.zeros(S, c.layout.n_loc, dtype=torch.float64)
    c.res = dist.run_coupled_steps(
        [dict(model=c.m, atm=c.atm, state=c.s0, ice=c.i0, n_steps=N_STEPS,
              checks=checks)], c.layout, backend="gloo", device="cpu")[0]
    return c


def real_errors(c, ref_state, ref_ice, state, ice) -> dict:
    """max |a - b| / max |a| over the real entities, per field of the
    tolerance tables (the ocean's alone where ``ice`` is None)."""
    out = {}
    pairs = ((ref_state, state, dist.OCEAN_TOL),) + (
        () if ice is None else ((ref_ice, ice, dist.ICE_TOL),))
    for obj_r, obj, names in pairs:
        for name, _ in names:
            a = np.asarray(to_numpy(getattr(obj_r, name)), np.float64)
            b = np.asarray(to_numpy(getattr(obj, name)), np.float64)
            n = c.real[a.shape[-1]]
            a, b = a[..., :n], b[..., :n]
            out[name] = float(np.abs(a - b).max()
                              / max(np.abs(a).max(), 1e-12))
    return out


def assert_within(errs):
    for name, tol in dist.OCEAN_TOL + dist.ICE_TOL:
        if name in errs:
            assert errs[name] <= tol, (name, errs[name])


def test_block_partition_and_shards(case):
    c = case
    N = c.m.mesh.n_nodes
    part = sharding.block_partition(c.m.mesh, S)
    assert N % PAD == 0 and np.array_equal(
        part, np.repeat(np.arange(S), N // S))
    assert np.array_equal(c.layout.part, part)
    with pytest.raises(ValueError, match="multiple"):
        sharding.block_partition(c.m.mesh, 5)
    f = zero_forcing(c.m.mesh)
    for tree, fn in ((c.s0, sharding.shard_state),
                     (f, sharding.shard_forcing)):
        d = fn(c.layout, tree)
        assert d.eta.shape[0] == S if tree is c.s0 else True
        back = dist.gather_tree(d, c.layout)
        for fld in dataclasses.fields(tree):
            a, b = getattr(tree, fld.name), getattr(back, fld.name)
            assert torch.equal(a, b), fld.name


def test_block_placement_matches_one_device(case):
    c = case
    assert_within(real_errors(c, *c.ref, c.res["state"], c.res["ice"]))
    assert not dist.check_halo_consistency(
        dict(state=c.res["state_d"], ice=c.res["ice_d"]), c.layout)
    iters = [r["iters"] for r in c.res["ranks"]]
    assert all(it == iters[0] for it in iters)
    ocean = dist.gather_tree(c.res["checks"]["ocean"], c.layout)
    assert_within(real_errors(c, c.ocean, None, ocean, None))


def jax_padded_model(c):
    """The JAX model of ``_finish_pi_setup`` on the padded mesh under
    ``prepare_dist_model`` and the port's initial state."""
    cfg = c.cfg
    m = jax_pad_mesh(jax_build_mesh(
        c.path, force_rotation=True, cyclic_length_deg=360.0,
        use_partial_cell=cfg.ale.use_partial_cell,
        partial_cell_thresh=cfg.ale.partial_cell_thresh), PAD)
    diag = jssh.ssh_matrix_diagonal(m, cfg)
    _, Z3 = jz3d(m, jnp.float64)
    jm = jmodel.Model(
        mesh=m, cfg=cfg, tracer_statics=jtst(m, K_hor=cfg.tra.K_hor),
        ssh_diag_inv=jnp.where(diag > 0, 1.0 / jnp.where(diag > 0, diag, 1.0),
                               0.0),
        density_ref=jeos.reference_density(m, Z3, cfg.dyn.state_equation))
    jdist.prepare_dist_model(jm)
    js = jm.initial_state()
    js = dataclasses.replace(js, tr=jnp.asarray(to_numpy(c.s0.tr)),
                             tr_old=jnp.asarray(to_numpy(c.s0.tr_old)))
    return jm, js


def test_gathered_matches_jax_gspmd(case):
    """The ranks' ocean step (no forcing) gathered against JAX's step on
    the same padded inputs sharded over 8 devices (GSPMD).  JAX's padded
    coupled step is not held: its dummies' ice thermodynamics give NaN,
    which its global water-flux balance spreads to every node."""
    c = case
    assert jax.device_count() >= PAD
    jm, js = jax_padded_model(c)
    dmesh = jsharding.make_device_mesh(PAD)
    js = jsharding.shard_state(dmesh, js)
    jf = jsharding.shard_forcing(dmesh, jax_zero_forcing(jm.mesh))
    assert len(js.eta.sharding.device_set) == PAD
    jout = jm.step_fn()(js, jf)
    ocean = dist.gather_tree(c.res["checks"]["ocean"], c.layout)
    assert_within(real_errors(c, jout, None, ocean, None))
