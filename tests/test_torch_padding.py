"""Mesh padding (``fesom2_tpu_torch/parallel/padding.py``) against the JAX
package's ``parallel/padding.py``, and steps on a padded mesh against the
unpadded ones (CPU, float64).

``pad_mesh`` rounds the node, element and edge counts up to a multiple
with dummy entities (zero area, one level); its tables equal JAX's entry
for entry on the level-3 globe with partial cells.  Two coupled CI steps
on the globe padded to a multiple of 8 (``setup_pi_model(pad_to=8)``),
from the unpadded run's initial state, atmosphere and relaxation fields
padded with zeros, equal the unpadded run on the real entities within
1e-12 of each field's largest magnitude (the dense SSH inverses differ in
rounding), and the blowup scan and the step norms read no dummy; the
same for two soufflet channel steps (``setup_soufflet_model(pad_to=16)``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from fesom2_tpu.mesh import build_mesh as jax_build_mesh
from fesom2_tpu.parallel.padding import pad_mesh as jax_pad_mesh

from fesom2_tpu_torch.core.diag import blowup_scope, check_blowup, step_info
from fesom2_tpu_torch.core.state import zero_forcing
from fesom2_tpu_torch.mesh import build_mesh, globe
from fesom2_tpu_torch.model import (pi_initial_state, setup_pi_model,
                                    setup_soufflet_model)
from fesom2_tpu_torch.parallel.padding import pad_mesh
from fesom2_tpu_torch.run import run_pi

from test_torch_coupled import short_config


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    torch.set_num_threads(1)
    return globe.write_globe(str(tmp_path_factory.mktemp("globe")), level=3,
                             n_layers=12, dz_bottom=1000.0)


@pytest.mark.parametrize("multiple", [8, 64])
def test_pad_mesh_equals_jax(path, multiple):
    kw = dict(force_rotation=True, cyclic_length_deg=360.0,
              use_partial_cell=True, partial_cell_thresh=0.0)
    tm = pad_mesh(build_mesh(path, device="cpu", **kw), multiple)
    jm = jax_pad_mesh(jax_build_mesh(path, **kw), multiple)
    assert (tm.n_nodes, tm.n_elems, tm.n_edges) == (jm.n_nodes, jm.n_elems,
                                                    jm.n_edges)
    assert tm.n_nodes % multiple == tm.n_elems % multiple == 0
    for f in dataclasses.fields(jm):
        a, b = getattr(tm, f.name), getattr(jm, f.name)
        if f.name == "cluster":
            continue
        if isinstance(a, torch.Tensor):
            assert np.array_equal(a.numpy(), np.asarray(b)), f.name
        else:
            assert a == b, f.name
    # the kernels' tables are the padded mesh's own
    assert tm.cluster.elem_slot.shape[1] == tm.n_nodes


def _pad_like(sizes):
    """Pad every field whose last axis is a mesh size with zeros."""
    def pad(x):
        if isinstance(x, torch.Tensor) and x.ndim and x.shape[-1] in sizes:
            n = sizes[x.shape[-1]] - x.shape[-1]
            return torch.cat([x, torch.zeros(x.shape[:-1] + (n,),
                                             dtype=x.dtype)], -1)
        return x
    return lambda o: dataclasses.replace(o, **{
        f.name: pad(getattr(o, f.name)) for f in dataclasses.fields(o)}) \
        if dataclasses.is_dataclass(o) else pad(o)


def _sizes(m1, m2):
    a, b = m1.mesh, m2.mesh
    return {a.n_nodes: b.n_nodes, a.n_elems: b.n_elems, a.n_edges: b.n_edges}


def _assert_real_close(a, b, tol=1e-12):
    b = b[..., :a.shape[-1]]
    scale = max(float(a.abs().max()), 1e-30)
    assert float((a - b).abs().max()) / scale <= tol


def test_padded_coupled_steps_equal_unpadded(path):
    m1, atm1 = setup_pi_model(path, device="cpu", cfg=short_config(),
                              atm_seed=4)
    m8, _ = setup_pi_model(path, device="cpu", cfg=short_config(),
                           atm_seed=4, pad_to=8)
    assert m8.mesh.n_nodes % 8 == 0 and m8.mesh.n_nodes > m1.mesh.n_nodes
    s1, i1 = pi_initial_state(m1, seed=0)
    pad = _pad_like(_sizes(m1, m8))
    s8, i8, atm8 = pad(s1), pad(i1), pad(atm1)
    for k in ("Ssurf", "Tclim", "Sclim", "relax2clim"):
        setattr(m8, k, pad(getattr(m1, k)))
    # run_pi scans each step for a blowup: on the padded mesh it must not
    # read the dummies' scratch
    runs = {"1": run_pi(m1, atm1, s1, i1, 2), "8": run_pi(m8, atm8, s8, i8, 2)}
    (sa, ia), (sb, ib) = runs["1"], runs["8"]
    for name in ("eta", "tr", "u", "v", "w", "hnode", "hbar", "Kv"):
        _assert_real_close(getattr(sa, name), getattr(sb, name))
    for name in ("a_ice", "m_ice", "u_ice", "v_ice", "sigma11"):
        _assert_real_close(getattr(ia, name), getattr(ib, name))
    # the dummies hold scratch (hnode is not finite there); the scan and
    # the norms do not read them
    assert not bool(torch.isfinite(sb.hnode[:, m1.mesh.n_nodes:]).all())
    assert blowup_scope(m1.mesh) is None
    assert int(check_blowup(sb, m8.mesh, ib, m8.ice_sub,
                            blowup_scope(m8.mesh))) == 0
    info = step_info(sb, m8.mesh, ib)
    assert all(np.isfinite(v) for v in info.values())
    assert info == pytest.approx(step_info(sa, m1.mesh, ia), rel=1e-10,
                                 abs=1e-20)


def test_padded_soufflet_steps_equal_unpadded():
    m1 = setup_soufflet_model(device="cpu")
    m16 = setup_soufflet_model(device="cpu", pad_to=16)
    assert m16.mesh.n_nodes % 16 == 0 and m16.mesh.n_nodes > m1.mesh.n_nodes
    pad = _pad_like(_sizes(m1, m16))
    s1 = m1.initial_state()
    s16 = pad(s1)
    outs = []
    for m, s in ((m1, s1), (m16, s16)):
        f = zero_forcing(m.mesh, m.dtype)
        with torch.no_grad():
            for _ in range(2):
                s = m(s, f)
        outs.append(s)
    for name in ("eta", "tr", "u", "v", "w"):
        _assert_real_close(getattr(outs[0], name), getattr(outs[1], name))
