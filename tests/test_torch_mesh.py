"""The port's mesh layer against the JAX package, on a code-built channel.

The channel (8 x 24 nodes, 10 layers of 400 m) is written to disk in the
FESOM ASCII format; the JAX package reads it through its own unmodified
``build_mesh``, the port through its copy.  Float tables must agree to
1e-13 of their largest magnitude, integer and boolean tables exactly.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fesom2_tpu.mesh import build_mesh as jax_build_mesh
from fesom2_tpu.core import ssh as jax_ssh
from fesom2_tpu.constants import rad

from fesom2_tpu_torch.convert import to_numpy
from fesom2_tpu_torch.core import ssh
from fesom2_tpu_torch.mesh import build_mesh, read_raw_mesh
from fesom2_tpu_torch.mesh.channel import channel_raw_mesh, write_mesh
from fesom2_tpu_torch.mesh.tables import build_edges
from fesom2_tpu_torch.model import soufflet_config

NX, NY, NLAY = 8, 24, 10
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def mesh_dir(tmp_path_factory):
    torch.set_num_threads(1)
    raw = channel_raw_mesh(NX, NY, NLAY, dz=4000.0 / NLAY)
    return write_mesh(raw, str(tmp_path_factory.mktemp("channel")))


@pytest.fixture(scope="module")
def meshes(mesh_dir):
    jm = jax_build_mesh(mesh_dir, cyclic_length_deg=4.5)
    tm = build_mesh(mesh_dir, cyclic_length_deg=4.5, device="cpu")
    return jm, tm


def test_channel_sizes():
    raw = channel_raw_mesh()          # the default soufflet-size channel
    edges, edge_tri, n_in = build_edges(raw.elem_nodes, raw.coords,
                                        4.5 * rad)
    assert (raw.n_nodes, raw.n_elems, edges.shape[0], raw.nl) == \
        (2875, 5700, 8575, 41)
    assert n_in == 8575 - 2 * 25        # two boundary rows of 25 edges


def test_channel_triangles_clockwise():
    """Clockwise triangles in (lon, lat), the FESOM file order: with
    counter-clockwise ones the SSH operator is indefinite."""
    for nx, ny in ((NX, NY), (25, 115)):
        raw = channel_raw_mesh(nx, ny)
        p = raw.coords_deg[raw.elem_nodes]
        dx = p[:, 1:, 0] - p[:, :1, 0]
        dx = np.where(dx > 2.25, dx - 4.5, np.where(dx < -2.25, dx + 4.5, dx))
        dy = p[:, 1:, 1] - p[:, :1, 1]
        cross = dx[:, 0] * dy[:, 1] - dx[:, 1] * dy[:, 0]
        assert (cross < 0).all()


def test_channel_files_roundtrip(mesh_dir):
    raw = channel_raw_mesh(NX, NY, NLAY, dz=4000.0 / NLAY)
    back = read_raw_mesh(mesh_dir)
    assert np.array_equal(back.coords, raw.coords)
    assert np.array_equal(back.elem_nodes, raw.elem_nodes)
    assert np.array_equal(back.zbar, raw.zbar)
    assert back.depth is None


def test_mesh_tables_match_jax(meshes):
    jm, tm = meshes
    names = [f.name for f in dataclasses.fields(jm)]
    # the port's mesh also carries its cluster kernels' tables
    assert names + ["cluster"] == [f.name for f in dataclasses.fields(tm)]
    for name in names:
        a = np.asarray(getattr(jm, name))
        b = to_numpy(getattr(tm, name))
        if a.ndim == 0 and not isinstance(b, np.ndarray):
            assert a == b, name
            continue
        assert a.shape == b.shape, name
        if a.dtype.kind in "biu":
            assert np.array_equal(a, b), name
        else:
            scale = max(float(np.abs(a).max()), 1e-300)
            assert float(np.abs(a - b).max()) <= 1e-13 * scale, name


def test_ssh_operator_spd(meshes):
    """The assembled SSH operator is symmetric positive definite (it is
    indefinite on a counter-clockwise mesh) and equals the JAX one."""
    jm, tm = meshes
    cfg = soufflet_config()
    A = ssh.ssh_dense_matrix(tm, cfg)
    assert np.abs(A - A.T).max() <= 1e-12 * np.abs(A).max()
    assert np.linalg.eigvalsh(0.5 * (A + A.T)).min() > 0.0
    A_jax = jax_ssh.ssh_dense_matrix(jm, cfg)
    assert np.abs(A - A_jax).max() <= 1e-13 * np.abs(A_jax).max()


def test_ssh_matrix_diagonal(meshes):
    """The exact diagonal equals the dense operator's and the JAX one."""
    jm, tm = meshes
    cfg = soufflet_config()
    diag = to_numpy(ssh.ssh_matrix_diagonal(tm, cfg))
    A = ssh.ssh_dense_matrix(tm, cfg)
    assert np.abs(diag - np.diag(A)).max() <= 1e-13 * np.abs(diag).max()
    d_jax = np.asarray(jax_ssh.ssh_matrix_diagonal(jm, cfg))
    assert np.abs(diag - d_jax).max() <= 1e-13 * np.abs(d_jax).max()


def test_mesh_and_forcing_from_numpy(meshes):
    """The JAX mesh and forcing, carried over by ``convert``, equal the
    port's own (the route the parity tests take for states)."""
    from fesom2_tpu.core.state import zero_forcing as jax_zero_forcing
    from fesom2_tpu_torch.convert import forcing_from_numpy, mesh_from_numpy
    from fesom2_tpu_torch.core.state import zero_forcing
    jm, tm = meshes
    back = mesh_from_numpy({f.name: getattr(jm, f.name) if
                            isinstance(getattr(jm, f.name), (int, float))
                            else np.asarray(getattr(jm, f.name))
                            for f in dataclasses.fields(jm)}, "cpu")
    for f in dataclasses.fields(tm):
        a, b = getattr(back, f.name), getattr(tm, f.name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert torch.allclose(a, b, rtol=1e-13, atol=0.0) \
                if b.is_floating_point() else torch.equal(a, b), f.name
        elif f.name == "cluster":
            assert a.tile_nodes == b.tile_nodes
            assert torch.equal(a.mean_slot, b.mean_slot)
            assert torch.equal(a.fct_slot, b.fct_slot)
        else:
            assert a == b, f.name
    jf = jax_zero_forcing(jm)
    tf = forcing_from_numpy({f.name: np.asarray(getattr(jf, f.name))
                             for f in dataclasses.fields(jf)}, "cpu")
    ref = zero_forcing(tm)
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(tf, f.name), getattr(ref, f.name)), f.name


def test_port_imports_no_jax():
    code = ("import sys, fesom2_tpu_torch, fesom2_tpu_torch.model, "
            "fesom2_tpu_torch.run, fesom2_tpu_torch.convert, "
            "fesom2_tpu_torch.ice.state, fesom2_tpu_torch.ice.subdomain, "
            "fesom2_tpu_torch.ice.coupling, fesom2_tpu_torch.ice.thermo, "
            "fesom2_tpu_torch.ice.evp, fesom2_tpu_torch.ice.fct, "
            "fesom2_tpu_torch.ice.step, fesom2_tpu_torch.forcing.bulk, "
            "fesom2_tpu_torch.forcing.atmos, "
            "fesom2_tpu_torch.forcing.interp, "
            "fesom2_tpu_torch.forcing.prefetch, "
            "fesom2_tpu_torch.forcing.tides, "
            "fesom2_tpu_torch.forcing.gotm_bulk, "
            "fesom2_tpu_torch.forcing.synthetic, "
            "fesom2_tpu_torch.io.netcdf, fesom2_tpu_torch.utils.clock, "
            "fesom2_tpu_torch.utils.support, fesom2_tpu_torch.core.ic, "
            "fesom2_tpu_torch.ice.thermo_cpl, "
            "fesom2_tpu_torch.scripts.gather_cost_model, "
            "fesom2_tpu_torch.scripts.cluster_kernel_times, "
            "fesom2_tpu_torch.mesh.cluster, "
            "fesom2_tpu_torch.parallel.partition, "
            "fesom2_tpu_torch.ice.icepack, "
            "fesom2_tpu_torch.ice.icepack.driver, "
            "fesom2_tpu_torch.ice.icepack.ponds, "
            "fesom2_tpu_torch.ice.icepack.dedd, "
            "fesom2_tpu_torch.ice.icepack.fsd, "
            "fesom2_tpu_torch.ice.icepack.bgc, "
            "fesom2_tpu_torch.core.diag, fesom2_tpu_torch.core.diagnostics, "
            "fesom2_tpu_torch.io.restart, fesom2_tpu_torch.io.mesh_info, "
            "fesom2_tpu_torch.io.streams, "
            "fesom2_tpu_torch.parallel.dist, "
            "fesom2_tpu_torch.parallel.padding, fesom2_tpu_torch.mkrun, "
            "fesom2_tpu_torch.post.fcheck, fesom2_tpu_torch.post, "
            "fesom2_tpu_torch.post.mesh_loader, "
            "fesom2_tpu_torch.post.regrid, fesom2_tpu_torch.post.moc, "
            "fesom2_tpu_torch.post.climatology, "
            "fesom2_tpu_torch.post.fpost, fesom2_tpu_torch.post.plot, "
            "fesom2_tpu_torch.coupler, fesom2_tpu_torch.coupler.transport, "
            "fesom2_tpu_torch.coupler.oasis, "
            "fesom2_tpu_torch.utils.profiling, "
            "fesom2_tpu_torch.parallel.sharding; "
            "fesom2_tpu_torch.parallel.partition.build(); "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'fesom2_tpu' "
            "or m.startswith('fesom2_tpu.')]; "
            "assert not bad, bad; "
            "from fesom2_tpu_torch.model import pi_coupled_step_fn, "
            "pi_initial_state, setup_pi_model; "
            "from fesom2_tpu_torch.run import run_pi, globe_atm_data")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
