"""The code-built global mesh (``fesom2_tpu_torch/mesh/globe.py``): the
generator's properties, the port's mesh tables against the JAX package's
(partial cells and ``force_rotation``; integers bitwise, floats to 1e-13
of their largest magnitude) and the SSH operator SPD, on the level-3
globe (642 vertices before the land mask) with 12 layers.
"""
import dataclasses

import numpy as np
import pytest
import torch

from fesom2_tpu.config import ModelConfig
from fesom2_tpu.mesh import build_mesh as jax_build_mesh
from fesom2_tpu.core import ssh as jax_ssh

from fesom2_tpu_torch.core import ssh
from fesom2_tpu_torch.mesh import build_mesh, globe, read_raw_mesh

LEVELS = dict(n_layers=12, dz_bottom=1000.0)
PC = dict(force_rotation=True, cyclic_length_deg=360.0,
          use_partial_cell=True, partial_cell_thresh=0.0)


@pytest.fixture(scope="module")
def mesh_dir(tmp_path_factory):
    return globe.write_globe(str(tmp_path_factory.mktemp("globe")), level=3,
                             **LEVELS)


@pytest.fixture(scope="module")
def meshes(mesh_dir):
    return jax_build_mesh(mesh_dir, **PC), build_mesh(mesh_dir, device="cpu",
                                                      **PC)


@pytest.fixture(scope="module")
def ocean():
    return globe.ocean_triangulation(3)


def test_triangles_clockwise_from_outside(ocean):
    v, tri, _ = ocean
    a, b, c = v[tri[:, 0]], v[tri[:, 1]], v[tri[:, 2]]
    assert ((np.cross(b - a, c - a) * a).sum(1) < 0).all()


def test_one_component_without_vertex_contacts(ocean):
    v, tri, coast = ocean
    assert globe._largest_component(tri).all()
    assert not globe._pinch_nodes(tri, v.shape[0]).any()
    # every node is used, some lie on a coast, most do not
    assert np.array_equal(np.unique(tri), np.arange(v.shape[0]))
    assert 0 < coast.sum() < v.shape[0] // 2


def test_model_poles_under_land_and_high_latitude_ocean(ocean):
    v, _, _ = ocean
    for pole in globe.model_poles():
        ang = np.degrees(np.arccos(np.clip(v @ pole, -1.0, 1.0)))
        assert ang.min() > globe.POLE_CAP_DEG - 5.0
    lat = np.degrees(np.arcsin(v[:, 2]))
    assert (lat > 40.0).sum() > 5 and (lat < -40.0).sum() > 5


def test_levels_and_sizes():
    zbar = globe.stretched_levels()
    dz = -np.diff(zbar)
    assert zbar.shape == (48,) and zbar[-1] == -6000.0
    assert abs(dz[0] - 10.0) < 1e-9 and abs(dz[-1] - 250.0) < 1e-6
    assert (np.diff(dz) > 0).all()
    assert globe.icosphere(3)[0].shape == (642, 3)


def test_files_hold_geographic_coordinates_and_depths(mesh_dir):
    raw = read_raw_mesh(mesh_dir)
    want = globe.globe_raw_mesh(3, **LEVELS)
    assert np.array_equal(raw.coords_deg, want.coords_deg)
    assert np.array_equal(raw.elem_nodes, want.elem_nodes)
    assert np.array_equal(raw.depth, want.depth)
    assert np.array_equal(raw.zbar, want.zbar)


def test_mesh_tables_match_jax(meshes):
    jm, tm = meshes
    for f in dataclasses.fields(jm):
        a, b = getattr(jm, f.name), getattr(tm, f.name)
        if not isinstance(b, torch.Tensor):
            assert a == b, f.name
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, f.name
        if a.dtype.kind in "biu":
            assert np.array_equal(a, b), f.name
        else:
            scale = max(float(np.abs(a).max()), 1e-300)
            assert float(np.abs(a - b).max()) <= 1e-13 * scale, f.name


def test_float32_tables_are_the_float64_tables_rounded(tmp_path):
    """``build_mesh`` computes in float64 and rounds at the end, so the
    float32 tables equal the float64 ones cast (``chip_smoke.py`` phase 3
    casts the subdivision-numbered globe's tables so), here on the level-4
    globe in subdivision numbering."""
    from fesom2_tpu_torch.parallel.dist import tree_map
    path = globe.write_globe(str(tmp_path), level=4, numbering="subdivision")
    kw = dict(PC, device="cpu")
    cast = tree_map(lambda t: t.to(torch.float32) if t.is_floating_point()
                    else t, build_mesh(path, dtype=torch.float64, **kw))
    want = build_mesh(path, dtype=torch.float32, **kw)

    def fields(x, y, pre=""):
        for f in dataclasses.fields(x):
            a, b = getattr(x, f.name), getattr(y, f.name)
            if dataclasses.is_dataclass(a):
                yield from fields(a, b, pre + f.name + ".")
            else:
                yield pre + f.name, a, b

    n = 0
    for name, a, b in fields(cast, want):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), name
            n += 1
        else:
            assert a == b, name
    assert n > 40


def test_depth_varies_with_partial_cells(meshes):
    _, tm = meshes
    nln = tm.nlevels_node.numpy()
    assert len(np.unique(nln)) >= 4 and nln.min() >= 5
    full = (tm.zbar[(tm.nlevels_node - 2).long()]
            - tm.zbar[(tm.nlevels_node - 1).long()]).numpy()
    part = tm.bottom_node_thickness.numpy()
    assert (np.abs(part - full) > 1.0).mean() > 0.5


def test_ssh_operator_spd(meshes):
    jm, tm = meshes
    cfg = ModelConfig()
    cfg.timestep.step_per_day = 96
    A = ssh.ssh_dense_matrix(tm, cfg)
    assert np.abs(A - A.T).max() <= 1e-12 * np.abs(A).max()
    assert np.linalg.eigvalsh(0.5 * (A + A.T)).min() > 0.0
    A_jax = np.asarray(jax_ssh.ssh_dense_matrix(jm, cfg))
    assert np.abs(A - A_jax).max() <= 1e-13 * np.abs(A_jax).max()


def test_fixtures(meshes):
    _, tm = meshes
    fx = globe.globe_fixtures(tm.geo_coords[:, 1].numpy(),
                              tm.elem_nodes.numpy(), tm.Z.numpy(),
                              tm.nlevels_node.numpy(), tm.area[0].numpy(),
                              seed=3)
    area = tm.area[0].numpy()
    wf = fx["water_flux"]
    assert abs((wf * area).sum() / area.sum()) < 1e-20
    assert np.abs(wf).max() > 1e-9
    wet = tm.node_layer_mask.numpy()
    assert fx["T"][wet].min() > -3.0 and fx["T"][wet].max() < 35.0
    assert (fx["T"][~wet] == 0.0).all() and (fx["S"][~wet] == 0.0).all()
    assert abs(np.abs(fx["stress_x"]).max() - 0.1) < 0.01
    assert (fx["stress_y"] == 0.0).all() and (fx["shortwave"] >= 0.0).all()
    again = globe.globe_fixtures(tm.geo_coords[:, 1].numpy(),
                                 tm.elem_nodes.numpy(), tm.Z.numpy(),
                                 tm.nlevels_node.numpy(), area, seed=3)
    assert np.array_equal(again["T"], fx["T"])
