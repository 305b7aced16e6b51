"""The fast configuration (linfs + PP, full cells) with the ice shelf of
``globe.shelf_draft`` and cavity partial cells, in the port against the
JAX package (CPU, float64): three coupled steps on the level-3 globe (12
layers, dense SSH solve, 8 mEVP subcycles) for each PGF form linfs takes
there, 'sergey', 'shchepetkin' and 'easypgf', within 1e-9 of each field's
largest JAX magnitude (``tests/test_torch_fast_parity.py``'s dense
tolerance; Kv and Av on the interfaces each column has, as in
``test_torch_cavity.py``), with the cavity's gates: no ice under the
shelf, melt there, nothing above each column's top.
"""
import pytest
import torch

from fesom2_tpu_torch.mesh import globe
from fesom2_tpu_torch.model import pi_config

from test_torch_cavity import assert_cavity_gates, assert_cavity_steps_close
from test_torch_coupled import coupled_pair, run_both
from test_torch_kpp import assert_close


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    torch.set_num_threads(1)
    return globe.write_globe(str(tmp_path_factory.mktemp("shelf")), level=3,
                             n_layers=12, dz_bottom=1000.0, shelf=True)


@pytest.mark.parametrize("which", ["sergey", "shchepetkin", "easypgf"])
def test_three_fast_shelf_steps_match_jax(path, which):
    cfg = pi_config("fast")
    cfg.ice.evp_rheol_steps = 8
    cfg.run.use_cavity = True
    cfg.run.use_cavity_partial_cell = True
    cfg.dyn.which_pgf = which
    p = coupled_pair(path, cfg)
    p.tmesh = p.tm.mesh
    jax_out, port_out = run_both(p, 3)
    assert_cavity_steps_close(p, jax_out, port_out, tol=1e-9)
    assert_close(port_out[2].virtual_salt, jax_out[2].virtual_salt,
                 "virtual_salt", tol=1e-9)
    assert_cavity_gates(p, port_out)
    assert float(port_out[0].u.abs().max()) > 1e-4
