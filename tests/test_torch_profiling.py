"""The port's per-phase profile (``fesom2_tpu_torch/utils/profiling.py``)
on the level-3 globe on the CPU, one timed call a phase (``n=1``): the
table's keys are those of the JAX package's ``profile_pi_phases``, read
from its source with ``ast`` (the JAX function itself builds the reference
mesh, which the tests do not have), every value finite and >= 0, and
``sum_of_phases`` the sum of its seven terms.
"""
import ast
import math
import os

import pytest
import torch

from fesom2_tpu_torch.mesh import globe
from fesom2_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_keys():
    """The string keys the JAX function stores into ``results``, and the
    names its ``sum_of_phases`` adds."""
    src = open(os.path.join(REPO, "fesom2_tpu", "utils", "profiling.py")
               ).read()
    keys, summed = set(), set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Subscript) and isinstance(
                node.value, ast.Name) and node.value.id == "results" \
                and isinstance(node.slice, ast.Constant):
            keys.add(node.slice.value)
        if isinstance(node, ast.Compare) and isinstance(
                node.comparators[0], ast.Tuple):
            summed |= {e.value for e in node.comparators[0].elts}
    return keys, summed


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    torch.set_num_threads(1)
    path = globe.write_globe(str(tmp_path_factory.mktemp("globe")), level=3)
    return profiling.profile_pi_phases(path, device="cpu", n=1,
                                       verbose=False)


def test_keys_equal_jax(table):
    keys, summed = jax_keys()
    assert set(table) == keys and len(keys) == 12
    assert set(profiling.PHASES) == summed


def test_values_and_sum(table):
    assert all(math.isfinite(v) and v >= 0.0 for v in table.values())
    assert table["sum_of_phases"] == sum(table[k] for k in profiling.PHASES)
    assert table["coupled_total"] > 0.0 and table["ice_evp"] > 0.0
    assert table["ice_plus_forcing"] == max(
        table["coupled_total"] - table["ocean_total"], 0.0)
