"""The port's own ``config`` and ``constants`` against the JAX package's.

``fesom2_tpu_torch`` imports nothing of ``fesom2_tpu``, so it keeps copies
of these two jax-free modules.  The copies must not drift: every constant
has the same value, and ``ModelConfig`` with its nested dataclasses has the
same fields, types and defaults.
"""
import dataclasses

import pytest

import fesom2_tpu.config as jconfig
import fesom2_tpu.constants as jconstants
import fesom2_tpu_torch.config as tconfig
import fesom2_tpu_torch.constants as tconstants


def _values(module):
    return {k: v for k, v in vars(module).items()
            if not k.startswith("_") and isinstance(v, (int, float))}


def test_constants_equal_value_for_value():
    ref, got = _values(jconstants), _values(tconstants)
    assert ref and set(got) == set(ref)
    for name, value in ref.items():
        assert got[name] == value and type(got[name]) is type(value), name


def _config_classes(module):
    return {name: cls for name, cls in vars(module).items()
            if isinstance(cls, type) and dataclasses.is_dataclass(cls)}


CONFIG_CLASSES = sorted(_config_classes(jconfig))


def test_config_modules_hold_the_same_dataclasses():
    assert CONFIG_CLASSES and "ModelConfig" in CONFIG_CLASSES
    assert sorted(_config_classes(tconfig)) == CONFIG_CLASSES


def _plain(value):
    """A default as plain data, nested dataclasses by their class name."""
    if dataclasses.is_dataclass(value):
        return (type(value).__name__,
                {f.name: _plain(getattr(value, f.name))
                 for f in dataclasses.fields(value)})
    return value


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_dataclass_has_the_same_fields_and_defaults(name):
    ref, got = getattr(jconfig, name), getattr(tconfig, name)
    rf, gf = dataclasses.fields(ref), dataclasses.fields(got)
    assert [f.name for f in gf] == [f.name for f in rf]
    assert [str(f.type) for f in gf] == [str(f.type) for f in rf]
    assert _plain(got()) == _plain(ref())


def test_load_config_reads_a_namelist_alike(tmp_path):
    nml = tmp_path / "namelist.config"
    nml.write_text("&timestep\nstep_per_day=96\nrun_length=3\n/\n"
                   "&ale_def\nwhich_ALE='zstar'\nuse_partial_cell=.true.\n/\n")
    ref, got = jconfig.load_config(str(nml)), tconfig.load_config(str(nml))
    assert _plain(got) == _plain(ref)
    assert got.ale.which_ALE == "zstar" and got.ale.use_partial_cell is True
