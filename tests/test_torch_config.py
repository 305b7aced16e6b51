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


ICE_CONSTANTS = ("rhoair", "inv_rhoair", "rhowat", "inv_rhowat", "rhoice",
                 "inv_rhoice", "rhosno", "inv_rhosno", "cpair", "cc", "cl",
                 "clhw", "clhi", "tmelt", "boltzmann", "Sice", "iclasses",
                 "hmin", "Armin", "Ch_atm_ice", "Ce_atm_ice")


def test_ice_constants_equal_value_for_value():
    """The ice module's constants (``ice/state.py``), the transfer
    coefficient over ice and the bulk formulae's, copied value for value."""
    import fesom2_tpu.forcing.atmos as jatmos
    import fesom2_tpu.forcing.bulk as jbulk
    import fesom2_tpu.ice.state as jice
    import fesom2_tpu_torch.forcing.atmos as tatmos
    import fesom2_tpu_torch.forcing.bulk as tbulk
    import fesom2_tpu_torch.ice.state as tice
    ref, got = _values(jice), _values(tice)
    assert set(ICE_CONSTANTS) <= set(ref) and set(got) == set(ref)
    for name, value in ref.items():
        assert got[name] == value and type(got[name]) is type(value), name
    assert tatmos.Cd_atm_ice == jatmos.Cd_atm_ice
    for name in ("grav", "vonkarm", "q1", "q2", "u10min"):
        assert getattr(tbulk, name) == getattr(jbulk, name), name


# what the coupled step reads of cfg.ice (ice/evp.py, ice/fct.py,
# ice/thermo.py, ice/coupling.py, model.py)
ICE_CONFIG_FIELDS = ("whichEVP", "evp_subdomain_lat", "Pstar", "ellipse",
                     "c_pressure", "delta_min", "evp_rheol_steps",
                     "alpha_evp", "beta_evp", "Cd_oce_ice", "ice_gamma_fct",
                     "ice_ave_steps", "emiss_ice", "emiss_wat", "albsn",
                     "albsnm", "albi", "albim", "albw", "con", "consn")


@pytest.mark.parametrize("name", ICE_CONFIG_FIELDS)
def test_ice_config_field_has_the_same_default(name):
    ref, got = jconfig.IceConfig(), tconfig.IceConfig()
    assert getattr(got, name) == getattr(ref, name)
    assert type(getattr(got, name)) is type(getattr(ref, name))


def test_pi_config_sets_the_ice_as_the_jax_setup_does():
    """``pi_config()`` against ``fesom2_tpu/model.py:793-836``: the ice on,
    mEVP with 120 subcycles on the subdomain poleward of 40 degrees."""
    from fesom2_tpu_torch.model import pi_config
    cfg = pi_config()
    assert cfg.run.use_ice and cfg.run.use_sw_pene
    assert (cfg.ice.whichEVP, cfg.ice.evp_rheol_steps,
            cfg.ice.evp_subdomain_lat) == (1, 120, 40.0)
    assert cfg.ice.ice_ave_steps == 1


def test_load_config_reads_a_namelist_alike(tmp_path):
    nml = tmp_path / "namelist.config"
    nml.write_text("&timestep\nstep_per_day=96\nrun_length=3\n/\n"
                   "&ale_def\nwhich_ALE='zstar'\nuse_partial_cell=.true.\n/\n")
    ref, got = jconfig.load_config(str(nml)), tconfig.load_config(str(nml))
    assert _plain(got) == _plain(ref)
    assert got.ale.which_ALE == "zstar" and got.ale.use_partial_cell is True
