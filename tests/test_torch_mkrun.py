"""``mkrun`` (``fesom2_tpu_torch/mkrun.py``) and ``post/fcheck.py``
against the JAX package's, on setup files written here (CPU, float64).

The reference root is a small ``config/`` tree of namelists written by the
tests (``FESOM2_REF_ROOT``), and a paths file (``FESOM2_TPU_PATHS``) maps
the setup's mesh and forcing ids to the code-built level-3 globe and to
the NCEP test set and WOA file of ``forcing/synthetic.py``.  ``load_setup``
gives a configuration equal field for field to JAX ``mkrun.load_setup``
on the same files, with its Icepack options and stream list; the port's
YAML reader equals ``yaml.safe_load`` on every file written here and
raises outside its subset; ``run_setup`` runs 2 coupled steps on the CPU,
and its ``field_means`` equal JAX's ``field_means`` of the same result
directory; the golden check passes goldens within ``rtol`` and fails
those outside it or missing.
"""
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

import fesom2_tpu.mkrun as jmkrun
from fesom2_tpu.post.fcheck import field_means as jax_field_means

from fesom2_tpu_torch import mkrun
from fesom2_tpu_torch.forcing import synthetic
from fesom2_tpu_torch.mesh import globe
from fesom2_tpu_torch.post.fcheck import field_means

from test_torch_config import _plain

NAMELISTS = {
    "namelist.config": """
&modelname
runid='fesom'
/
&timestep
step_per_day=96
run_length=1
run_length_unit='d'
/
&clockinit
timenew=0.0
daynew=1
yearnew=1948
/
&ale_def
which_ALE='zstar'
use_partial_cell=.true.
/
&geometry
cartesian=.false.
cyclic_length=360.
force_rotation=.true.
/
&calendar
include_fleapyear=.false.
/
&run_config
use_ice=.true.
use_sw_pene=.true.
toy_ocean=.false.
/
""",
    "namelist.oce": """
&oce_dyn
state_equation=1
visc_option=5
gamma0=0.003, gamma1=0.1, gamma2=0.285
easy_bs_return=1.5
w_split=.true.
w_max_cfl=1.0
mix_scheme='KPP'
Fer_GM=.true.
Redi=.true.
K_GM_max=2000.0
K_GM_min=2.0
K_GM_bvref=2
K_GM_rampmax=-1.0
K_GM_rampmin=-1.0
scaling_Ferreira=.false.
scaling_Rossby=.false.
scaling_resolution=.true.
/
&oce_tra
K_ver=1.0e-5
K_hor=3000.
surf_relax_T=0.0
surf_relax_S=1.929e-06
clim_relax=0.0
ref_sss_local=.true.
ref_sss=34.
tra_adv_hor='MFCT'
tra_adv_ver='QR4C'
tra_adv_lim='FCT'
/
""",
    "namelist.ice": """
&ice_dyn
whichEVP=1
evp_rheol_steps=120
evp_subdomain_lat=40.0
/
&ice_therm
/
""",
    "namelist.forcing": """
&nam_sbc
/
""",
    "namelist.io": """
&diag_list
ldiag_solver=.false.
/
&nml_list
io_listsize=3
io_list = 'sst       ',1, 'm', 4,
          'ssh       ',1, 'd', 4,
          'temp      ',1, 'y', 4,
/
""",
    "namelist.icepack": """
&env_nml
nicecat=5
nicelyr=4
nsnwlyr=4
/
&tracer_nml
tr_pond_cesm=.false.
/
""",
}

SETUP = """# the CI setup of the level-3 globe
mesh: test_global
forcing: test_global
namelist.config:
  timestep:
    step_per_day: 96
    run_length: 1
    run_length_unit: "d"
  geometry:
    force_rotation: True
namelist.oce:
  oce_dyn:
    Div_c: 0.5
    Leith_c: 0.05
namelist.ice:
  ice_dyn:
    evp_rheol_steps: 8
namelist.io:
  nml_list:
    io_list:
      "sst       ":
        freq: 1
        unit: s
        prec: 8
      "ssh       ":
        freq: 2
        unit: s
        prec: 8
      "temp      ":
        freq: 1
        unit: s
        prec: 8
      'a_ice     ':
        freq: 1
        unit: s
        prec: 4
      "m_ice     ":
        freq: 1
        unit: s
        prec: 8
fcheck:
  temp: 1.701768707848739
  sst: 8.5e-01
"""

ICEPACK = """mesh: test_global
namelist.icepack:
  env_nml:
    nicecat: 3
  tracer_nml:
    tr_pond_cesm: yes
    tr_fsd: no
  nml_list_icepack:
    io_list: [1, 2]
fcheck:
  aice: 0.5
"""


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("mkrun")
    ref = root / "ref"
    (ref / "config").mkdir(parents=True)
    for name, text in NAMELISTS.items():
        (ref / "config" / name).write_text(text)
    mesh_dir = globe.write_globe(str(root / "globe"), level=3, n_layers=12,
                                 dz_bottom=1000.0)
    forcing_dir = str(root / "forcing")
    synthetic.write_ncep_test_set(forcing_dir, seed=3, nlon=48, nlat=24)
    synthetic.write_woa18(forcing_dir, seed=3)
    paths = root / "paths.yml"
    paths.write_text(f"mesh:\n  test_global: '{mesh_dir}'\n"
                     f"forcing:\n  test_global: \"{forcing_dir}\"\n")
    files = {}
    for name, text in (("setup.yml", SETUP), ("icepack.yml", ICEPACK)):
        (root / name).write_text(text)
        files[name] = str(root / name)
    files["paths.yml"] = str(paths)
    mp = pytest.MonkeyPatch()
    mp.setenv("FESOM2_REF_ROOT", str(ref))
    mp.setenv("FESOM2_TPU_PATHS", str(paths))
    mp.setattr(jmkrun, "REF_ROOT", str(ref))
    yield dict(root=root, files=files, mesh=mesh_dir, forcing=forcing_dir)
    mp.undo()


def test_yaml_reader_equals_safe_load(setup):
    for path in setup["files"].values():
        with open(path) as f:
            want = yaml.safe_load(f)
        assert mkrun.read_yaml(path) == want, path
    text = ("a: 1\nb: -2\nc: 1.5\nd: 1e-3\ne: 1.0e-06\nf: .5\ng: -.5\n"
            "h: yes\ni: Off\nj: ~\nk:\nl: 'it''s'\nm: \"a # b\"\n"
            "n: [1, 'x, y', z, 2.0]\no: plain text # note\np: 08\n"
            "q: .inf\n'r s': x\n")
    assert mkrun.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a:\n  - 1\n", "a: &x 1\n", "a: *x\n", "a: |\n  x\n", "a: >\n  x\n",
    "a: {b: 1}\n", "a: 0x10\n", "a: 010\n", "a: 1_000\n", "a: 1:30\n",
    "a: 2001-12-14\n", "---\na: 1\n", "a: b: c\n", "a: !!str 1\n",
    "a: [1,\n  2]\n", "a: 1\n\tb: 2\n", "a: [[1]]\n", "? a\n: 1\n",
    "a: 'open\n"])
def test_yaml_reader_raises_outside_its_subset(text):
    with pytest.raises(mkrun.YamlSubsetError):
        mkrun.parse_yaml(text)


@pytest.mark.parametrize("name", ["setup.yml", "icepack.yml"])
def test_load_setup_equals_jax(setup, name):
    path = setup["files"][name]
    got = mkrun.load_setup(path)
    want = jmkrun.load_setup(path)
    assert _plain(got[0]) == _plain(want[0])
    assert got[1:] == want[1:]
    cfg, mesh_path, forcing_path, goldens, ipk, io_list = got
    assert mesh_path == setup["mesh"]
    if name == "setup.yml":
        assert forcing_path == setup["forcing"]
        assert cfg.ice.evp_rheol_steps == 8 and cfg.dyn.Div_c == 0.5
        assert cfg.ice.evp_subdomain_lat == 40.0
        assert ipk is None and len(io_list) == 5
        assert io_list[3] == ("a_ice", 1, "s", "f4")
        assert goldens["temp"] == 1.701768707848739
    else:
        assert ipk == dict(ncat=3, nilyr=4, nslyr=4, tr_pond_cesm=True,
                           tr_fsd=False)
        assert [x[0] for x in io_list] == ["sst", "ssh", "temp"]


def test_load_setup_names_a_missing_mesh_id(setup, tmp_path):
    p = tmp_path / "bad.yml"
    p.write_text("mesh: nowhere\n")
    with pytest.raises(KeyError, match="nowhere"):
        mkrun.load_setup(str(p))


@pytest.fixture(scope="module")
def run(setup):
    result = str(setup["root"] / "result")
    ok, means, goldens = mkrun.run_setup(setup["files"]["setup.yml"],
                                         result, steps=2, device="cpu",
                                         verbose=False)
    return result, ok, means, goldens


def test_run_setup_field_means_equal_jax(run):
    result, ok, means, goldens = run
    assert means == jax_field_means(result)
    assert means == field_means(result)
    assert set(means) >= {"sst", "ssh", "temp", "a_ice", "m_ice"}
    assert all(np.isfinite(v) for v in means.values())
    assert 0.0 < means["a_ice"] < 1.0
    # the yaml's goldens are not this globe's: the verdict is a failure
    assert not ok and set(goldens) == {"temp", "sst"}


def test_golden_verdicts(run):
    _, _, means, _ = run
    inside = {k: v * 1.01 for k, v in means.items()}
    ok, report = mkrun.check_goldens(means, inside, rtol=0.05)
    assert ok and all(line.startswith("OK") for line in report)
    outside = dict(inside, temp=means["temp"] * 1.2)
    ok, report = mkrun.check_goldens(means, outside, rtol=0.05)
    assert not ok and any(line.startswith("FAIL temp") for line in report)
    ok, report = mkrun.check_goldens(means, dict(inside, nope=1.0), 0.05)
    assert not ok and any(line.startswith("MISSING nope") for line in report)
    # near-zero goldens are held absolutely, to 1e-3 * rtol
    ok, _ = mkrun.check_goldens({"u": 4e-5}, {"u": 0.0}, rtol=0.05)
    assert ok


def test_field_means_raise_on_a_broken_stream(run, tmp_path):
    result, _, _, _ = run
    d = tmp_path / "broken"
    d.mkdir()
    for name in os.listdir(result):
        shutil.copy(os.path.join(result, name), d / name)
    (d / "sst.fesom.1948.nc").write_bytes(b"not a netcdf file")
    (d / "restart.nc").write_bytes(b"not read")
    with pytest.raises(Exception):
        field_means(str(d))
    # the JAX function skips what it cannot read
    assert "sst" not in jax_field_means(str(d))


def test_run_driver_cli_mentions_no_missing_mkrun():
    import fesom2_tpu_torch.run as trun
    assert "not ported" not in trun.__doc__
