"""The plain reference on the CPU: it imports nothing of the program,
agrees with the program's CPU path on the level-3 globe, and the check
built on it says "not correct" for the float32 control and for a timed
path broken in each way the cells can break."""
import dataclasses
import json
import subprocess
import sys

import pytest
import torch

from ocean_bench import check, control, spec
from ocean_bench.run import mesh_dir, run_cell

CONFIGS = {"core2_ci_l7": "ci_l7.base", "core2_icepack_l7": "icepack_l7.base"}
SEED = 2 ** 31 + 3


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys, json\n"
            "import ocean_bench.check, ocean_bench.reference.fesom.model\n"
            "import ocean_bench.reference.fesom.ice.icepack\n"
            "print(json.dumps(sorted(sys.modules)))")
    mods = json.loads(subprocess.run([sys.executable, "-c", code],
                                     capture_output=True, text=True,
                                     cwd=spec.ROOT, check=True).stdout)
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"jax", "jaxlib", "flax", "fesom2_tpu",
                       "fesom2_tpu_torch"}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_the_reference_agrees_with_the_programs_cpu_path(config):
    """Two coupled steps from each side's own set-up on the level-3 globe:
    on the CPU the program runs its plain versions, so the two agree bit
    for bit."""
    from fesom2_tpu_torch.model import (globe_atm_data, pi_config,
                                        pi_initial_state, setup_pi_model)
    from fesom2_tpu_torch.run import run_pi
    cell = spec.cell(CONFIGS[config])
    mdir = str(mesh_dir(cell, level=3))
    phys = cell.config["physics"]
    cfg = pi_config(phys["parity"], phys["step_per_day"])
    spec.apply_config(cfg, cell)
    model, _ = setup_pi_model(mdir, device="cpu", cfg=cfg)
    atm = globe_atm_data(model, SEED, n_records=cell.traffic["atm_records"])
    kw = {}
    if cell.config["icepack"] is not None:
        kw = dict(use_icepack=True, icepack_opts={})
    prog = check.snapshot(*run_pi(model, atm, *pi_initial_state(model, SEED),
                                  2, **kw))
    ref = check.Reference(mdir, cell, SEED, "cpu", torch.float64)
    got = check.snapshot(*ref.steps(*ref.initial(), 0, 2))
    assert check.state_gap(prog, got, check.EVERY) == (0.0, "")
    assert all(g[0] == 0.0 for g in check.gap_table(prog, got).values())
    assert set(prog) == set(got) == ({"ocean", "ice", "ipk"} if kw
                                     else {"ocean", "ice"})


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_the_float32_control_fails_and_the_program_passes(config):
    cell = spec.cell(CONFIGS[config])
    limits = cell.config["limits"]
    row = next(control.readings(cell, [SEED], [SEED], calls=1, device="cpu",
                                level=3))
    names = [n for n in row if n.endswith("_gap")
             and not n.startswith("control_")]
    assert sorted(names) == sorted(limits)
    for name in names:
        assert row[name][0] <= limits[name]
    assert any(row[f"control_{name}"][0] > limits[name] for name in names)


def _frozen(run_pi):
    """A run_pi whose steps return the state they were given."""
    def run(model, atm, state, ice, n, **kw):
        out = run_pi(model, atm, state, ice, 0, **kw)
        return out
    return run


def _altered(run_pi):
    """A run_pi whose answer has one value altered where it is made: one
    surface temperature raised by a tenth of a degree."""
    def run(model, atm, state, ice, n, **kw):
        out = run_pi(model, atm, state, ice, n, **kw)
        tr = out[0].tr.clone()
        tr[0, 0, tr.shape[-1] // 2] += 0.1
        return (dataclasses.replace(out[0], tr=tr),) + tuple(out[1:])
    return run


@pytest.mark.parametrize("fault", [_frozen, _altered])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_a_broken_timed_path_is_not_correct(config, fault, monkeypatch):
    """The rest of a run, past the look for a card, with the program's
    ``run_pi`` broken underneath: ``correct`` comes out false."""
    import fesom2_tpu_torch.run as prog_run
    monkeypatch.setattr(prog_run, "run_pi", fault(prog_run.run_pi))
    cell = spec.cell(CONFIGS[config])
    result, info = run_cell(cell, SEED, 0.5, False, device="cpu", level=3)
    assert result["correct"] is False
    assert any(v["value"] > v["limit"] for v in result["checks"].values())
