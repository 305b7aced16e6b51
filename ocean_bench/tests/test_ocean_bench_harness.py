"""The harness on the CPU: BENCHMARK.json against its files and the
contract's shape, a short run of every cell on the level-3 globe, the
import check, the frozen counters against pinned numbers, the trace
reductions and the readers."""
import json
import re
import subprocess
import sys

import pytest
import torch

from ocean_bench import spec, trace, work
from ocean_bench.run import BANNED, banned_modules, run_cell

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def test_every_name_resolves_to_its_files():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["ocean_bench"]
    names = [c["name"] for c in BENCH["configs"]]
    for c in BENCH["configs"]:
        assert spec.ROOT.joinpath(c["file"]) == spec.config_path(c["name"])
        cfg = json.loads(spec.config_path(c["name"]).read_text())
        assert cfg["name"] == c["name"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert set(cfg["assumed"]) >= set(c["reduced"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for w in BENCH["workloads"]:
        assert w["config"] in names and w["chips"] in (1, 4)
        assert spec.traffic_path(w["traffic"]).exists()
        cell = spec.cell(w["name"])
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in BENCH["per_layer"]:
        assert spec.metric_path(m["name"]).exists()
        assert callable(spec.load_reader(m["name"]))
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for n in CELLS + names:
        assert NAME.match(n)


@pytest.mark.parametrize("trace_on", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_of_each_cell_on_the_cpu(name, trace_on):
    cell = spec.cell(name)
    result, info = run_cell(cell, 2 ** 31 + 7, 2.0, trace_on, device="cpu",
                            level=3)
    line = json.loads(json.dumps(result))
    assert RESULT_KEYS <= set(line) and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= cell.traffic["steps_per_call"]
    want = cell.per_layer if trace_on else cell.end_to_end
    assert set(line["metrics"]) <= {m["name"] for m in want}
    if not trace_on:
        assert set(line["metrics"]) == {"sypd", "setup_s"}
        assert all(v["value"] > 0 for v in line["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    limits = cell.config["limits"]
    assert list(line["checks"]) == ["start_gap", "step_gap"] == list(limits)
    assert [x.split()[1] for x in info[-len(limits):]] == list(
        line["checks"])


def test_nothing_of_jax_is_loaded():
    code = ("import sys, json, ocean_bench.run, ocean_bench.check, "
            "ocean_bench.control, ocean_bench.work, ocean_bench.trace\n"
            "from ocean_bench import spec\n"
            "for m in spec.benchmark()['per_layer']:\n"
            "    spec.load_reader(m['name'])\n"
            "import fesom2_tpu_torch.run, fesom2_tpu_torch.model\n"
            "print(json.dumps(sorted(sys.modules)))")
    mods = json.loads(subprocess.run([sys.executable, "-c", code],
                                     capture_output=True, text=True,
                                     cwd=spec.ROOT, check=True).stdout)
    tops = {m.split(".")[0] for m in mods}
    assert not tops & set(BANNED)
    assert "fesom2_tpu_torch" in tops


def test_banned_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "fesom2_tpu_torchx", sys)
    monkeypatch.setitem(sys.modules, "jaxopt_like", sys)
    assert banned_modules() == []
    monkeypatch.setitem(sys.modules, "fesom2_tpu.model", sys)
    assert banned_modules() == ["fesom2_tpu.model"]


# the level-7 globe's shapes and the cells' launch shapes
N, E, ED, L = 114033, 225854, 339891, 47
SIZES = [281 + (i * 37) % 88 for i in range(445)]

# (counter, its arguments, (bytes, flops)) at the cells' shapes, as the
# program's counters gave them at git e5ef625: pinned, so that the frozen
# copies stay the yardstick whatever the program's counters become
PINNED = [
    ("ops.node_edge_reduce_work", (2 * L, ED, N, 12, True, 8),
     (443524416, 771775344)),
    ("ops.node_edge_reduce_work", (L, ED, N, 12, False, 4),
     (96284880, 257258448)),
    ("ops.elem_to_node_mean_work", (2, L, E, N, 9, 8, 700000, 256),
     (270712376, 300134856)),
    ("ops.elem_to_node_mean_work", (6, 1, E, N, 9, 8), (22226596, 19157544)),
    ("ops.elem_contrib_to_nodes_work", (6, E, N, 9, 8), (42101748, 6157782)),
    ("ops.elem_contrib_to_nodes_work", (2, 70523, 36153, 9, 4),
     (3283284, 650754)),
    ("ops.tridiag_solve_work", (2, L, N, 8), (300134856, 69674163)),
    ("ops.tridiag_solve_work", (2, L, E, 8), (594447728, 137996794)),
    ("ops.tridiag_solve_work", (6, L, N, 8), (643146120, 176865183)),
    ("ops.tridiag_solve_work", (2, L + 1, N, 4), (153260352, 71156592)),
    ("ssh.ring_spmv_work", (10, N, 8), (15508488, 2280660)),
    ("ssh.block_schwarz_packed_work", (N, SIZES, 8, 12, 8),
     (386971316, 95575308)),
    ("ssh.block_schwarz_packed_work", (N, SIZES, 8, 12, 4),
     (195877736, 95575308)),
    ("tracers.fct_bounds_work", (2, L, N, 8, 8, 900000, 256),
     (351174372, 407325876)),
    ("tracers.fct_bounds_work", (6, L, N, 8, 8, 900000, 256),
     (1037196900, 1221977628)),
    ("eos.pressure_bv_work", (L, N, 4305481, 1, 8), (382730040, 710404365)),
    ("kpp.kpp_column_work", (L + 1, N, 4305481, False, 8),
     (375665876, 861096200)),
    ("kpp.kpp_column_work", (L + 1, N, 4305481, True, 4),
     (278843036, 1119425060)),
    ("evp.mevp_subcycles_work", (36153, 70523, 9, 8, 120),
     (16091536, 865709880)),
    ("evp.mevp_subcycles_work", (N, E, 9, 8, 120), (51233236, 2759263080)),
    ("evp.evp_subcycles_work", (36153, 70523, 9, 8, 120),
     (15513088, 908023680)),
    ("evp.aevp_subcycles_work", (36153, 70523, 9, 8, 120),
     (17219904, 860943600)),
    ("thermo_vertical.temperature_solve_work", (5, N, 4, 4, 8, 18),
     (146532405, 2183731950)),
    ("thermo_vertical.temperature_solve_work",
     (5, N, 4, 4, 8, 0, True, "MU71"), (155655045, 33069570)),
    ("itd.itd_remap_work", (5, 12, N, 8, True), (118594320, 214838172)),
    ("itd.itd_remap_work", (5, 12, N, 8, False), (109471680, 67507536)),
]


@pytest.mark.parametrize("counter, args, want", PINNED,
                         ids=[f"{c}-{i}" for i, (c, _, _) in
                              enumerate(PINNED)])
def test_frozen_work_counters_give_the_pinned_numbers(counter, args, want):
    module, fn = counter.split(".")
    assert tuple(getattr(getattr(work, module), fn)(*args)) == want


def _t(*shape, dtype=torch.float64):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_launch_work_reads_the_launchers_arguments():
    """Arguments laid out as the program's wrappers pass them at git
    e5ef625 give the counters' numbers; arguments that do not fit give
    None."""
    from ocean_bench.reference.fesom.core import ops as fops
    f = _t(2 * L, ED)
    got = work.launch_work("node_edge_reduce", "", (
        f, 2 * L, ED, _t(12, N, dtype=torch.int32), N, 12, 4, _t(2 * L, N),
        _t(2 * L, N), 1, 1))
    assert got == (*fops.node_edge_reduce_work(2 * L, ED, N, 12, True, 8), 8)
    uv = _t(2, N)
    got = work.launch_work("mevp_subcycles", "", (
        uv, _t(3, E), None, None, None, None, None, N, E, 9, 120))
    assert got[:2] == work.evp.mevp_subcycles_work(N, E, 9, 8, 120)
    assert work.launch_work("ring_spmv", "", (1, 2)) is None
    assert work.launch_work("no_such_kernel", "", ()) is None


def test_cuda_names_map_to_kernels():
    assert work.kernel_of("void fesom::mevp_subcycles_kernel<double>(P)") \
        == "mevp_subcycles"
    assert work.kernel_of("void aevp_subcycles_kernel<float>(P)") \
        == "aevp_subcycles"
    assert work.kernel_of("evp_subcycles_kernel<double>") == "evp_subcycles"
    assert work.kernel_of("void (anonymous namespace)::schwarz_combine_"
                          "kernel<double>(...)") == "block_schwarz"
    assert work.kernel_of("at::native::vectorized_elementwise_kernel") \
        is None


def test_trace_reductions():
    kern = [("k1", 0.0, 10.0), ("k2", 5.0, 20.0), ("k3", 30.0, 40.0),
            ("Memcpy DtoH", 45.0, 50.0)]
    spans = [("step.tracers", 0.0, 25.0), ("step.tracers.adv", 4.0, 12.0),
             ("step.ssh", 28.0, 60.0)]
    assert trace.union_us(kern) == 35.0
    counts = {}
    ms = trace.span_device_ms(kern[:3], spans, 1, counts)
    assert ms == {"step.tracers": 0.01, "step.ssh": 0.01,
                  "step.tracers.adv": 0.015}
    assert counts == {"step.tracers": 1, "step.tracers.adv": 1,
                      "step.ssh": 1}
    host = [("step.forcing", 18.0, 35.0), ("step.ice", 19.0, 22.0)]
    assert trace.idle_gaps(kern, host) == [("step.ice", 10e-6),
                                           ("outside spans", 5e-6)]


def test_readers_read_nothing_from_an_empty_trace():
    r = trace.Readings(n_steps=1, kernels=[], device_ops=[], dev_spans=[],
                       host_spans=[], stretch_s=0.0)
    for m in BENCH["per_layer"]:
        assert spec.load_reader(m["name"])(r) is None, m["name"]


def _readings(**kw):
    r = trace.Readings(n_steps=2, kernels=[], device_ops=[], dev_spans=[],
                       host_spans=[], stretch_s=5.0)
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def test_idle_share_is_read_against_the_untraced_window():
    ops = [("k", 0.0, 60e3), ("Memcpy DtoH", 50e3, 80e3),
           ("k", 100e3, 180e3)]
    r = _readings(device_ops=ops, window_step_s=0.1)
    # 160 ms busy in 2 steps: 80 ms of each 100 ms step
    assert spec.load_reader("device_idle_share")(r) == pytest.approx(20.0)


def test_kernels_roofline_reads_only_whole_kernels():
    read = spec.load_reader("kernels_roofline")
    w = (3.35e9, 0.0, 8)                  # 1 ms at the card's bandwidth
    kern = [("mevp_subcycles_kernel<double>", 0.0, 2e3),
            ("ring_spmv_fixed_kernel<double>", 2e3, 4e3)]
    both = [("mevp_subcycles", w), ("ring_spmv", w)]
    r = _readings(kernels=kern, launches=both)
    assert read(r) == pytest.approx(50.0)
    assert len(r.notes) == 2 and "not read whole" not in " ".join(r.notes)
    for launches, kernels in [
            ([("mevp_subcycles", w), ("ring_spmv", None)], kern),
            (both[:1], kern),
            (both, kern[:1])]:
        r = _readings(kernels=kernels, launches=launches)
        assert read(r) is None
        assert any("not read whole" in n for n in r.notes)


def test_a_configuration_is_held_to_the_physics_it_states():
    from fesom2_tpu_torch.model import pi_config
    cell = spec.cell(CELLS[0])
    phys = cell.config["physics"]
    cfg = pi_config(phys["parity"], phys["step_per_day"])
    spec.apply_config(cfg, cell)
    cfg.dyn.mix_scheme = "cvmix_TKE"
    with pytest.raises(ValueError, match="dyn.mix_scheme"):
        spec.apply_config(cfg, cell)


def test_energy_per_area_is_enthalpy_times_volume_over_layers():
    from ocean_bench import check
    q = torch.tensor([[[-2.0, -4.0], [-6.0, -8.0]]])     # [ncat, nlyr, N]
    vol = torch.tensor([[0.5, 0.0]])                      # [ncat, N]
    snap = {"ocean": {}, "ice": {},
            "ipk": {"qin": q, "vicen": vol, "qsn": q, "vsnon": vol}}
    got = check.compared(snap, {"icepack": ["vicen", "eicen", "esnon"]})
    assert list(got) == ["icepack.vicen", "icepack.eicen", "icepack.esnon"]
    want = torch.tensor([[[-0.5, 0.0], [-1.5, 0.0]]], dtype=torch.float64)
    assert torch.equal(got["icepack.eicen"], want)
    assert torch.equal(got["icepack.esnon"], want)
    assert set(check.compared(snap, {"icepack": "*"})) == {
        "icepack.qin", "icepack.vicen", "icepack.qsn", "icepack.vsnon",
        "icepack.eicen", "icepack.esnon"}
