"""The benchmark's data: ``BENCHMARK.json`` at the repository root, and the
files it names by name under this folder.

- a configuration ``<config>``: ``configs/<config>.json``;
- a traffic mix ``<traffic>``: ``traffic/<traffic>.json``;
- a per-layer metric ``<metric>``: ``metrics/<metric>.py``, whose
  ``read(readings)`` returns the metric's value or None.

A cell (an entry of ``workloads``) pairs one configuration with one traffic
mix; nothing here knows any cell, configuration or metric by name, so a new
one is a new file and a new entry.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def config_path(name: str) -> Path:
    return HERE / "configs" / f"{name}.json"


def traffic_path(name: str) -> Path:
    return HERE / "traffic" / f"{name}.json"


def metric_path(name: str) -> Path:
    return HERE / "metrics" / f"{name}.py"


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # the metric entries this cell reports untraced
    per_layer: list       # ... and traced


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None) -> Cell:
    """The workload ``name``; raises KeyError for a name it does not list."""
    bench = bench if bench is not None else benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    with open(config_path(entry["config"])) as fh:
        config = json.load(fh)
    with open(traffic_path(entry["traffic"])) as fh:
        traffic = json.load(fh)
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def load_reader(name: str):
    """The ``read`` function of per-layer metric ``name``."""
    spec = importlib.util.spec_from_file_location(
        f"ocean_bench.metrics.{name}", metric_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def apply_config(cfg, cell: Cell) -> None:
    """Set a ``ModelConfig`` (the program's or the reference's: both have
    the same fields) to the cell: its tracers by id, then the
    configuration's ``overrides`` ({"section.field": value}); then hold it
    to the configuration's ``physics.expect`` ({"section.field": value}),
    the physics that the configuration states, and raise where a field
    differs."""
    ids = list(cell.traffic["tracer_ID"])
    cfg.tra.num_tracers = len(ids)
    cfg.tra.tracer_ID = ids
    for path, value in cell.config.get("overrides", {}).items():
        obj, last = _field(cfg, path)
        setattr(obj, last, value)
    for path, value in cell.config["physics"].get("expect", {}).items():
        obj, last = _field(cfg, path)
        _expect(path, getattr(obj, last), value)


def check_icepack(icfg, cell: Cell) -> None:
    """Hold an ``IcepackConfig`` (the program's or the reference's) to the
    configuration's ``icepack`` block: every key but ``opts`` (the options
    it is built with) names a field and its value."""
    for key, value in cell.config["icepack"].items():
        if key != "opts":
            _expect(f"icepack.{key}", getattr(icfg, key), value)


def _field(cfg, path: str):
    obj = cfg
    *head, last = path.split(".")
    for h in head:
        obj = getattr(obj, h)
    if not hasattr(obj, last):
        raise KeyError(f"configuration field {path}: no such field")
    return obj, last


def _expect(path: str, got, want) -> None:
    if got != want:
        raise ValueError(f"configuration field {path} is {got!r}, the "
                         f"configuration states {want!r}")
