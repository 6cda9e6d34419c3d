"""The cell a run measures, found by name in ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, cell or metric
lives in a file of its own, found by its name:

* ``benchmark/configs/<config>.json``: the model's sizes and task;
* ``benchmark/traffic/<traffic>.json``: the traffic's parameters, read by
  the one generator (``benchlib.corpus``) and naming the driver of the
  entry the window runs (``benchmark/drivers/<driver>.py``);
* ``benchmark/limits/<workload>.json``: the limits of the correctness
  comparison of that cell;
* ``benchmark/metrics/<metric>.py``: the reader of a per-layer metric.

A later change adds a cell by adding these files and its entry in
``BENCHMARK.json``, and edits none of the harness.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list       # the end-to-end metric entries this cell reports
    per_layer: list        # the per-layer metric entries this cell reports
    run_seconds: int


def load_spec(path: Path | None = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, spec: dict | None = None,
            bench_dir: Path | None = None) -> Cell:
    """The cell ``name`` of ``spec`` (``BENCHMARK.json`` by default) with
    its configuration, traffic and limits read from ``bench_dir``.  A
    per-layer metric without a ``workloads`` key applies where the cell
    reports the end-to-end metric it moves."""
    spec = load_spec() if spec is None else spec
    bench_dir = bench_dir or BENCH_DIR
    entries = [w for w in spec["workloads"] if w["name"] == name]
    if len(entries) != 1:
        known = ", ".join(w["name"] for w in spec["workloads"])
        raise KeyError(f"no workload '{name}' in BENCHMARK.json ({known})")
    w = entries[0]
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if m["moves"] in e2e_names and _applies(m, name)]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                traffic_name=w["traffic"],
                config=_read_json(bench_dir / "configs" / f"{w['config']}.json"),
                traffic=_read_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
                limits=_read_json(bench_dir / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer,
                run_seconds=int(spec["run_seconds"]))


def load_module(path: Path, name: str):
    """A module of the benchmark loaded from its file (a metric's name
    holds dots, so it is no importable module name)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    mod_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def driver(cell: Cell, bench_dir: Path | None = None):
    """The driver module of the cell's traffic."""
    bench_dir = bench_dir or BENCH_DIR
    entry = cell.traffic["driver"]
    return load_module(bench_dir / "drivers" / f"{entry}.py",
                       f"bench_driver_{entry}")


def metric_reader(metric: str, bench_dir: Path | None = None):
    """The ``read(readings)`` function of a per-layer metric."""
    bench_dir = bench_dir or BENCH_DIR
    return load_module(bench_dir / "metrics" / f"{metric}.py",
                       "bench_metric_" + metric.replace(".", "_")).read
