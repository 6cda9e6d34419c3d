"""BENCHMARK.json keeps to its schema and limits, every file it names is
found by name, a new cell is added by new files alone, and the result
line has the keys the check reads."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from benchlib import spec
from conftest import BENCH

import test_bench_dryrun as dry

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len((BENCH.parent / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    for group in (names, [c["name"] for c in SPEC["configs"]],
                  [w["name"] for w in SPEC["workloads"]]):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (BENCH.parent / c["file"]).is_file()
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(
        1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves(cell):
    c = spec.resolve(cell, SPEC)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    assert c.traffic["end_to_end"] in e2e
    assert (BENCH / "drivers" / f"{c.traffic['driver']}.py").is_file()
    assert c.limits and c.config["family"]
    for m in c.per_layer:
        assert m["moves"] in e2e


def test_a_new_cell_is_found_by_its_files(tiny_bench):
    """A cell that the harness was not told of: a new traffic file and a
    limits file, and its entry in the spec, run with no harness change."""
    spec_data, bench_dir = tiny_bench
    traffic = json.loads((bench_dir / "traffic" / "tiny-train.json")
                         .read_text())
    traffic.update(batch_size=1, update_freq=3)
    (bench_dir / "traffic" / "tiny-train-b1.json").write_text(
        json.dumps(traffic))
    shutil.copy(bench_dir / "limits" / "tiny.lna.json",
                bench_dir / "limits" / "tiny.lna-b1.json")
    spec_data["workloads"].append({"name": "tiny.lna-b1",
                                   "config": "tiny-lna",
                                   "traffic": "tiny-train-b1", "chips": 1,
                                   "why": "a cell added by files"})
    for m in spec_data["end_to_end"] + spec_data["per_layer"]:
        if "tiny.lna" in m.get("workloads", []):
            m["workloads"].append("tiny.lna-b1")
    line = dry.tiny_run(tiny_bench, "tiny.lna-b1")
    assert line["correct"] and line["attempted"] > 0


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_schema(tiny_bench, trace):
    line = dry.tiny_run(tiny_bench, "tiny.lna", trace)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        for key in ("device_ops", "idle_gaps"):
            assert len(line["breakdown"][key]) <= 10
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)
