"""The per-layer metrics read from the program's spans (``core.trace``) on
a tiny traced CPU run of the LNA cell (``run.main(device="cpu")``): each
reads a finite number, the step's three parts lie between the device's
busy time and the window's wall time a micro-step, and a program that
records no spans leaves the five out of the line and the rest in it."""

from __future__ import annotations

import math

import pytest

import test_bench_dryrun as dry
from benchlib import spec as bspec
from benchlib import trace as btrace
from wav2vecsegmenter_tpu_torch.core import trace

SPAN_METRICS = ("data_wait_ms.lna", "forward_ms.lna", "backward_ms.lna",
                "optimizer_ms.lna", "pos_conv_bwd_ms.lna")


def cpu_op_intervals(prof):
    """The union of the host ops' intervals (microseconds): on the CPU the
    host runs the work, so its ops stand for the device's activities."""
    from torch.autograd import DeviceType

    merged: list[list[float]] = []
    for start, stop in sorted(
            (e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CPU and e.name.startswith("aten::")):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], stop)
        else:
            merged.append([start, stop])
    return [(a, b) for a, b in merged]


@pytest.fixture
def traced(tiny_bench, monkeypatch):
    """A traced tiny run with the host ops standing for the device's
    activities: (result line, metric values)."""
    spec_data, _ = tiny_bench
    names = {m["name"] for m in spec_data["per_layer"]
             if "tiny.lna" in m.get("workloads", [])}
    assert set(SPAN_METRICS) <= names
    monkeypatch.setattr(btrace, "device_intervals", cpu_op_intervals)
    trace.clear()
    line = dry.tiny_run(tiny_bench, "tiny.lna", trace=1)
    trace.clear()
    assert line["correct"], line["checks"]
    return line, {k: v["value"] for k, v in line["metrics"].items()}


def test_span_metrics_read_finite_numbers(traced):
    line, m = traced
    for name in SPAN_METRICS:
        assert name in m, name
        assert math.isfinite(m[name]) and m[name] > 0, (name, m[name])
        assert line["metrics"][name]["unit"] == "ms"


def test_step_parts_between_busy_and_wall(traced):
    line, m = traced
    parts = m["forward_ms.lna"] + m["backward_ms.lna"] + m["optimizer_ms.lna"]
    wall = line["device"]["window_s"] / line["attempted"] * 1e3
    assert m["device_ms_per_step.lna"] <= parts <= wall, (
        m["device_ms_per_step.lna"], parts, wall)
    assert m["pos_conv_bwd_ms.lna"] < m["backward_ms.lna"]


def test_program_without_spans(tiny_bench, monkeypatch):
    """The parent's case: no span recorded.  Each span reader returns None
    on its own, and the traced line holds every other per-layer metric."""
    _, bench_dir = tiny_bench
    trace.clear()
    readings = {"units": 3, "spans": {}, "busy_s": 0.0, "window_s": 1.0}
    for name in SPAN_METRICS:
        assert bspec.metric_reader(name, bench_dir)(readings) is None
    monkeypatch.setattr(trace, "on", lambda: False)
    line = dry.tiny_run(tiny_bench, "tiny.lna", trace=1)
    assert line["correct"], line["checks"]
    assert not set(SPAN_METRICS) & set(line["metrics"])
    assert {"fetch_ms.lna", "mfu.lna"} <= set(line["metrics"])
