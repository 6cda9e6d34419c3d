"""A tiny CPU run of the driver, through the hook that only the tests use
(``run.main(device="cpu", ...)``)."""

from __future__ import annotations

import pytest
import torch

import run

ARGS = ["--seed", "2147483659", "--seconds", "0.5"]


def tiny_run(tiny_bench, cell, trace=0, control=False):
    spec, bench_dir = tiny_bench
    torch.manual_seed(0)
    return run.main(["--workload", cell, "--trace", str(trace)] + ARGS,
                    device="cpu", spec_data=spec, bench_dir=bench_dir,
                    control=control)


@pytest.mark.parametrize("trace", [0, 1])
def test_dry_run(tiny_bench, trace):
    cell = "tiny.lna"
    line = tiny_run(tiny_bench, cell, trace)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    spec = tiny_bench[0]
    if trace:
        names = {m["name"] for m in spec["per_layer"]
                 if cell in m.get("workloads", [])}
        assert line["metrics"] and set(line["metrics"]) <= names
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        e2e = {m["name"] for m in spec["end_to_end"]
               if cell in m.get("workloads", [cell])}
        assert set(line["metrics"]) == e2e
    assert list(line)[-1] == "checks"
