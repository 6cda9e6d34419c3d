"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.

Tests that need a CUDA card carry the ``card`` marker and skip here: the
``card`` fixture decides, when a test runs, not at import.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for path in (str(BENCH), str(BENCH.parent)):
    if path not in sys.path:
        sys.path.insert(0, path)

DATA = Path(__file__).resolve().parent / "data"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (run on the chip; skips here)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny_bench(tmp_path):
    """A benchmark directory holding the real drivers, metrics and
    counters, and a tiny cell of the training driver: (spec, directory)."""
    for sub in ("drivers", "metrics", "flops"):
        shutil.copytree(BENCH / sub, tmp_path / sub)
    for sub in ("configs", "traffic", "limits"):
        (tmp_path / sub).mkdir()
    shutil.copy(DATA / "tiny-lna.json", tmp_path / "configs" / "tiny-lna.json")
    shutil.copy(DATA / "tiny-train.json", tmp_path / "traffic" / "tiny-train.json")
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cells = {"tiny.lna": ("tiny-lna", "tiny-train", "xlsr24-lna.train-b4")}
    spec["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1,
                          "why": "a tiny CPU cell"}
                         for n, (c, t, _) in cells.items()]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [n for n, (_, _, real) in cells.items()
                              if real in m["workloads"]]
    for n, (_, _, real) in cells.items():
        shutil.copy(BENCH / "limits" / f"{real}.json",
                    tmp_path / "limits" / f"{n}.json")
    return spec, tmp_path
