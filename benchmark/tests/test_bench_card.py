"""On the card, at each cell's own size (a short window): a sound run is
correct, and the cell's control (``readings.py --control``: the reference
in fp8 in the program's place) is not.  Run on the chip:
``python3 -m pytest benchmark/tests -m card -q``."""

from __future__ import annotations

import json

import pytest

import run
from conftest import BENCH

CELLS = [w["name"] for w in
         json.loads((BENCH.parent / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_sound_and_control_on_the_card(card, cell):
    args = ["--workload", cell, "--seed", "4000000001", "--seconds", "2"]
    assert run.main(args)["correct"]
    assert not run.main(args, control=True)["correct"]
