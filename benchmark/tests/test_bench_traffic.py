"""The traffic repeats exactly for a seed and changes with it; every seed
asks for the same talk lengths; the reference works the training epoch
out alike for a seed."""

from __future__ import annotations

import json

import numpy as np

from benchlib import corpus
from reference import train as rtrain

from conftest import DATA


def tiny_traffic():
    return json.loads((DATA / "tiny-train.json").read_text())


def talks_for(tmp_path, seed):
    return corpus.write_talks(tmp_path, tiny_traffic(), seed, "cpu")


def test_same_seed_same_traffic(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    a = talks_for(tmp_path / "a", 2**31 + 11)
    b = talks_for(tmp_path / "b", 2**31 + 11)
    for x, y in zip(a, b):
        assert x["path"].read_bytes() == y["path"].read_bytes()
        assert x["bursts"] == y["bursts"]


def test_other_seed_other_traffic_same_work(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    a = talks_for(tmp_path / "a", 5)
    b = talks_for(tmp_path / "b", 6)
    assert [t["path"].read_bytes() for t in a] != [t["path"].read_bytes()
                                                  for t in b]
    assert sorted(t["samples"] for t in a) == sorted(t["samples"] for t in b)


def test_talk_lengths_follow_the_distribution():
    lengths = corpus.talk_lengths({"count": 16, "median_s": 540,
                                   "sigma": 0.4, "min_s": 180,
                                   "max_s": 1200})
    assert len(lengths) == 16 and lengths == sorted(lengths, reverse=True)
    assert 180 <= min(lengths) and max(lengths) <= 1200
    assert abs(np.median(lengths) - 540) < 20


def test_epoch_repeats_for_a_seed(tmp_path):
    talks = talks_for(tmp_path, 3)
    a = rtrain.Epoch(talks, 6, 20, 2, 99)
    b = rtrain.Epoch(talks, 6, 20, 2, 99)
    assert a.windows == b.windows and list(a.order) == list(b.order)
    for key, value in a.batch(0).items():
        assert np.array_equal(value, b.batch(0)[key])
