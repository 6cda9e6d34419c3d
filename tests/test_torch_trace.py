"""``torch.profiler`` traces of the port (A11, ``core.trace``): the
trainer's ``runtime.profile_steps`` (the first N micro-steps this process
takes; written when the run ends before N and when a step raises; a second
profiled run in the same process works, as
tests/test_train_loop.py::test_profile_steps_beyond_run_flushes_trace
holds the JAX loop's), and ``segment_wavs``' ``profile_dir`` (the first
talk; written when the sweep fails too).  On the CPU a trace holds the
host's operators; on a card, its kernels as well (chip_smoke.py)."""

import json
from pathlib import Path

import pytest
import torch

from wav2vecsegmenter_tpu_torch.cli import common as tcommon
from wav2vecsegmenter_tpu_torch.config import compose
from wav2vecsegmenter_tpu_torch.train import loop as tloop

from .test_torch_mesh_cli import _train_overrides, corpus  # noqa: F401
from .torch_tiny import port_tiny, threads_per_worker  # noqa: F401
from .helpers import make_speechlike_wav

CONF = Path(__file__).resolve().parents[1] / "conf"
PTHR = {"tag": "pthr", "threshold": 0.5, "max_segment_length": 8,
        "min_segment_length": 0.5}


def _traces(d: Path) -> list:
    return sorted(d.glob("rank0.*.pt.trace.json"))


def _ops(path: Path) -> set:
    return {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}


def _train(root, work, *extra, on_step=None):
    config = compose(CONF, "train", _train_overrides(
        root, 2, "max_epochs=1", "update_freq=1", "save_ckpts=false",
        *extra))
    return tloop.train(config, work_dir=work, on_step=on_step)


def test_profile_steps_traces_the_first_steps(corpus, tmp_path):
    out = _train(corpus, tmp_path, "runtime.profile_steps=2")
    assert len(out["history"]["loss"]) > 2
    (trace,) = _traces(tmp_path / "run" / "profile")
    ops = _ops(trace)
    assert any(str(op).startswith("aten::") for op in ops)


def test_profile_steps_beyond_the_run_flush_and_run_again(corpus, tmp_path):
    """More steps asked for than the run takes: the trace is written when
    train() ends, and a second profiled run in this process traces too."""
    _train(corpus, tmp_path / "a", "runtime.profile_steps=10000")
    assert len(_traces(tmp_path / "a" / "run" / "profile")) == 1
    _train(corpus, tmp_path / "b", "runtime.profile_steps=1")
    assert len(_traces(tmp_path / "b" / "run" / "profile")) == 1


def test_profile_steps_trace_is_written_when_a_step_raises(corpus, tmp_path):
    class Crash(Exception):
        pass

    def crash(metrics):
        raise Crash

    with pytest.raises(Crash):
        _train(corpus, tmp_path, "runtime.profile_steps=5", on_step=crash)
    assert len(_traces(tmp_path / "run" / "profile")) == 1
    # no trace left running: the next one starts
    _train(corpus, tmp_path / "again", "runtime.profile_steps=1")


def _talks(tmp_path) -> list:
    wavs = []
    for i, secs in enumerate((7.1, 5.3)):
        wavs.append(tmp_path / f"t{i}.wav")
        make_speechlike_wav(wavs[-1], duration_secs=secs, seed=i)
    return wavs


def test_profile_dir_traces_the_first_talk(tmp_path):
    model = port_tiny().eval()
    wavs = _talks(tmp_path)
    rows = tcommon.segment_wavs(model, wavs, PTHR, 2, 4.0, 1,
                                torch.device("cpu"), torch.float32,
                                profile_dir=tmp_path / "prof")
    assert {r["wav"] for r in rows} == {"t0.wav", "t1.wav"}
    (trace,) = _traces(tmp_path / "prof")
    assert any(str(op).startswith("aten::") for op in _ops(trace))


def test_profile_dir_trace_is_written_when_the_sweep_fails(tmp_path):
    model = port_tiny().eval()
    wavs = _talks(tmp_path)[:1] + [tmp_path / "missing.wav"]
    with pytest.raises(Exception):
        tcommon.segment_wavs(model, wavs, PTHR, 2, 4.0, 1,
                             torch.device("cpu"), torch.float32,
                             profile_dir=tmp_path / "prof")
    assert len(_traces(tmp_path / "prof")) == 1
    tcommon.segment_wavs(model, wavs[:1], PTHR, 2, 4.0, 1,
                         torch.device("cpu"), torch.float32,
                         profile_dir=tmp_path / "prof2")
    assert len(_traces(tmp_path / "prof2")) == 1
