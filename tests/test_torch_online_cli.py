"""The port's online CLI (``cli/online.py``) against the JAX package's on
one reference ``.pt`` and two synthetic talks: the same JSON line per
committed segment and a byte-equal ``custom_segments.yaml`` for wav replay,
``concurrent_streams``, PCM on standard input and a ``-m`` sweep.  The JAX
CLI runs its XLA path in float32, the port's the CPU (float32).  After
tests/test_online_cli.py.
"""

import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from .helpers import make_speechlike_wav
from .torch_tiny import (threads_per_worker, tiny_builders,  # noqa: F401
                         tiny_pair)

TALKS = {"talkA.wav": 21.7, "talkB.wav": 13.4}
STRM = ["algorithm=strm", "algorithm.max_segment_length=3"]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    from wav2vecsegmenter_tpu.config import compose, save_config

    ws = tmp_path_factory.mktemp("torch_online_cli")
    (ws / "wav").mkdir()
    (ws / "txt").mkdir()
    for seed, (name, secs) in enumerate(TALKS.items()):
        make_speechlike_wav(ws / "wav" / name, duration_secs=secs,
                            seed=3 + seed)
    with open(ws / "txt" / "orig.yaml", "w") as f:
        yaml.dump([{"duration": secs, "offset": 0.0, "speaker_id": "NA",
                    "wav": name} for name, secs in TALKS.items()], f)
    tiny_pair(ws / "ckpt.pt")
    save_config(compose(Path(__file__).parents[1] / "conf", "train"),
                ws / "train_config.yaml")
    return ws


def _args(ws, out: Path, extra: list) -> list:
    return [f"ckpt_path={ws}/ckpt.pt",
            f"config_path={ws}/train_config.yaml", f"output_dir={out}",
            f"infer_data.wav_dir={ws}/wav",
            f"infer_data.orig_seg_yaml={ws}/txt/orig.yaml",
            "segment_length=4", "chunk_secs=0.3",
            "runtime.compute_dtype=float32", *extra]


def _both(ws, name: str, extra: list, capsys, stdin: bytes | None = None,
          monkeypatch=None, results: bool = True):
    """(JAX, port) runs of the online CLI: (returned rows, JSON lines,
    output dir) each."""
    from wav2vecsegmenter_tpu.cli.online import main as jax_main
    from wav2vecsegmenter_tpu_torch.cli.online import main as port_main

    out = {}
    for side, main, own in (
            ("jax", jax_main, ["runtime.kernels=xla"]),
            ("port", port_main, ["+runtime.device=cpu"])):
        d = ws / f"{side}_{name}"
        pin = [f"+results_path={d}"] if results else []
        if stdin is not None:
            monkeypatch.setattr(sys, "stdin",
                                type("Stdin", (), {"buffer":
                                                   io.BytesIO(stdin)})())
        capsys.readouterr()
        rows = main(_args(ws, d, extra + own + pin))
        lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("{")]
        out[side] = (rows, lines, d)
    return out["jax"], out["port"]


def _yaml_bytes(d: Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("custom_segments.yaml"))}


@pytest.mark.parametrize("algo", [
    STRM,
    ["algorithm=pthr", "algorithm.max_segment_length=3",
     "algorithm.max_lerp_range=1", "algorithm.min_lerp_range=0.2",
     "algorithm.threshold=0.3"],
])
def test_wav_replay_equals_jax_cli(workspace, tiny_builders, capsys, algo):
    name = algo[0].split("=")[1]
    (jrows, jlines, jdir), (rows, lines, d) = _both(workspace, name, algo,
                                                    capsys)
    assert rows == jrows and len(rows) > 0
    assert lines == jlines and len(lines) == len(rows)
    assert {ln["wav"] for ln in lines} == set(TALKS)
    assert _yaml_bytes(d) == _yaml_bytes(jdir) != {}


def test_concurrent_streams_equal_jax_cli(workspace, tiny_builders, capsys):
    (jrows, jlines, jdir), (rows, lines, d) = _both(
        workspace, "conc", STRM + ["concurrent_streams=2"], capsys)
    assert rows == jrows and len(rows) > 0
    assert lines == jlines
    # the streams' commits interleave in time
    order = [ln["wav"] for ln in lines]
    assert "talkA.wav" in order[order.index("talkB.wav"):]
    assert _yaml_bytes(d) == _yaml_bytes(jdir) != {}


def test_stdin_pcm_equals_jax_cli(workspace, tiny_builders, capsys,
                                  monkeypatch):
    """wav_path=- reads s16le PCM until EOF; a torn final byte is carried
    and dropped."""
    from wav2vecsegmenter_tpu_torch.data.audio import read_wav_window

    wav = workspace / "wav" / "talkB.wav"
    floats = read_wav_window(wav, 0, int(TALKS["talkB.wav"] * 16000))
    pcm = (np.clip(np.rint(floats * 32768.0), -32768, 32767)
           .astype("<i2").tobytes()) + b"\x00"
    (jrows, jlines, jdir), (rows, lines, d) = _both(
        workspace, "stdin", STRM + ["wav_path=-", "+stream_name=live"],
        capsys, stdin=pcm, monkeypatch=monkeypatch)
    assert rows == jrows and len(rows) > 0
    assert lines == jlines and {ln["wav"] for ln in lines} == {"live"}
    assert _yaml_bytes(d) == _yaml_bytes(jdir) != {}


def test_sweep_equals_jax_cli(workspace, tiny_builders, capsys):
    (jrows, jlines, jdir), (rows, lines, d) = _both(
        workspace, "sweep",
        ["-m", "algorithm=strm", "algorithm.max_segment_length=2,3"],
        capsys, results=False)
    assert len(rows) == len(jrows) == 2 and rows == jrows and rows[0]
    assert rows[0] != rows[1]
    assert lines == jlines
    port_yaml, jax_yaml = _yaml_bytes(d), _yaml_bytes(jdir)
    assert len(port_yaml) == 2 and port_yaml == jax_yaml


def test_online_cli_refuses_dac_and_runs_on_cuda_unless_asked(
        workspace, tiny_builders, monkeypatch):
    from wav2vecsegmenter_tpu_torch.cli.online import main as port_main

    out = workspace / "refused"
    with pytest.raises(NotImplementedError, match="dac"):
        port_main(_args(workspace, out, ["algorithm=dac",
                                         "+runtime.device=cpu"]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"\+runtime\.device=cpu"):
        port_main(_args(workspace, out, STRM))
