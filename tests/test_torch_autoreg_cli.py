"""The autoregressive segmenter (``task=arseg``) through the port's CLIs
against the JAX package's, on one set of weights at the tiny geometry of
``tests/torch_tiny``: ``segment.py`` per talk, ``cli/inference.py`` packed
across talks with ``algorithm=dac_logits`` (``custom_segments.yaml`` byte
for byte), the online CLI's commits, and the serve CLI's daemon.  The JAX
CLIs read the parameters from an Orbax directory of the full tree (the
JAX package reads arseg parameters from Orbax only); the port's read its
own ``.pt``.  Both build the tiny model from the task's ``_target_``: the
JAX registry's alias and the port's ``cli/common.MODELS`` entry point at
it.
"""

import importlib
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from wav2vecsegmenter_tpu_torch.checkpoints.convert import (
    state_dict_from_jax_params)
from wav2vecsegmenter_tpu_torch.infer.online import OnlineSegmenter

from .helpers import make_speechlike_wav
from .torch_tiny import (JAX_SIDE, PORT_SIDE, autoreg_params,  # noqa: F401
                         jax_tiny_autoreg, threads_per_worker,
                         port_tiny_autoreg)

TALKS = {"talkA.wav": 11.3, "talkB.wav": 7.6}
CONF = Path(__file__).resolve().parents[1] / "conf"
# The random decoder has no positional signal (nor has the reference's:
# its PE is left out), so within a window its decode settles on one value
# (p(in-segment) about 0.21 here) after a few frames that start higher:
# pTHR's threshold lies between the two, so that each window's first
# frames make a segment; no segment is long enough to be split, which
# would pick a frame among near-equal values
PTHR = ["algorithm=pthr", "algorithm.threshold=0.3",
        "algorithm.max_segment_length=30", "algorithm.min_lerp_range=0.2",
        "algorithm.max_lerp_range=1"]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The talks, their ``orig.yaml``, the weights as an Orbax directory
    (``jax_ckpt``) and as the port's full-layout ``ckpt.pt``, a training
    config of ``task=arseg`` and a training run's layout for each
    package's inference CLI (``run_{jax,port}/e2e/ckpts/final.pt``)."""
    from wav2vecsegmenter_tpu.checkpoints.io import save_orbax
    from wav2vecsegmenter_tpu.config import compose, save_config

    ws = tmp_path_factory.mktemp("torch_autoreg_cli")
    (ws / "wav").mkdir()
    for i, (name, secs) in enumerate(TALKS.items()):
        make_speechlike_wav(ws / "wav" / name, duration_secs=secs, seed=5 + i)
    with open(ws / "orig.yaml", "w") as f:
        yaml.dump([{"duration": secs, "offset": 0.0, "speaker_id": "NA",
                    "wav": name} for name, secs in TALKS.items()], f)
    params = autoreg_params(jax_tiny_autoreg())
    tm = port_tiny_autoreg()
    sd = state_dict_from_jax_params(params, tm)
    train_cfg = compose(CONF, "train", ["task=arseg"])
    save_config(train_cfg, ws / "train_config.yaml")
    train_cfg["exp_name"] = "e2e"
    for side in ("jax", "port"):
        run = ws / f"run_{side}"
        (run / "e2e" / "ckpts").mkdir(parents=True)
        save_config(train_cfg, run / ".hydra" / "config.yaml")
        final = run / "e2e" / "ckpts" / "final.pt"
        if side == "jax":
            save_orbax(final, params)
        else:
            torch.save({"state_dict": sd}, final)
    (ws / "ckpt.pt").write_bytes(
        (ws / "run_port" / "e2e" / "ckpts" / "final.pt").read_bytes())
    (ws / "jax_ckpt").symlink_to(ws / "run_jax" / "e2e" / "ckpts" / "final.pt")
    return ws


@pytest.fixture
def autoreg_builders(monkeypatch):
    """``lib.models.AutoRegSegmenter`` builds the tiny model in both
    packages."""
    import tests.torch_tiny as torch_tiny
    from wav2vecsegmenter_tpu.config import registry
    from wav2vecsegmenter_tpu_torch.cli import common

    monkeypatch.setitem(registry._ALIASES, "lib.models.AutoRegSegmenter",
                        "tests.torch_tiny:_jax_autoreg_builder")
    monkeypatch.setattr(torch_tiny, "_jax_autoreg_builder",
                        lambda **kw: jax_tiny_autoreg(), raising=False)
    monkeypatch.setitem(common.MODELS, "lib.models.AutoRegSegmenter",
                        lambda device=None, **kw: port_tiny_autoreg(
                            device=device))


def _run_both(ws, cli: str, extra: list) -> dict:
    """{"jax": ..., "port": ...}: (rows, custom_segments.yaml bytes) of one
    CLI of each package, 4 s windows at batch 3, float32."""
    out = {}
    for side, own in (("jax", JAX_SIDE), ("port", PORT_SIDE)):
        pkg = "wav2vecsegmenter_tpu" + ("" if side == "jax" else "_torch")
        main = importlib.import_module(f"{pkg}.cli.{cli}").main
        d = ws / f"{cli}_{side}_{len(list(ws.glob(f'{cli}_{side}_*')))}"
        ckpt = ws / ("jax_ckpt" if side == "jax" else "ckpt.pt")
        args = {"segment": [f"ckpt_path={ckpt}",
                            f"config_path={ws}/train_config.yaml",
                            f"output_dir={d}",
                            "inference_segment_length=4"],
                "inference": [f"outputs={ws}/run_{side}", "ckpt=final.pt",
                              "inference_segment_length=4"],
                "online": [f"ckpt_path={ckpt}",
                           f"config_path={ws}/train_config.yaml",
                           f"output_dir={d}", "segment_length=4",
                           "chunk_secs=0.5"]}[cli]
        rows = main([*args, f"+results_path={d}",
                     f"infer_data.wav_dir={ws}/wav",
                     f"infer_data.orig_seg_yaml={ws}/orig.yaml",
                     "batch_size=3", "runtime.compute_dtype=float32",
                     *extra, *own])
        out[side] = (rows, (d / "custom_segments.yaml").read_bytes())
    return out


def test_segment_cli_equals_jax(workspace, autoreg_builders):
    """``segment.py`` on ``task=arseg`` with pTHR over the decode's
    p(in-segment): the JAX CLI's rows and yaml bytes."""
    got = _run_both(workspace, "segment", PTHR)
    assert got["port"] == got["jax"]
    rows = got["port"][0]
    assert {r["wav"] for r in rows} == set(TALKS) and len(rows) > 2


def test_inference_cli_packed_dac_logits_equals_jax(workspace,
                                                    autoreg_builders):
    """``cli/inference.py`` with the windows packed across talks and
    ``algorithm=dac_logits`` on the decode's [T, 4] logits: the JAX CLI's
    rows and yaml bytes."""
    got = _run_both(workspace, "inference", [
        "runtime.pack_across_talks=true", "algorithm=dac_logits",
        "algorithm.max_segment_length=4"])
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) > 2


def test_online_cli_commits_equal_jax(workspace, autoreg_builders):
    """The online CLI on one stream a talk (pTHR): the JAX CLI's commits
    and yaml bytes."""
    got = _run_both(workspace, "online", PTHR)
    assert got["port"] == got["jax"] and len(got["port"][0]) > 2


def test_serve_cli_daemon_on_arseg(workspace, autoreg_builders):
    """The serve CLI's daemon on ``task=arseg``: one connection's segments
    equal one OnlineSegmenter's over the same audio on the same engine."""
    from wav2vecsegmenter_tpu_torch.cli import common as tcommon
    from wav2vecsegmenter_tpu_torch.cli import serve
    from wav2vecsegmenter_tpu_torch.config import load_config, merge
    from wav2vecsegmenter_tpu_torch.infer.server import segment_stream_client
    from wav2vecsegmenter_tpu_torch.models.autoreg import AutoRegSegmenter

    ws = workspace
    _, [(config, _)] = tcommon.cli_jobs(serve.CONF_DIR, "serve", [
        f"ckpt_path={ws}/ckpt.pt", "segment_length=4", *PTHR,
        "+runtime.device=cpu", "runtime.compute_dtype=float32"])
    config = merge(load_config(ws / "train_config.yaml"), config)
    srv = serve.build_server(config)
    try:
        engine = srv.mux.engine
        assert isinstance(engine.model, AutoRegSegmenter)
        t = threading.Thread(target=srv.serve_forever,
                             kwargs={"poll_s": 0.01}, daemon=True)
        t.start()
        rng = np.random.RandomState(11)
        n = 16000 * 7
        raw = rng.randn(n) * 0.1 * ((np.arange(n) % 20000) < 15000)
        pcm = np.clip(np.rint(raw * 32768.0), -32768, 32767).astype("<i2")
        lines = segment_stream_client(srv.address, pcm.tobytes())
        srv.shutdown()
        t.join(timeout=10)
    finally:
        srv.close()
    assert lines[-1]["type"] == "end" and lines[-1]["n_segments"] > 0
    o = OnlineSegmenter(engine, **srv.mux._stream_kwargs)
    o.feed(pcm.astype(np.float32) / 32768.0)
    o.finish()
    assert [(ln["offset"], ln["duration"]) for ln in lines
            if ln["type"] == "segment"] == [(s.offset, s.duration)
                                            for s in o.segments]
