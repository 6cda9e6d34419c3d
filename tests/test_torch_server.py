"""The port's segmentation daemon (``infer/server.py``, ``cli/serve.py``):
the counterparts of tests/test_server.py's cases, through real sockets and
the event loop.  Each connection's commits equal one port
``OnlineSegmenter`` over the same audio (tests/test_torch_online.py holds
that one to the JAX package's), and one script of connections (two at
once, one with an algorithm override, a bad header, an unknown header
key, a stream live at shutdown) gets the same JSON lines and stats lines
from the port's server as from the JAX package's on the same weights.
"""

import json
import logging
import os
import re
import socket
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from wav2vecsegmenter_tpu_torch.cli import common as tcommon
from wav2vecsegmenter_tpu_torch.infer.online import OnlineSegmenter
from wav2vecsegmenter_tpu_torch.infer.pipeline import WindowInference
from wav2vecsegmenter_tpu_torch.infer.server import (SegmentationServer,
                                                     segment_stream_client)

from .torch_tiny import threads_per_worker, port_tiny, tiny_pair  # noqa: F401

ALGO = dict(segment_length=4.0, algorithm="strm", max_segment_length=3,
            min_segment_length=0.2, min_pause_length=0.2, threshold=0.5)


def _pcm(wav: np.ndarray) -> bytes:
    return (np.clip(np.rint(wav * 32768.0), -32768, 32767)
            .astype("<i2").tobytes())


def _wav(seed: int, secs: float) -> np.ndarray:
    rng = np.random.RandomState(seed)
    n = int(secs * 16000)
    raw = (rng.randn(n).astype(np.float32) * 0.1
           * ((np.arange(n) % 20000) < 15000))
    # the floats the server decodes from the wire
    return np.frombuffer(_pcm(raw), "<i2").astype(np.float32) / 32768.0


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """(directory, the port's engine, (JAX model, its params)) on one set
    of weights."""
    ws = tmp_path_factory.mktemp("torch_server")
    jm, params, model = tiny_pair(ws / "ckpt.pt")
    return ws, WindowInference(model, "cpu", torch.float32), (jm, params)


@pytest.fixture(scope="module")
def engine(workspace):
    return workspace[1]


def _truth(engine, wav, **algo):
    o = OnlineSegmenter(engine, **(algo or ALGO))
    o.feed(wav)
    o.finish()
    return [(s.offset, s.duration) for s in o.segments]


def _serving(srv):
    t = threading.Thread(target=srv.serve_forever, kwargs={"poll_s": 0.01},
                         daemon=True)
    t.start()
    return t


@pytest.fixture()
def server(engine):
    srv = SegmentationServer(engine, port=0, max_batch=4, **ALGO)
    t = _serving(srv)
    yield srv
    srv.shutdown()
    t.join(timeout=10)


def _read_all(sock) -> list[dict]:
    buf = b""
    while True:
        data = sock.recv(65536)
        if not data:
            break
        buf += data
    sock.close()
    return [json.loads(ln) for ln in buf.splitlines() if ln.strip()]


def _segments(lines) -> list:
    return [(ln["offset"], ln["duration"]) for ln in lines
            if ln["type"] == "segment"]


def _clients(address, jobs: dict) -> dict:
    """Run one client thread per {name: (wav, header)}; their lines."""
    results: dict = {}

    def client(name, wav, header):
        results[name] = segment_stream_client(
            address, _pcm(wav), name=name, header=header,
            chunk_bytes=2 * 16000, pace_s=0.01)

    threads = [threading.Thread(target=client, args=(k, *v))
               for k, v in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    return results


def test_concurrent_connections_match_single_stream(engine, server):
    wavs = {"a": _wav(41, 17.3), "b": _wav(42, 11.1)}
    results = _clients(server.address, {k: (w, None)
                                         for k, w in wavs.items()})
    for name, w in wavs.items():
        lines = results[name]
        end = lines[-1]
        assert end["type"] == "end" and end["name"] == name
        assert end["audio_secs"] == pytest.approx(len(w) / 16000, abs=1e-3)
        segs = [ln for ln in lines[:-1] if ln["type"] == "segment"]
        assert end["n_segments"] == len(segs) > 0
        assert _segments(lines) == _truth(engine, w)
        for ln in segs:
            assert ln["name"] == name
            # lag bounded by window buffering + the algorithm's lookahead
            assert -0.1 <= ln["lag_s"] <= 4.0 + 3.0 + 1.0
        # segments committed during the stream, not all at EOF
        assert segs[0]["stream_pos_s"] < len(w) / 16000


def test_bad_header_gets_error_line(server):
    sock = socket.create_connection(tuple(server.address))
    sock.sendall(b"this is not json\n" + b"\x00\x00" * 100)
    sock.shutdown(socket.SHUT_WR)
    lines = _read_all(sock)
    assert lines and lines[0]["type"] == "error"


def test_unknown_header_key_gets_error_line(server):
    lines = segment_stream_client(server.address, b"\x00\x00" * 100,
                                  header={"segment_length": 8})
    assert lines and lines[0]["type"] == "error"
    assert "segment_length" in lines[0]["error"]


def test_unix_socket(engine, tmp_path):
    path = str(tmp_path / "seg.sock")
    srv = SegmentationServer(engine, unix_path=path, max_batch=4, **ALGO)
    t = _serving(srv)
    try:
        wav = _wav(47, 9.2)
        lines = segment_stream_client(path, _pcm(wav), name="u")
        assert lines[-1]["type"] == "end"
        assert _segments(lines) == _truth(engine, wav) != []
    finally:
        srv.shutdown()
        t.join(timeout=10)
    assert not os.path.exists(path)


def test_unix_socket_stale_and_in_use(engine, tmp_path):
    path = str(tmp_path / "seg.sock")
    stale = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    stale.bind(path)
    stale.close()  # a crashed server's file, never unlinked
    assert os.path.exists(path)
    srv = SegmentationServer(engine, unix_path=path, max_batch=4, **ALGO)
    try:
        with pytest.raises(OSError, match="listening"):
            SegmentationServer(engine, unix_path=path, max_batch=4, **ALGO)
    finally:
        srv.close()
    assert not os.path.exists(path)


def test_max_conns_cap(engine):
    srv = SegmentationServer(engine, port=0, max_batch=4, max_conns=1,
                             **ALGO)
    t = _serving(srv)
    try:
        first = socket.create_connection(tuple(srv.address))
        first.sendall(b"\n")  # an empty header holds the one slot
        time.sleep(0.3)
        second = socket.create_connection(tuple(srv.address))
        msg = _read_all(second)[0]
        assert msg["type"] == "error" and "capacity" in msg["error"]
        wav = _wav(50, 8.1)  # the occupant still serves end to end
        first.sendall(_pcm(wav))
        first.shutdown(socket.SHUT_WR)
        lines = _read_all(first)
        assert lines[-1]["type"] == "end"
        assert lines[-1]["audio_secs"] == pytest.approx(len(wav) / 16000,
                                                        abs=1e-3)
    finally:
        srv.shutdown()
        t.join(timeout=10)


def test_stats_line(engine, caplog):
    srv = SegmentationServer(engine, port=0, max_batch=4,
                             stats_every_s=0.05, **ALGO)
    t = _serving(srv)
    try:
        with caplog.at_level(logging.INFO,
                             logger="wav2vecsegmenter_tpu_torch"):
            wav = _wav(49, 8.3)
            lines = segment_stream_client(srv.address, _pcm(wav), name="s")
            assert lines[-1]["type"] == "end"
            # the loop logs every stats_every_s, busy or idle: a stream
            # served within one interval sees the line after it
            deadline = time.monotonic() + 5.0
            while not any("serve stats" in r.getMessage()
                          for r in caplog.records):
                assert time.monotonic() < deadline, "no stats line"
                time.sleep(0.01)
        assert srv.total_conns >= 1 and srv.total_samples >= len(wav)
    finally:
        srv.shutdown()
        t.join(timeout=10)


def test_shutdown_drains_active_streams(engine):
    srv = SegmentationServer(engine, port=0, max_batch=4, **ALGO)
    t = _serving(srv)
    wav = _wav(48, 9.7)  # no FIN: the stream is live at shutdown
    sock = socket.create_connection(tuple(srv.address))
    sock.sendall(b'{"name": "live"}\n' + _pcm(wav))
    time.sleep(1.0)  # the loop ingests it and runs the filled windows
    srv.shutdown()
    t.join(timeout=30)
    assert not t.is_alive()
    lines = _read_all(sock)
    assert lines[-1]["type"] == "end"
    assert lines[-1]["audio_secs"] == pytest.approx(len(wav) / 16000,
                                                    abs=1e-3)
    assert _segments(lines) == _truth(engine, wav) != []


def test_per_connection_algorithm_override(engine, server):
    wav = _wav(41, 17.3)
    pthr = dict(algorithm="pthr", max_segment_length=2.5, threshold=0.5,
                moving_average_window=0.1)
    want_pthr = _truth(engine, wav, segment_length=4.0,
                       min_segment_length=0.2, min_pause_length=0.2, **pthr)
    want_strm = _truth(engine, wav)
    assert want_pthr != want_strm  # the override matters
    results = _clients(server.address, {"s": (wav, None), "p": (wav, pthr)})
    assert _segments(results["s"]) == want_strm
    assert _segments(results["p"]) == want_pthr


def test_serve_cli_build_server(workspace, monkeypatch):
    """build_server composes the daemon from conf/serve.yaml and a
    training config; ``-m`` is refused."""
    from wav2vecsegmenter_tpu.config import compose, save_config
    from wav2vecsegmenter_tpu_torch.cli import serve
    from wav2vecsegmenter_tpu_torch.config import load_config, merge

    ws, engine, _ = workspace
    save_config(compose(Path(__file__).parents[1] / "conf", "train"),
                ws / "train_config.yaml")
    monkeypatch.setattr(tcommon, "build_model",
                        lambda conf, device=None: (port_tiny().to(device),
                                                   None))
    _, [(config, _)] = tcommon.cli_jobs(serve.CONF_DIR, "serve", [
        f"ckpt_path={ws}/ckpt.pt", "segment_length=4", "algorithm=strm",
        "algorithm.max_segment_length=3", "+runtime.device=cpu"])
    config = merge(load_config(ws / "train_config.yaml"), config)
    srv = serve.build_server(config)
    try:
        assert srv.address[1] > 0  # an ephemeral port, bound
        assert srv.mux.engine.compute_dtype == torch.float32
        t = _serving(srv)
        wav = _wav(53, 8.6)
        lines = segment_stream_client(srv.address, _pcm(wav))
        assert lines[-1]["type"] == "end" and lines[-1]["n_segments"] > 0
        assert _segments(lines) == _truth(engine, wav,
                                          **srv.mux._stream_kwargs)
        srv.shutdown()
        t.join(timeout=10)
    finally:
        srv.close()
    with pytest.raises(ValueError, match="-m"):
        serve.main(["-m", f"ckpt_path={ws}/ckpt.pt", "port=0,1"])


PTHR = dict(algorithm="pthr", max_segment_length=2.5, threshold=0.5,
            moving_average_window=0.1)


def _script(srv, t) -> dict:
    """One script of connections against a serving ``srv`` (its loop in
    thread ``t``): every connection's JSON lines, the last after a
    shutdown that drains a live stream."""
    wav = _wav(41, 17.3)
    out = {f"pair {k}": v for k, v in _clients(
        srv.address, {"s": (wav, None), "p": (wav, PTHR)}).items()}
    sock = socket.create_connection(tuple(srv.address))
    sock.sendall(b"this is not json\n" + b"\x00\x00" * 100)
    sock.shutdown(socket.SHUT_WR)
    out["bad header"] = _read_all(sock)
    out["unknown key"] = segment_stream_client(
        srv.address, b"\x00\x00" * 100, header={"segment_length": 8})
    live = _pcm(_wav(48, 9.7))  # no FIN: the stream is live at shutdown
    before = srv.total_samples
    sock = socket.create_connection(tuple(srv.address))
    sock.sendall(b'{"name": "live"}\n' + live)
    deadline = time.monotonic() + 30
    while srv.total_samples < before + len(live) // 2:
        assert time.monotonic() < deadline, "the live stream stalled"
        time.sleep(0.01)
    srv.shutdown()
    t.join(timeout=30)
    assert not t.is_alive()
    out["drained"] = _read_all(sock)
    return out


def _timeless(lines: list) -> list:
    """The lines without the two fields that hang on when the loop read
    the bytes (``stream_pos_s``, ``lag_s``), which must still be there."""
    for ln in lines:
        if ln["type"] == "segment":
            assert {"stream_pos_s", "lag_s"} <= set(ln)
    return [{k: v for k, v in ln.items() if k not in ("stream_pos_s",
                                                        "lag_s")}
            for ln in lines]


def test_wire_lines_equal_the_jax_server(workspace, caplog):
    """The JAX package's server on its engine (the XLA path, float32) and
    the port's on the port's, each through the same script: equal JSON
    lines, and stats lines of one form."""
    from wav2vecsegmenter_tpu.infer import pipeline as jpipe
    from wav2vecsegmenter_tpu.infer import server as jserver
    from wav2vecsegmenter_tpu.ops.backend import set_backend

    _, engine, (jm, params) = workspace
    runs = {}
    set_backend("xla")
    try:
        for name, cls, eng in (
                ("jax", jserver.SegmentationServer,
                 jpipe.WindowInference(jm, params)),
                ("port", SegmentationServer, engine)):
            srv = cls(eng, port=0, max_batch=4, stats_every_s=0.05, **ALGO)
            with caplog.at_level(logging.INFO):
                caplog.clear()
                runs[name] = _script(srv, _serving(srv))
                runs[name]["stats"] = sorted({
                    re.sub(r"\d+(\.\d+)?", "#", r.getMessage())
                    for r in caplog.records
                    if r.getMessage().startswith("serve stats")})
    finally:
        set_backend("auto")
    jax_run, port_run = runs["jax"], runs["port"]
    assert port_run.keys() == jax_run.keys()
    assert port_run.pop("stats") == jax_run.pop("stats") != []
    for key in jax_run:
        assert _timeless(port_run[key]) == _timeless(jax_run[key]), key
    assert _segments(port_run["pair s"]) != _segments(port_run["pair p"])
    assert port_run["drained"][-1]["type"] == "end"
    assert port_run["bad header"][0]["type"] == "error"
    assert "segment_length" in port_run["unknown key"][0]["error"]
