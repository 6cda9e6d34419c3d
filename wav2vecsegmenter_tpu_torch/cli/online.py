"""Online (streaming) segmentation CLI: commit segments while audio arrives.

Counterpart of ``wav2vecsegmenter_tpu/cli/online.py``, with its override
surface (the repo's ``conf/online.yaml``, the training run's config merged
underneath).  Wavs are replayed in ``chunk_secs`` chunks through
:class:`~..infer.online.OnlineSegmenter`, and every segment prints as a
JSON line the moment it commits; the line's ``lag_s`` records how far the
stream had advanced past the segment's end when it finalized.  The full
run also lands in ``custom_segments.yaml``, the offline CLIs' output
contract.

    python -m wav2vecsegmenter_tpu_torch.cli.online ckpt_path=... \\
        config_path=... output_dir=... algorithm=pthr \\
        [wav_path=/path/talk.wav] [chunk_secs=0.5] [runtime.precision=f32res]

``wav_path=-`` serves raw s16le mono 16 kHz PCM from standard input until
EOF (``+stream_name=<name>`` labels its rows); ``concurrent_streams=N``
replays up to N wavs at once through one
:class:`~..infer.online.MultiStreamSegmenter`, batching their windows;
``hop_secs`` / ``lookahead_secs`` select the hop mode; ``-m`` runs a sweep.
Only the causal algorithms serve online: ``strm`` and ``pthr`` (+moving
average); pDAC needs the whole talk.  The run is on the first CUDA device
and raises without one; ``+runtime.device=cpu`` asks for the CPU.
``runtime.kernels``, ``runtime.compute_dtype``, ``runtime.precision`` and
``runtime.quantize`` act as in the segment CLI; ``runtime.profile_steps``
is accepted and does nothing, as in the JAX CLI (ROADMAP C22).  pyyaml is
imported inside :func:`main` only.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

from ..algorithms import update_yaml_content
from ..constants import INPUT_SAMPLE_RATE
from ..data.audio import read_wav_window, wav_info
from ..infer.online import MultiStreamSegmenter, OnlineSegmenter
from ..infer.pipeline import WindowInference
from . import common
from .segment import CONF_DIR


def main(argv: list[str] | None = None):
    """A single run returns the yaml rows; ``-m`` returns one list per
    sweep job."""
    from ..config import load_config, merge

    multirun, jobs = common.cli_jobs(CONF_DIR, "online", argv)
    outputs = []
    for config, run_dir in jobs:
        if config.get("config_path"):
            config = merge(load_config(config.config_path), config)
        output_dir = Path(config.get("results_path") or run_dir
                          or config.output_dir)
        outputs.append(_run_job(config, output_dir))
    return outputs if multirun else outputs[0]


def build_engine(config) -> tuple[WindowInference, dict]:
    """The engine of the config's checkpoint and runtime, and the
    segmenters' kwargs (segment length, algorithm, hop mode); shared with
    ``cli/serve.py``."""
    from ..config import to_plain

    algo_conf = to_plain(config.algorithm)
    tag = algo_conf.pop("tag")
    if tag not in ("strm", "pthr"):
        raise NotImplementedError(
            f"online serving needs a causal algorithm (strm/pthr), got "
            f"'{tag}' — pDAC needs the whole talk; use the offline CLIs")
    model, _, device, dtype = common.load_model(config, config.ckpt_path)
    rt = config.get("runtime") or {}
    engine = WindowInference(model, device, dtype, rt.get("precision"),
                             rt.get("quantize"), config.task.loss.tag)
    return engine, {"segment_length": float(config.segment_length),
                    "algorithm": tag, **common.hop_conf(config), **algo_conf}


def _run_job(config, output_dir: Path) -> list[dict]:
    import yaml

    output_dir.mkdir(parents=True, exist_ok=True)
    common.init_logging()
    common.logger.info("Output directory : [%s]", output_dir)
    engine, seg_kwargs = build_engine(config)
    emit_jsonl = bool(config.get("emit_jsonl", True))
    chunk_samples = max(1, int(float(config.chunk_secs) * INPUT_SAMPLE_RATE))

    yaml_content: list[dict] = []
    if config.get("wav_path") == "-":
        # a live source, e.g. arecord -f S16_LE -r 16000 -c 1 | ... wav_path=-
        name = str(config.get("stream_name", "stdin"))
        segments = _stream_stdin(engine, seg_kwargs, chunk_samples,
                                 emit_jsonl, name)
        yaml_content = update_yaml_content([], segments, name)
    else:
        wav_paths = ([Path(config.wav_path)] if config.get("wav_path")
                     else common.wavs_from_yaml(config))
        n_concurrent = int(config.get("concurrent_streams", 0) or 0)
        if n_concurrent > 1 and len(wav_paths) > 1:
            by_wav = _stream_concurrent(
                engine, seg_kwargs, wav_paths, chunk_samples, emit_jsonl,
                n_concurrent, int(config.get("max_batch", 8)))
            segments_of = lambda w: by_wav[Path(w).name]  # noqa: E731
        else:
            segments_of = lambda w: _stream_wav(  # noqa: E731
                engine, seg_kwargs, w, chunk_samples, emit_jsonl)
        for wav_path in wav_paths:
            yaml_content = update_yaml_content(
                yaml_content, segments_of(wav_path), Path(wav_path).name)

    common.logger.info("Number of segments: %d", len(yaml_content))
    out = output_dir / config.cust_seg_yaml
    with open(out, "w") as f:
        yaml.dump(yaml_content, f, default_flow_style=True)
    common.logger.info("Saved to [%s].", out)
    return yaml_content


def _emitter(emit_jsonl: bool):
    """Printer of a stream's committed segments, one JSON line each."""
    def emit(name: str, segs, stream_samples: int) -> None:
        if not emit_jsonl:
            return
        pos_s = stream_samples / INPUT_SAMPLE_RATE
        for s in segs:
            print(json.dumps({
                "wav": name,
                "offset": s.offset,
                "duration": s.duration,
                "stream_pos_s": round(pos_s, 3),
                "lag_s": round(pos_s - (s.offset + s.duration), 3),
            }), flush=True)
    return emit


def _check_rate(wav_path) -> int:
    """The wav's sample count; raises unless it is 16 kHz."""
    total, sr, _ = wav_info(wav_path)
    if sr != INPUT_SAMPLE_RATE:
        raise ValueError(
            f"{wav_path}: sample rate {sr} != {INPUT_SAMPLE_RATE} "
            "(resample offline; the reference pipeline is 16 kHz-only)")
    return total


def _log_rate(what: str, secs: float, dt: float, n_segments: int) -> None:
    common.logger.info("%s: %.1fs audio in %.2fs (%.0fx RT), %d segments",
                       what, secs, dt, secs / dt if dt > 0 else 0.0,
                       n_segments)


def _stream_stdin(engine, seg_kwargs: dict, chunk_samples: int,
                  emit_jsonl: bool, name: str):
    """Serve a live source: raw s16le mono 16 kHz PCM read from standard
    input until EOF.  The stream clock is the byte count, so lag_s is the
    serving latency behind the source."""
    online = OnlineSegmenter(engine, **seg_kwargs)
    emit = _emitter(emit_jsonl)
    stdin = sys.stdin.buffer
    carry = b""
    pos = 0
    eof = False
    t0 = time.perf_counter()
    while not eof:
        buf = stdin.read(chunk_samples * 2)
        eof = not buf
        data = carry + buf
        n2 = len(data) // 2 * 2  # a torn sample at a read boundary carries
        data, carry = data[:n2], data[n2:]
        if data:
            chunk = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
            pos += len(chunk)
            emit(name, online.feed(chunk), pos)
    emit(name, online.finish(), pos)
    _log_rate(name, pos / INPUT_SAMPLE_RATE, time.perf_counter() - t0,
              len(online.segments))
    return online.segments


def _stream_wav(engine, seg_kwargs: dict, wav_path: Path,
                chunk_samples: int, emit_jsonl: bool):
    """Replay one wav through an OnlineSegmenter; returns its segments."""
    total = _check_rate(wav_path)
    online = OnlineSegmenter(engine, **seg_kwargs)
    emit = _emitter(emit_jsonl)
    name = Path(wav_path).name
    t0 = time.perf_counter()
    pos = 0
    while pos < total:
        chunk = read_wav_window(wav_path, pos, chunk_samples)
        if not len(chunk):
            break
        pos += len(chunk)
        emit(name, online.feed(chunk), pos)
    emit(name, online.finish(), pos)
    _log_rate(name, pos / INPUT_SAMPLE_RATE, time.perf_counter() - t0,
              len(online.segments))
    return online.segments


def _stream_concurrent(engine, seg_kwargs: dict, wav_paths,
                       chunk_samples: int, emit_jsonl: bool,
                       n_concurrent: int, max_batch: int) -> dict:
    """Serve wavs as concurrent streams through one batched engine.

    Up to ``n_concurrent`` wavs replay at once; each tick feeds one chunk
    per active stream and every filled window across streams runs in
    batched forwards (``MultiStreamSegmenter``).  When a stream's wav
    ends, the next wav takes its place, so the pool stays full.  Returns
    {wav name: [Segment]}."""
    mux = MultiStreamSegmenter(engine, max_batch=max_batch, **seg_kwargs)
    emit = _emitter(emit_jsonl)
    queue = list(wav_paths)
    active: dict = {}  # sid -> [wav_path, pos, total]

    def admit():
        while len(active) < n_concurrent and queue:
            wav_path = queue.pop(0)
            sid = Path(wav_path).name
            mux.add_stream(sid)
            active[sid] = [wav_path, 0, _check_rate(wav_path)]

    by_wav: dict = {}
    total_secs = 0.0
    t0 = time.perf_counter()
    admit()
    while active:
        chunks = {}
        for sid, st in active.items():
            chunk = read_wav_window(st[0], st[1], chunk_samples)
            if len(chunk):
                st[1] += len(chunk)
                chunks[sid] = chunk
        committed = mux.feed(chunks) if chunks else {}
        for sid, segs in committed.items():
            emit(sid, segs, active[sid][1])
        done = [sid for sid, st in active.items()
                if st[1] >= st[2] or sid not in chunks]
        for sid in done:
            emit(sid, mux.finish(sid), active[sid][1])
            by_wav[sid] = mux.segments(sid)
            total_secs += active[sid][1] / INPUT_SAMPLE_RATE
            del active[sid]
        admit()
    _log_rate(f"{len(wav_paths)} wavs as {n_concurrent}-way concurrent "
              "streams", total_secs, time.perf_counter() - t0,
              sum(len(s) for s in by_wav.values()))
    return by_wav


if __name__ == "__main__":
    main()
