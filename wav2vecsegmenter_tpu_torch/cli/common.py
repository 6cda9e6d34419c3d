"""The product loop and its plumbing: runtime, model building, algorithms.

Counterpart of ``wav2vecsegmenter_tpu/cli/common.py``.  ``segment_wavs``
takes plain arguments (no config object), so it runs without pyyaml; the
config-driven CLI lives in ``cli/segment.py``.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from ..algorithms import pdac, pthr, strm, update_yaml_content
from ..data.windows import BatchIterator, FixedSegmentationDatasetNoTarget
from ..infer.pipeline import WindowInference, collect_talk, dispatch_talk
from ..models.shas import SHAS

logger = logging.getLogger("wav2vecsegmenter_tpu_torch")


# Options of the JAX CLIs that the port does not carry out yet, by app, with
# the ROADMAP item that ports each.  ``refuse_unported`` raises for any of
# them set away from its default in conf/<app>.yaml.
UNPORTED = {
    "segment": {
        "runtime.precision": "A6 (the precision ladder)",
        "runtime.quantize": "A9 (int8)",
        "runtime.pack_across_talks": "A9 (packing)",
        "runtime.profile_steps": "A11 (profiler traces)",
        "runtime.mesh": "A9 (parallel)",
    },
    "train": {
        "keep_last_ckpts": "A3 (checkpoints and resume)",
        "keep_best_ckpt": "A3 (checkpoints and resume)",
        "best_ckpt_metric": "A3 (checkpoints and resume)",
        "save_every_steps": "A3 (checkpoints and resume)",
        "perform_st_evaluation": "A8 (the ST-eval harness)",
        "log_wandb": "A9 (wandb)",
        "runtime.profile_steps": "A11 (profiler traces)",
        "runtime.mesh": "A9 (parallel)",
    },
}


def refuse_unported(config, app: str, conf_dir) -> None:
    """Raise NotImplementedError for an option of ``UNPORTED[app]`` that
    ``config`` sets away from its default in ``conf_dir/<app>.yaml``, so
    that no option is accepted and then silently not carried out."""
    from ..config import compose, to_plain

    defaults = compose(conf_dir, app, [], resolve_interp=False)
    for key, item in UNPORTED[app].items():
        value = to_plain(config.select(key))
        default = to_plain(defaults.select(key))
        if value != default:
            raise NotImplementedError(
                f"{key}={value} is not ported (only its default {default} "
                f"runs); ROADMAP {item} ports it")


def runtime_device_dtype(device: str = "cuda",
                         compute_dtype: str = "bfloat16"):
    """(device, compute dtype) as the caller asks: ``cuda`` (the default)
    with the configured dtype (bf16 by default), or ``cpu`` in float32.
    Without a CUDA device, ``cuda`` raises: the CPU runs only on request."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; to run on the CPU, ask for it "
            "(segment CLI: +runtime.device=cpu)")
    if device.type == "cpu" or compute_dtype != "bfloat16":
        return device, torch.float32
    return device, torch.bfloat16


def build_model(model_conf: dict, device=None) -> SHAS:
    """SHAS from a task config's ``model`` node (``_target_`` dropped)."""
    kwargs = {k: v for k, v in dict(model_conf).items() if k != "_target_"}
    return SHAS(**kwargs, device=device)


def run_algorithm(tag: str, algo_conf: dict, probs: np.ndarray):
    """Algorithm dispatch (reference segment.py:107-119) for the bce head."""
    conf = {k: v for k, v in algo_conf.items() if k != "tag"}
    if tag == "dac":
        return pdac(probs, **conf)
    if tag == "strm":
        return strm(probs, **conf)
    if tag == "pthr":
        return pthr(probs, **conf)
    raise NotImplementedError(f"algorithm '{tag}' is not ported")


def segment_wavs(model, wav_paths: list, algorithm: dict, batch_size: int,
                 segment_length: float, inference_times: int, device,
                 compute_dtype, remainder_ladder: bool = True,
                 talk_probs: dict | None = None) -> list[dict]:
    """The product loop: per wav, multi-pass sliding-window inference,
    probability averaging, the segmentation algorithm, yaml rows.

    ``algorithm`` is an algorithm config dict with its ``tag``.  One talk is
    dispatched ahead of the one being drained, so the device keeps working
    while the host stitches and segments.  ``talk_probs``, when given,
    receives each talk's averaged frame probabilities by wav name.
    """
    algorithm = dict(algorithm)
    tag = algorithm.pop("tag")
    engine = WindowInference(model, device, compute_dtype)

    def dispatch_one(wav_path):
        dataset = FixedSegmentationDatasetNoTarget(
            wav_path, segment_length, inference_times)
        passes = []
        for it in range(inference_times):
            dataset.fixed_length_segmentation(it)
            batches = BatchIterator(dataset, batch_size, float(segment_length),
                                    remainder_ladder=remainder_ladder)
            passes.append(dispatch_talk(engine, batches))
        return {"wav": wav_path, "dataset": dataset, "passes": passes,
                "t0": time.perf_counter()}

    yaml_content: list[dict] = []
    total_audio_secs = 0.0

    def drain_one(h):
        nonlocal yaml_content, total_audio_secs
        dataset = h["dataset"]
        probs = None
        for pending in h["passes"]:
            p = collect_talk(pending, dataset.duration_outframes)
            probs = p if probs is None else probs + p
        probs /= inference_times
        name = Path(h["wav"]).name
        if talk_probs is not None:
            talk_probs[name] = probs
        segments = run_algorithm(tag, algorithm, probs)
        yaml_content = update_yaml_content(yaml_content, segments, name)
        secs = dataset.duration_inframes / 16000
        total_audio_secs += secs
        dt = time.perf_counter() - h["t0"]
        logger.info("%s: %.1fs audio in %.2fs (%.0fx RT, pipelined)",
                    name, secs, dt, secs / dt)

    t_all = time.perf_counter()
    in_flight: deque = deque()
    for wav_path in wav_paths:
        in_flight.append(dispatch_one(wav_path))
        if len(in_flight) > 1:
            drain_one(in_flight.popleft())
    while in_flight:
        drain_one(in_flight.popleft())
    wall = time.perf_counter() - t_all
    if wall > 0 and total_audio_secs:
        logger.info("segmented %.1fs of audio in %.1fs (%.0fx RT overall)",
                    total_audio_secs, wall, total_audio_secs / wall)
    return yaml_content
