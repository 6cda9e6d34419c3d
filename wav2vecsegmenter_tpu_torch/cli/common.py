"""The product loop and its plumbing: the override surface (sweeps and
run directories), runtime, model building, algorithms.

Counterpart of ``wav2vecsegmenter_tpu/cli/common.py``; ``parse_cli``,
``_split_sweep``, ``expand_sweeps`` and ``hydra_override_dirname`` are the
port's copies of its own (tests/test_torch_copies.py holds them equal).
``segment_wavs`` takes plain arguments (no config object), so it runs
without pyyaml; the config-driven CLIs live in ``cli/segment.py``,
``cli/inference.py``, ``cli/online.py``, ``cli/serve.py`` and
``cli/train.py``, and share :func:`load_model`, :func:`hop_conf` and
:func:`wavs_from_yaml`.
"""

from __future__ import annotations

import itertools
import logging
import sys
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from ..algorithms import (pdac, pdac_with_logits, pthr, strm,
                          update_yaml_content)
from ..data.vocab import BaseVocabulary, UppercasedCharVocabulary
from ..data.windows import BatchIterator, FixedSegmentationDatasetNoTarget
from ..infer.packing import PackedSweep
from ..infer.pipeline import (WindowInference, collect_talk, dispatch_talk,
                              talk_logits_array)
from ..models.autoreg import AutoRegSegmenter
from ..models.shas import SHAS, SHASWithSSL

logger = logging.getLogger("wav2vecsegmenter_tpu_torch")


def parse_overrides(argv: list[str] | None = None) -> list[str]:
    argv = sys.argv[1:] if argv is None else argv
    return [a for a in argv if "=" in a and not a.startswith("--")]


def parse_cli(argv: list[str] | None = None) -> tuple[bool, list[str]]:
    """(multirun, overrides): hydra CLI surface — ``-m``/``--multirun``
    turns comma-separated override values into a sweep (reference README
    "Parameter search", inference_st_pipe.py with Hydra's basic sweeper)."""
    argv = sys.argv[1:] if argv is None else argv
    multirun = any(a in ("-m", "--multirun") for a in argv)
    overrides = parse_overrides(argv)
    if not multirun:
        # hydra parity: a choice sweep ('a=1,2') in single-run mode is an
        # up-front error, not a literal string that crashes deep in the run
        for ov in overrides:
            key, _, raw = ov.partition("=")
            if len(_split_sweep(raw)) > 1:
                raise ValueError(
                    f"Ambiguous value for argument '{ov}': comma-separated "
                    "choice sweeps need -m / --multirun")
    return multirun, overrides


def _split_sweep(value: str) -> list[str]:
    """Split a CLI override value on top-level commas (commas inside
    [...]/{...} belong to yaml lists, not sweeps)."""
    parts, depth, cur = [], 0, []
    for ch in value:
        if ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def expand_sweeps(overrides: list[str]) -> list[list[str]]:
    """Hydra basic-sweeper semantics: every override with top-level commas
    is a choice dimension; jobs are the cartesian product (last dimension
    varies fastest, like hydra's job numbering)."""
    dims = []
    for ov in overrides:
        key, _, raw = ov.partition("=")
        dims.append([f"{key}={v}" for v in _split_sweep(raw)])
    return [list(combo) for combo in itertools.product(*dims)]


def hydra_override_dirname(overrides: list[str],
                           exclude_keys=()) -> str:
    """Hydra's ``${hydra.job.override_dirname}``: the CLI overrides as
    ``key=value`` sorted by key and joined with ','.  ``exclude_keys``
    entries drop both the exact key and (extension for this framework's
    ``runtime`` block) any dotted subkey of an excluded prefix."""
    exclude = set(exclude_keys or ())
    items = []
    for ov in overrides:
        key, _, val = ov.partition("=")
        k = key.lstrip("+~")
        if k in exclude or any(k.startswith(e + ".") for e in exclude):
            continue
        items.append((k, f"{k}={val}"))
    return ",".join(s for _, s in sorted(items))


def compose_app(conf_dir, app: str, overrides: list[str],
                multirun: bool = False):
    """``conf_dir/<app>.yaml`` composed with ``overrides``, and the job's
    hydra-style run directory: the conf's ``hydra.run.dir`` for a single
    run, ``hydra.sweep.dir`` /
    ``subdir`` for a sweep job, both named by the job's
    ``${hydra.job.override_dirname}``.  Returns (config, run_dir or None),
    as the JAX package's ``compose_app``."""
    from ..config import compose, resolve

    cfg = compose(conf_dir, app, overrides, resolve_interp=False)
    exclude = cfg.select(
        "hydra.job.config.override_dirname.exclude_keys") or []
    dirname = hydra_override_dirname(overrides, exclude)
    if cfg.get("hydra"):
        cfg.update_path("hydra.job.override_dirname", dirname)
    cfg = resolve(cfg)
    h = cfg.get("hydra") or {}
    node = h.get("sweep" if multirun else "run") or {}
    if node.get("dir") is None:
        return cfg, None
    run_dir = Path(str(node["dir"]))
    if multirun:
        run_dir = run_dir / str(node.get("subdir", dirname))
    return cfg, run_dir


def cli_jobs(conf_dir, app: str, argv: list[str] | None):
    """(multirun, jobs) of a CLI call, each job (config, run_dir): one, or
    with ``-m`` one per point of the sweep; every job is composed before
    the first one runs."""
    multirun, overrides = parse_cli(argv)
    jobs = expand_sweeps(overrides) if multirun else [overrides]
    return multirun, [compose_app(conf_dir, app, job, multirun)
                      for job in jobs]


def rank_count(configs) -> int:
    """The ranks a CLI call must launch on this host (``core.runtime``):
    1 inside a process group, else what the jobs' ``runtime.mesh`` asks
    for, the same for every job of a sweep."""
    import os

    from ..config import to_plain
    from ..core.runtime import mesh_ranks

    if os.environ.get("W2VSEG_COORDINATOR") or os.environ.get(
            "W2VSEG_DISTRIBUTED", "").lower() == "auto":
        return 1
    counts = set()
    for config in configs:
        rt = config.get("runtime") or {}
        counts.add(mesh_ranks(to_plain(rt.get("mesh")),
                              torch.device(rt.get("device", "cuda")).type))
    if len(counts) > 1:
        raise ValueError(f"the jobs of a sweep ask for meshes of "
                         f"{sorted(counts)} ranks; a call takes one size")
    return counts.pop() if counts else 1


def launch_if_mesh(module: str, argv, configs):
    """``(True, rank 0's result)`` where the call's mesh needs more than
    one rank and this process is not one yet: the call runs again as that
    many ranks (``core.runtime.launch_ranks``); else ``(False, None)``."""
    from ..core.runtime import launch_ranks

    n = rank_count(configs)
    if n <= 1:
        return False, None
    argv = sys.argv[1:] if argv is None else list(argv)
    return True, launch_ranks(f"{module}:main", argv, n)


def runtime_mesh(config):
    """The run's mesh (``parallel.mesh.resolve_mesh`` of ``runtime.mesh``
    over the process group it joins, ``core.runtime``), or None."""
    from ..config import to_plain
    from ..core.runtime import maybe_init_distributed, rank_device, world_size
    from ..parallel.mesh import resolve_mesh

    rt = config.get("runtime") or {}
    device = torch.device(rt.get("device", "cuda"))
    device_type = device.type
    if maybe_init_distributed(device_type):
        rank_device(device)  # before the mesh picks a card
    mesh, _, _ = resolve_mesh(to_plain(rt.get("mesh")), world_size(),
                              device_type)
    return mesh


def init_logging() -> None:
    """INFO lines with their level and time on standard error."""
    logging.basicConfig(level=logging.INFO,
                        format="[%(levelname)s %(asctime)s] %(message)s")


def runtime_device_dtype(device: str = "cuda",
                         compute_dtype: str = "bfloat16"):
    """(device, compute dtype) as the caller asks: ``cuda`` (the default)
    with the configured dtype (bf16 by default), or ``cpu`` in float32.
    Without a CUDA device, ``cuda`` raises: the CPU runs only on request.
    A rank of a process group takes its own CUDA device
    (``core.runtime.rank_device``)."""
    from ..core.runtime import rank_device

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; to run on the CPU, ask for it with the "
            "option +runtime.device=cpu")
    device = rank_device(device)
    if device.type == "cpu" or compute_dtype != "bfloat16":
        return device, torch.float32
    return device, torch.bfloat16


# the reference's model targets (conf/task/*.yaml) -> the port's classes, as
# the JAX package's config/registry aliases them; the reference's shas_ctc
# task names a class it never defined, which the JAX package maps to the
# CTC-capable SSL model
MODELS = {
    "lib.models.SHAS": SHAS,
    "lib.models.SHASWithSSL": SHASWithSSL,
    "lib.models.SHASWithCTC": SHASWithSSL,
    "lib.models.AutoRegSegmenter": AutoRegSegmenter,
}
VOCABS = {
    "lib.datautils.BaseVocabulary": BaseVocabulary,
    "lib.datautils.UppercasedCharVocabulary": UppercasedCharVocabulary,
}


def build_model(task: dict, device=None):
    """(model, vocab) from a task config node (``model``, and ``vocab`` where
    the task sets one) or from a bare ``model`` node, as the JAX
    ``build_model``: the vocabulary is instantiated and its size injected
    as the model's ``vocab_size``; the model class follows ``_target_``
    (:data:`MODELS`, ``lib.models.SHAS`` when there is none).  Any other
    target raises ``NotImplementedError`` naming it."""
    task = dict(task)
    node = dict(task["model"]) if "model" in task else task
    vocab = None
    vocab_conf = task.get("vocab") if "model" in task else None
    if vocab_conf:
        vocab_conf = dict(vocab_conf)
        vtarget = vocab_conf.pop("_target_", None)
        if vtarget not in VOCABS:
            raise NotImplementedError(
                f"task.vocab._target_={vtarget} is not ported (only "
                f"{', '.join(VOCABS)})")
        vocab = VOCABS[vtarget](**vocab_conf)
        node["vocab_size"] = vocab.vocab_size
    target = node.pop("_target_", "lib.models.SHAS")
    if target not in MODELS:
        raise NotImplementedError(
            f"task.model._target_={target} is not ported (only "
            f"{', '.join(MODELS)})")
    return MODELS[target](**node, device=device), vocab


def load_model(config, ckpt_path, mesh=None):
    """The task's model with the checkpoint at ``ckpt_path`` loaded, in eval
    mode on the runtime's device, after the runtime's kernel mode is set:
    (model, vocab, device, compute dtype).  On a ``mesh`` with a model axis
    the model keeps this rank's split (``parallel.mesh.shard_model``)."""
    from ..parallel.mesh import shard_model

    from ..checkpoints.convert import load_reference_checkpoint
    from ..config import to_plain
    from ..ops.backend import set_kernels

    rt = config.get("runtime") or {}
    set_kernels(rt.get("kernels", "auto"))
    device, dtype = runtime_device_dtype(
        rt.get("device", "cuda"), rt.get("compute_dtype", "bfloat16"))
    model, vocab = build_model(to_plain(config.task), device)
    load_reference_checkpoint(
        ckpt_path, model,
        allow_random_wav2vec=bool(config.get("allow_random_wav2vec", False)))
    return shard_model(model, mesh).eval(), vocab, device, dtype


def hop_conf(config) -> dict:
    """The online hop mode's kwargs (``hop_secs``, ``lookahead_secs``) for
    ``infer.online``'s segmenters, from the config; a copy of the JAX
    ``cli.common.hop_conf``."""
    out = {}
    if config.get("hop_secs") is not None:
        out["hop_secs"] = float(config["hop_secs"])
        if config.get("lookahead_secs") is not None:
            out["lookahead_secs"] = float(config["lookahead_secs"])
    return out


def wavs_from_yaml(config) -> list[Path]:
    """The talks of the original segmentation yaml, in order."""
    import yaml

    wav_dir = Path(config.infer_data.wav_dir)
    with open(config.infer_data.orig_seg_yaml) as f:
        seg_yaml = yaml.safe_load(f)
    return [wav_dir / wav
            for wav, _ in itertools.groupby(seg_yaml, key=lambda x: x["wav"])]


def run_algorithm(tag: str, algo_conf: dict, probs: np.ndarray,
                  logits: np.ndarray | None = None, vocab=None):
    """Algorithm dispatch (reference segment.py:107-119); ``dac_logits``
    trims on the argmax of the talk's frame logits over ``vocab``."""
    conf = {k: v for k, v in algo_conf.items() if k != "tag"}
    if tag == "dac":
        return pdac(probs, **conf)
    if tag == "dac_logits":
        return pdac_with_logits(probs, logits, vocab, **conf)
    if tag == "strm":
        return strm(probs, **conf)
    if tag == "pthr":
        return pthr(probs, **conf)
    raise NotImplementedError(f"algorithm '{tag}' is not ported")


def segment_wavs(model, wav_paths: list, algorithm: dict, batch_size: int,
                 segment_length: float, inference_times: int, device,
                 compute_dtype, remainder_ladder: bool = True,
                 talk_probs: dict | None = None,
                 read_seconds: list | None = None,
                 precision: str | None = None, quantize: str | None = None,
                 pack_across_talks: bool = False, loss_tag: str = "bce",
                 vocab=None, engine: WindowInference | None = None,
                 mesh=None, profile_dir=None) -> list[dict]:
    """The product loop: per wav, multi-pass sliding-window inference,
    probability averaging, the segmentation algorithm, yaml rows.

    ``algorithm`` is an algorithm config dict with its ``tag``.  One talk is
    dispatched ahead of the one being drained, so the device keeps working
    while the host stitches and segments; each pass's windows are read
    ahead on threads (``data.windows.BatchIterator``), into pinned memory
    on a CUDA device.  ``talk_probs``, when given, receives each talk's
    averaged frame probabilities by wav name, and ``read_seconds`` each
    batch's read + collate time in the reader.  ``precision`` is an arm of
    the precision ladder (``infer.pipeline.resolve_precision``) and
    ``quantize`` the engine's int8 mode.  ``pack_across_talks`` packs the
    windows of consecutive talks into full batches
    (``infer.packing.PackedSweep``) with two talks dispatched ahead: a
    talk's last batch fills only with the next talk's windows.
    ``loss_tag`` is the task's (the engine's probability) and ``vocab`` its
    vocabulary; ``dac_logits`` downloads and stitches the frame logits,
    summed over the passes, and no other algorithm does.  ``engine``, when
    given (the trainer's, for its ST evaluation), runs the batches in place
    of one built from ``device``, ``compute_dtype``, ``precision``,
    ``quantize`` and ``loss_tag``.

    On a ``mesh`` (``parallel.mesh``) each data rank reads only its windows
    of every batch, each alone, runs its rows (``data.windows.LocalBatch``,
    the engine's) and gets the batch's probabilities back; the batch size
    rounds up to a multiple of the data ranks, and so does each remainder
    batch of the ladder.  Packing (``pack_across_talks``) decodes each talk
    whole and reads whole batches, each rank keeping its rows.  ``profile_dir`` traces the first talk
    with ``torch.profiler`` (``core.trace``), from the first dispatch until
    the talk is drained or the sweep fails.
    """
    from ..core.trace import start_trace, stop_trace
    from ..parallel.mesh import pad_batch_to_devices

    algorithm = dict(algorithm)
    tag = algorithm.pop("tag")
    need_logits = tag == "dac_logits"
    if mesh is None and engine is not None:
        mesh = engine.mesh
    n_data = 1 if mesh is None else mesh.n_data
    data_rank = 0 if mesh is None else mesh.data_rank
    padded = pad_batch_to_devices(batch_size, n_data)
    if padded != batch_size:
        logger.info("batch_size %d -> %d (multiple of %d devices)",
                    batch_size, padded, n_data)
        batch_size = padded
    if engine is None:
        engine = WindowInference(model, device, compute_dtype, precision,
                                 quantize, loss_tag, mesh)
    packer = None
    if pack_across_talks:
        packer = PackedSweep(engine, batch_size, float(segment_length),
                             pin_memory=engine.device.type == "cuda",
                             need_logits=need_logits)
        logger.info("pack_across_talks enabled")

    def dispatch_one(wav_path):
        dataset = FixedSegmentationDatasetNoTarget(
            wav_path, segment_length, inference_times,
            whole_talk=n_data == 1 or packer is not None)
        passes = []
        for it in range(inference_times):
            dataset.fixed_length_segmentation(it)
            if packer is not None:
                passes.append(packer.add_dataset_pass(dataset))
                continue
            batches = BatchIterator(dataset, batch_size, float(segment_length),
                                    remainder_ladder=remainder_ladder,
                                    pin_memory=engine.device.type == "cuda",
                                    n_data=n_data, data_rank=data_rank)
            passes.append(dispatch_talk(engine, batches, need_logits))
            if read_seconds is not None:
                read_seconds.extend(batches.read_seconds)
        return {"wav": wav_path, "dataset": dataset, "passes": passes}

    yaml_content: list[dict] = []
    total_audio_secs = 0.0

    def drain_one(h):
        nonlocal yaml_content, total_audio_secs
        dataset = h["dataset"]
        probs = logits = None
        for pending in h["passes"]:
            lg = None
            if need_logits:
                lg = talk_logits_array(model.vocab_size,
                                       dataset.duration_outframes)
            if packer is not None:
                p = packer.drain_unit(pending, dataset.duration_outframes,
                                      lg)
            else:
                p = collect_talk(pending, dataset.duration_outframes,
                                 talk_logits=lg)
            probs = p if probs is None else probs + p
            if need_logits:
                logits = lg if logits is None else logits + lg
        probs /= inference_times
        name = Path(h["wav"]).name
        if talk_probs is not None:
            talk_probs[name] = probs
        segments = run_algorithm(tag, algorithm, probs, logits, vocab)
        yaml_content = update_yaml_content(yaml_content, segments, name)
        total_audio_secs += dataset.duration_inframes / 16000

    prof = None

    def drain_and_maybe_stop_trace(h):
        nonlocal prof
        drain_one(h)
        if prof is not None:
            stop_trace(prof)
            prof = None
            logger.info("profiler trace of the first talk written to %s",
                        profile_dir)

    t_all = time.perf_counter()
    lookahead = 2 if packer is not None else 1
    in_flight: deque = deque()
    try:
        if profile_dir:
            prof = start_trace(profile_dir)
        for wav_path in wav_paths:
            in_flight.append(dispatch_one(wav_path))
            if len(in_flight) > lookahead:
                drain_and_maybe_stop_trace(in_flight.popleft())
        while in_flight:
            drain_and_maybe_stop_trace(in_flight.popleft())
    finally:
        # a failed sweep must not leave a running trace (the next one in
        # this process could not start) or the packer's decode threads
        # behind; each pass's reader has already run to its end in
        # dispatch_talk.  A failing stop does not mask the sweep's error.
        try:
            if prof is not None:
                stop_trace(prof)
        except Exception:
            logger.exception("profiler stop failed during sweep cleanup")
        finally:
            if packer is not None:
                packer.close()
    wall = time.perf_counter() - t_all
    if wall > 0 and total_audio_secs:
        logger.info("segmented %.1fs of audio in %.1fs (%.0fx RT overall)",
                    total_audio_secs, wall, total_audio_secs / wall)
    return yaml_content
