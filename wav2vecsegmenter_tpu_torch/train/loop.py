"""The epoch loop of the SHAS trainer.

Counterpart of ``train`` of ``wav2vecsegmenter_tpu/train/loop.py`` for the
frame tasks, on one device (reference train.py:215-747): the product's
default task (``conf/task/shas.yaml``: frozen backbone, trained SFC head),
LNA fine-tuning (``finetune_wav2vec=True``: the model's trainable split,
``SHAS.set_requires_grad``) and the multi-class tasks (``task.vocab`` set:
the ``ce`` tag, and ``SHASWithSSL``'s ``ssl`` and ``ctc`` tags,
``task=shas_ssl`` / ``task=shas_ctc``; the loaders pad targets with the
vocabulary's ``<PAD>`` and, for ``ctc``, carry the windows' transcripts)
and the autoregressive task (``task=arseg``: ``AutoRegSegmenter``, its
batches ``AutoRegBatch``es, the decoder's cross-entropy summed over every
position), on either backbone geometry: the large models' stable-LN
encoder and the base models' (``facebook/wav2vec2-base``: post-LN,
group-norm conv stack).  A run has:

* the training loader from ``task.train_generator`` (merged with
  ``data.train``): per epoch a fresh random segmentation of the corpus
  (``RandomDataloaderGenerator``), or the fixed grid of every talk
  (``FixedDataloaderGenerator``, ``task=shas_fix``); its
  ``pos_class_percentage`` -> the bce loss's ``pos_weight``; the batches
  are read ahead on threads (``data.windows.BatchIterator``);
* micro-steps with ``update_freq`` accumulation, the epoch-end flush of a
  partial accumulation, running train metrics every ``print_every_steps``
  (for the multi-class tags: argmax != ``<B>`` over the frames whose
  target, ``out_target`` for arseg, is ``<B>`` or ``<NB>``);
* evaluation on the eval split at each epoch's end, and every
  ``save_every_steps`` micro-steps (on ``task=arseg`` the first raises
  ``NotImplementedError``, where the JAX trainer fails: ROADMAP C15);
* with ``perform_st_evaluation``, after each evaluation the ST
  evaluation (reference train.py:36-212): the dev wav dir of each of
  ``st_eval`` and ``st_eval_online`` segmented with the live model
  (:func:`st_eval_segments`, on the run's device), then translated,
  realigned and scored on the host (``stpipe.eval_st.eval_st``, which
  shells out to ``fairseq-generate``) under
  ``eval_st/<checkpoint name>/<algorithm>``; its keys join the
  evaluation's results;
* after each evaluation a model checkpoint, ``ckpts/epoch-{n}.pt`` or
  ``ckpts/epoch-{n}_step-{s}.pt``, in the reference's ``.pt`` layout that
  ``SHAS.save_full_state`` picks (the full state_dict under LNA, the head's
  alone otherwise; ``checkpoints.convert.load_reference_checkpoint`` reads
  both); the last ``keep_last_ckpts`` are kept, and under
  ``keep_best_ckpt`` the best by ``best_ckpt_metric`` as
  ``ckpts/{name}_best_{metric}.pt``, which rotation never removes;
* after each epoch the run state, ``last_state/state.pt``
  (``checkpoints.io``), from which ``resume=true`` continues the run: the
  trained parameters, the optimizer's moments, counts and accumulation,
  the dropout generator, the epoch-seed stream and the checkpoint
  bookkeeping;
* at the end, the model saved as ``ckpts/final.pt`` in the same layout.

The run is on the first CUDA device and raises without one;
``runtime.device=cpu`` asks for the CPU (float32).  ``runtime.seed``
seeds the model's numpy weights, the per-epoch window grids (unless
``task.train_generator.seed`` is set) and the dropout and SpecAugment
masks; the backbone then comes from a local HF snapshot of the pretrained
model where there is one, the head from ``finetune_from_model`` where that
is set.  The ``ctc`` tag with a frozen backbone raises, as in the JAX
package (nothing would train).

A run on a mesh (``runtime.mesh``: ``data``, ``model``, ``fsdp``;
``parallel.mesh``) is one of a process group's ranks (``core.runtime``;
the train CLI launches them): the effective batch is ``batch_size`` times
the data ranks, and each rank reads only its rows of the same seeded
global batch (``data.windows.LocalBatch``; ``train.step``); the model is
split over the model axis and, under ``fsdp``, ``fully_shard``-ed over
'data'.  Plain data parallelism evaluates the whole eval set on every
rank with its replicated model; a model axis or FSDP evaluates through
the sharded model, each rank reading its rows over 'data'.  Rank 0
writes the checkpoints and the run state, whole and in the
single-device layout (``resume=true`` splits them again), and the files
of the ST evaluation.

``runtime.profile_steps=N`` writes a ``torch.profiler`` trace
(``core.trace``) of the first N micro-steps that this process takes (after
a resume, the first N after it) to ``<exp_name>/profile``, one file a
rank; the trace is written early when the run ends before N and when a
step raises.  Beside the kernels it carries the program's spans as
ranges (``core.trace.span``): the reader's ``data.wait`` and
``data.read``, the step's ``train.step`` around ``train.upload``,
``train.forward``, ``train.backward``, ``train.grad_norm`` and
``train.optimizer`` (``train.optimizer.apply`` on the k-th micro-step),
and on the autograd thread ``models.pos_conv.bwd`` and
``ops.attention.bwd``; ``core.trace.spans()`` holds them in memory with
their host times and, for the spans a metric reads, their device times,
until the trace stops.  ``log_wandb=true`` starts a wandb run on rank 0
(``core.wandblog``) and logs ``{"epoch", **train metrics}`` at each print
at the global step, the epoch's evaluation and ``finish``, the keys and
steps of the JAX trainer.  Not ported: ``steps_per_call`` (one micro-step
a call; ROADMAP).
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np
import torch

from ..checkpoints.convert import (
    load_pretrained_backbone,
    load_reference_checkpoint,
)
from ..checkpoints.io import (
    load_run_state,
    model_state_dict,
    save_model_checkpoint,
    save_run_state,
)
from ..cli.common import build_model, runtime_device_dtype, segment_wavs
from ..cli.inference import wavs_from_dir
from ..config import to_plain
from ..constants import WAV2VEC_FRAME_LEN
from ..core import runtime
from ..core.trace import start_trace, stop_trace
from ..core.wandblog import init_wandb
from ..data.loader import FixedDataloaderGenerator, RandomDataloaderGenerator
from ..eval.metrics import evaluate, train_step_metrics
from ..infer.pipeline import WindowInference
from ..models.wav2vec2 import init_from_numpy
from ..ops import backend
from ..parallel import mesh as pmesh
from .loss import build_loss
from .step import AccumulatingAdamW, make_train_step

logger = logging.getLogger("wav2vecsegmenter_tpu_torch")

# the reference's generator targets (conf/task/*.yaml) -> the port's
GENERATORS = {
    "lib.dataset.RandomDataloaderGenerator": RandomDataloaderGenerator,
    "lib.dataset.FixedDataloaderGenerator": FixedDataloaderGenerator,
}


def _init_weights(model, config, seed: int) -> None:
    init_from_numpy(model, seed)
    if not load_pretrained_backbone(model):
        logger.warning("No local weights for %s: the backbone keeps seeded "
                       "random weights", model.wav2vec_model_name)
    if config.get("finetune_from_model"):
        load_reference_checkpoint(
            config.finetune_from_model, model,
            allow_random_wav2vec=bool(config.get("allow_random_wav2vec")))


def data_ranks(mesh) -> dict:
    """A loader's ``n_data`` and ``data_rank`` on ``mesh`` (or none)."""
    if mesh is None:
        return {"n_data": 1, "data_rank": 0}
    return {"n_data": mesh.n_data, "data_rank": mesh.data_rank}


def train_generator(config, batch_size: int, seed: int,
                    pin_memory: bool = False, vocab=None, ctc: bool = False,
                    autoregression: bool = False, mesh=None):
    """The training loader generator: ``task.train_generator`` merged with
    ``data.train`` and ``batch_size`` added, as the
    JAX loop instantiates it.  An unset seed of the random generator
    becomes ``seed`` (the JAX single-process loop leaves it unseeded; a
    resumed run needs a seeded stream); ``vocab``, ``ctc`` and
    ``autoregression`` as the JAX loop passes them; on ``mesh`` each data
    rank reads its rows of every batch.  Any other target raises."""
    conf = {**to_plain(config.task.get("train_generator") or {}),
            **to_plain(config.data.train)}
    target = conf.pop("_target_", None)
    if target not in GENERATORS:
        raise NotImplementedError(
            f"task.train_generator._target_={target} is not ported (only "
            f"{', '.join(GENERATORS)})")
    if GENERATORS[target] is RandomDataloaderGenerator \
            and conf.get("seed") is None:
        conf["seed"] = seed
    conf["batch_size"] = batch_size
    return GENERATORS[target](**conf, pin_memory=pin_memory, vocab=vocab,
                              ctc=ctc, autoregression=autoregression,
                              **data_ranks(mesh))


def st_eval_segments(config, model, engine, vocab=None) -> dict:
    """The in-training ST evaluation's device part: for each of
    ``st_eval`` and ``st_eval_online`` that the config sets, {key:
    (algorithm tag, yaml rows)} of its ``infer_data.wav_dir`` segmented
    through ``cli.common.segment_wavs`` with the trainer's ``engine`` and
    live ``model``, at the st config's ``batch_size``,
    ``inference_segment_length`` and ``inference_times`` (the JAX
    ``_run_st_eval``'s segmentation).  The model runs in eval mode under
    ``torch.no_grad`` and is put back in the mode it was in; nothing is
    drawn from the trainer's generator.  A key whose wav dir is missing is
    logged as skipped."""
    out: dict = {}
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            for key in ("st_eval", "st_eval_online"):
                st_cfg = config.get(key)
                if not st_cfg:
                    continue
                algorithm = to_plain(st_cfg.algorithm)
                try:
                    wav_dir = Path(st_cfg.infer_data.wav_dir)
                    if not wav_dir.is_dir():
                        raise FileNotFoundError(f"no wav dir {wav_dir}")
                    rows = segment_wavs(
                        model, wavs_from_dir(st_cfg), algorithm,
                        int(st_cfg.batch_size),
                        float(st_cfg.inference_segment_length),
                        int(st_cfg.inference_times), engine.device,
                        engine.compute_dtype, loss_tag=engine.loss_tag,
                        vocab=vocab, engine=engine)
                except FileNotFoundError as e:
                    logger.warning("%s skipped: %s", key, e)
                    continue
                out[key] = (algorithm["tag"], rows)
    finally:
        model.train(was_training)
    return out


def run_st_eval(config, model, engine, vocab, results_path: Path,
                checkpoint_name: str) -> dict:
    """The in-training ST evaluation (reference train.py:36-212): the
    segmentation of :func:`st_eval_segments`, then per key
    ``stpipe.eval_st.eval_st`` (host work: the fairseq dataset,
    ``fairseq-generate``, the mWER realignment, the scores) into
    ``results_path/eval_st/<checkpoint_name>/<algorithm>``.  Returns the
    merged results."""
    from ..stpipe.eval_st import eval_st

    results: dict = {}
    for key, (algorithm, rows) in st_eval_segments(config, model, engine,
                                                   vocab).items():
        if not runtime.is_rank0():
            continue
        out = Path(results_path) / "eval_st" / checkpoint_name / algorithm
        results.update(eval_st(config[key], rows, out, algorithm))
    return results


def _generate(gen):
    """The next epoch's loader: a fixed generator's grid of every talk, or
    a random generator's next segmentation."""
    return gen.generate("", 0) if hasattr(gen, "get_talk_ids") \
        else gen.generate()


class Checkpoints:
    """The checkpoint files and their bookkeeping (the JAX loop's
    ``save_ckpt``): the last ``keep_last_ckpts`` model checkpoints and,
    apart from them, the best by ``best_ckpt_metric``, replaced only by a
    better score.  Names are file names in ``directory``."""

    def __init__(self, directory: Path, config) -> None:
        self.directory = directory
        self.enabled = bool(config.get("save_ckpts", True))
        self.keep_last = int(config.get("keep_last_ckpts", 8))
        self.keep_best = bool(config.get("keep_best_ckpt", True))
        self.metric = config.get("best_ckpt_metric", "eval_f1")
        self.ckpt_list: list[str] = []
        self.best_score = 0.0
        self.best_checkpoint: str | None = None

    def save(self, name: str, model, results: dict | None) -> None:
        """Save ``model`` as ``name``; on a mesh every rank gathers the
        whole state and rank 0 writes the files."""
        if not self.enabled:
            return
        state = model_state_dict(model)
        write = runtime.is_rank0()
        path = self.directory / f"{name}.pt"
        if write:
            save_model_checkpoint(path, model, state)
        self.ckpt_list.append(path.name)
        if len(self.ckpt_list) > self.keep_last:
            gone = self.directory / self.ckpt_list.pop(0)
            if write:
                gone.unlink(missing_ok=True)
        if self.keep_best and results:
            score = results.get(self.metric, 0.0)
            if score > self.best_score:
                if self.best_checkpoint is not None and write:
                    (self.directory / self.best_checkpoint).unlink(
                        missing_ok=True)
                self.best_checkpoint = f"{name}_best_{self.metric}.pt"
                self.best_score = float(score)
                if write:
                    save_model_checkpoint(
                        self.directory / self.best_checkpoint, model, state)

    def state(self) -> dict:
        return {"ckpt_list": list(self.ckpt_list),
                "best_score": self.best_score,
                "best_checkpoint": self.best_checkpoint}

    def restore(self, state: dict) -> None:
        """The bookkeeping of a resumed run, less the files that are gone."""
        self.ckpt_list = [n for n in state["ckpt_list"]
                          if (self.directory / n).exists()]
        self.best_score = float(state["best_score"])
        best = state["best_checkpoint"]
        self.best_checkpoint = best if best and (
            self.directory / best).exists() else None


def train(config, work_dir: str | Path | None = None, on_step=None) -> dict:
    """Run training.  Returns ``{"eval": last eval metrics, "history":
    per-micro-step loss, grad_norm, step_seconds (from the request for the
    batch to its loss), fetch_seconds (the wait for the batch: the
    reader's ``data.wait`` span) and read_seconds (its read and collate in
    the reader: ``data.read``), "steps_per_epoch",
    "updates": optimizer updates applied, "total_steps": the schedule's
    length, "start_epoch": 0, or the epoch a resumed run started at,
    "evals": (checkpoint name, eval metrics and, with
    ``perform_st_evaluation``, the ST results) of each evaluation, "model":
    the trained SHAS, "generator": the dropout generator, "checkpoint": the
    final checkpoint's path or None, "checkpoints": the rotation's
    bookkeeping}``.  ``on_step``, when given,
    is called with each micro-step's metrics
    (``train.step.make_train_step``)."""
    task = config.task
    autoregression = bool(task.get("autoregression"))
    rt = config.get("runtime") or {}
    backend.set_kernels(rt.get("kernels", "auto"))
    device_type = torch.device(rt.get("device", "cuda")).type
    runtime.maybe_init_distributed(device_type)
    device, dtype = runtime_device_dtype(rt.get("device", "cuda"),
                                         rt.get("compute_dtype", "bfloat16"))
    mesh_conf = to_plain(rt.get("mesh"))
    mesh, n_data, _ = pmesh.resolve_mesh(mesh_conf, runtime.world_size(),
                                         device_type)
    fsdp = mesh is not None and bool((mesh_conf or {}).get("fsdp"))
    rank0 = runtime.is_rank0()
    seed = int(rt.get("seed", 0))
    results_path = Path(work_dir or ".") / config.exp_name
    checkpoints_path = results_path / "ckpts"
    checkpoints_path.mkdir(parents=True, exist_ok=True)
    resume_dir = results_path / "last_state"
    wandb_run = init_wandb(config, results_path) if rank0 else None

    is_ctc = (task.get("loss") or {}).get("tag") == "ctc"
    if is_ctc and not task.model.get("finetune_wav2vec", False):
        # the CTC loss depends only on the backbone and lm_head: with a
        # frozen backbone nothing would train
        raise ValueError(
            "CTC task with finetune_wav2vec=false optimizes nothing "
            "(the loss never touches a trainable parameter); set "
            "task.model.finetune_wav2vec=true")
    model, vocab = build_model(to_plain(task), device)
    _init_weights(model, config, seed)
    model.set_requires_grad()
    pmesh.shard_model(model, mesh)
    if fsdp:
        pmesh.apply_fsdp(model, mesh)
    params = model.trainable_parameters()
    names = [n for n, p in model.named_parameters() if model._trains(n)]
    logger.info("Model parameters: %.1fM (%.1fM trained)",
                sum(p.numel() for p in model.parameters()) / 1e6,
                sum(p.numel() for p in params) / 1e6)

    # the effective batch: batch_size a data rank (reference train.py:245)
    batch_size = int(config.batch_size) * n_data
    pin = device.type == "cuda"
    train_gen = train_generator(config, batch_size, seed, pin, vocab, is_ctc,
                                autoregression, mesh)
    # plain data parallelism evaluates the whole set on every rank; a model
    # axis or FSDP through the sharded model, rows over 'data'
    eval_mesh = mesh if mesh is not None and (mesh.n_model > 1 or fsdp) \
        else None
    eg = task.get("eval_generator") or {}
    eval_gen = FixedDataloaderGenerator(
        config.data.eval.talk_list, config.data.eval.segments_list,
        config.data.eval.segment_length, batch_size,
        inference_times=int(eg.get("inference_times", 1)),
        remainder_ladder=bool(rt.get("infer_remainder_ladder", False)),
        pin_memory=pin, vocab=vocab, ctc=is_ctc,
        autoregression=autoregression,
        **data_ranks(eval_mesh))

    # the first epoch's loader sizes the schedule (reference train.py:321-332)
    train_loader = _generate(train_gen)
    first_epoch_steps = len(train_loader)
    update_freq = int(config.update_freq)
    max_epochs = int(config.max_epochs)
    total_steps = int(max_epochs * first_epoch_steps / update_freq * 1.01)
    optimizer = AccumulatingAdamW(params, float(config.learning_rate),
                                  total_steps, update_freq)
    generator = torch.Generator(device=device).manual_seed(seed)
    loss_tag = (task.get("loss") or {}).get("tag", "bce")
    engine = WindowInference(model, device, dtype, loss_tag=loss_tag,
                             mesh=eval_mesh)
    ckpts = Checkpoints(checkpoints_path, config)

    start_epoch = global_step = 0
    state = load_run_state(resume_dir) if config.get("resume") else None
    if state is not None:
        if state["first_epoch_steps"] != first_epoch_steps:
            raise RuntimeError(
                f"cannot resume from {resume_dir}: its first epoch had "
                f"{state['first_epoch_steps']} micro-steps, this run's has "
                f"{first_epoch_steps} (another corpus, batch size or seed)")
        if set(state["params"]) != set(names):
            raise RuntimeError(f"cannot resume from {resume_dir}: another "
                               f"set of trained parameters")
        for name, value in state["params"].items():
            pmesh.load_full(model, name, value)
        optimizer.load_state_dict(_local_optimizer_state(
            model, names, state["optimizer"]))
        generator.set_state(state["generator"])
        ckpts.restore(state)
        start_epoch = int(state["epoch"])
        global_step = int(state["global_step"])
        if start_epoch > 0 and hasattr(train_gen, "skip_epoch_seeds"):
            # the first generate() drew epoch 0's seed: epoch start_epoch
            # draws the seed an uninterrupted run would
            train_gen.skip_epoch_seeds(start_epoch - 1)
        logger.info("Resumed from %s at epoch %d (global_step=%d, %d "
                    "rotating checkpoints, best %s=%.4f)", resume_dir,
                    start_epoch, global_step, len(ckpts.ckpt_list),
                    ckpts.metric, ckpts.best_score)

    history: dict = {"loss": [], "grad_norm": [], "step_seconds": [],
                     "fetch_seconds": [], "read_seconds": []}
    steps_per_epoch = []
    evals: list = []
    results: dict = {}
    print_every = int(config.get("print_every_steps", 100))
    save_every = int(config.get("save_every_steps", 0) or 0)
    # the trace of this process's first profile_steps micro-steps
    profile_steps = int(rt.get("profile_steps", 0) or 0)
    trace_stop_at = global_step + profile_steps
    prof = None

    def evaluate_and_save(name: str, log: bool = False) -> dict:
        out = evaluate(eval_gen, engine, vocab)
        logger.info("eval @ %s: %s", name, out)
        if log and wandb_run is not None:
            wandb_run.log(dict(out))
        if config.get("perform_st_evaluation"):
            out.update(run_st_eval(config, model, engine, vocab,
                                   results_path, name))
        evals.append((name, out))
        ckpts.save(name, model, out)
        return out

    try:
        for epoch in range(start_epoch, max_epochs):
            logger.info("Starting epoch %d ...", epoch)
            if epoch:
                train_loader = _generate(train_gen)
            pos_pct = getattr(train_gen.dataset, "pos_class_percentage", None)
            loss_fn, _, ma_window = build_loss(to_plain(task.loss), pos_pct,
                                               vocab)
            ma_steps = int(ma_window / (WAV2VEC_FRAME_LEN / 1000)) \
                if ma_window else 0
            pos_weight = None
            if loss_tag == "bce":
                if pos_pct is not None:
                    logger.info("pos_class_percentage = %s", pos_pct)
                pos_weight = loss_fn.pos_weight
                engine.loss_fn = loss_fn
            step = make_train_step(model, loss_fn, ma_steps, optimizer, dtype,
                                   generator, loss_tag, vocab,
                                   autoregression, mesh, fsdp)

            steps_in_epoch = len(train_loader)
            steps_per_epoch.append(steps_in_epoch)
            losses, preds, targets, gnorms = [], [], [], []
            t_epoch = t0 = time.perf_counter()
            # a micro-step's span runs from the request for its batch (the
            # wait on the reader) to its loss on the host; the optimizer's
            # update, when one falls due, is inside it
            for n, batch in enumerate(train_loader, start=1):
                if prof is None and global_step < trace_stop_at:
                    prof = start_trace(results_path / "profile")
                global_step += 1
                metrics = step(batch, pos_weight)
                loss = float(metrics["loss"])  # waits for the device
                history["step_seconds"].append(time.perf_counter() - t0)
                history["fetch_seconds"].append(
                    train_loader.wait_seconds[n - 1])
                history["read_seconds"].append(
                    train_loader.read_seconds[n - 1])
                history["loss"].append(loss)
                history["grad_norm"].append(float(metrics["grad_norm"]))
                if prof is not None and global_step >= trace_stop_at:
                    stop_trace(prof)
                    prof = None
                if on_step is not None:
                    on_step(metrics)
                losses.append(loss)
                gnorms.append(history["grad_norm"][-1])
                lg = metrics["logits"].float().cpu().numpy()
                if "rows" in metrics:  # a rank's rows: the whole batch's
                    batch = metrics["rows"].numpy()
                if loss_tag == "bce":
                    t = min(lg.shape[1], batch.out_mask.shape[1])
                    m = batch.out_mask[:, :t]
                    preds.extend(
                        (1 / (1 + np.exp(-lg[:, :t])) >= 0.5)[m].tolist())
                    targets.extend((batch.target[:, :t] >= 0.5)[m].tolist())
                else:
                    # boundary / non-boundary frames (reference
                    # train.py:495-504)
                    tgt = batch.out_target if autoregression \
                        else batch.target
                    spe = (tgt == vocab.boundary_token_id) | (
                        tgt == vocab.nonboundary_token_id)
                    pred = np.argmax(lg, axis=-1) != vocab.boundary_token_id
                    preds.extend(pred[spe].astype(float).tolist())
                    targets.extend(tgt[spe].astype(float).tolist())
                if n % print_every == 0 or n == steps_in_epoch:
                    sm = train_step_metrics(targets, preds, losses)
                    logger.info(
                        "Step %d/%d loss=%.4f acc=%.4f f1=%.4f p=%.4f "
                        "r=%.4f grad_norm=%.4f (%.2f steps/s)", n,
                        steps_in_epoch, sm["loss"], sm["accuracy"], sm["f1"],
                        sm["precision"], sm["recall"],
                        history["grad_norm"][-1],
                        n / (time.perf_counter() - t_epoch))
                    if wandb_run is not None:
                        # the mean gradient norm since the last print (the
                        # JAX trainer's wandb.watch stand-in)
                        wandb_run.log({"epoch": epoch, **sm,
                                       "grad_norm": float(np.mean(gnorms))},
                                      step=global_step)
                    losses, preds, targets, gnorms = [], [], [], []
                if save_every and global_step % save_every == 0:
                    results = evaluate_and_save(
                        f"epoch-{epoch}_step-{global_step}")
                t0 = time.perf_counter()
            optimizer.flush()  # the reference steps at the epoch's end
            if prof is not None and global_step >= trace_stop_at:
                stop_trace(prof)
                prof = None
            results = evaluate_and_save(f"epoch-{epoch}", log=True)
            if ckpts.enabled:
                split = pmesh.split_parameters(model)
                run_state = {
                    "params": {n: pmesh.full_tensor(n, p, split.get(n))
                               .detach().cpu()
                               for n, p in zip(names, params)},
                    "optimizer": _whole_optimizer_state(model, names,
                                                        optimizer),
                    "generator": generator.get_state(),
                    "epoch": epoch + 1, "global_step": global_step,
                    "first_epoch_steps": first_epoch_steps, **ckpts.state()}
                if rank0:
                    save_run_state(resume_dir, run_state)
    finally:
        # a run that ends, or fails, before its trace's last step still
        # writes it, and leaves no trace running in this process
        if prof is not None:
            stop_trace(prof)

    checkpoint = None
    if ckpts.enabled:
        state_dict = model_state_dict(model)
        checkpoint = checkpoints_path / "final.pt"
        if rank0:
            save_model_checkpoint(checkpoint, model, state_dict)
        logger.info("Saved the %s to [%s].",
                    "model" if model.save_full_state else "head", checkpoint)
    if wandb_run is not None:
        wandb_run.finish()
    return {"eval": results, "history": history,
            "steps_per_epoch": steps_per_epoch, "updates": optimizer.updates,
            "total_steps": total_steps, "start_epoch": start_epoch,
            "evals": evals, "model": model, "generator": generator,
            "checkpoint": checkpoint,
            "checkpoints": ckpts.state()}


def _whole_optimizer_state(model, names, optimizer) -> dict:
    """The optimizer's state with every parameter-shaped tensor whole (the
    AdamW moments, the accumulation): the single-device layout, on the
    CPU.  Every rank of a mesh takes part."""
    split = pmesh.split_parameters(model)

    def whole(name, value):
        return pmesh.full_tensor(name, value, split.get(name)).detach().cpu()

    state = optimizer.state_dict()
    adamw = dict(state["adamw"])
    adamw["state"] = {idx: {k: v if k == "step" else whole(names[idx], v)
                            for k, v in st.items()}
                      for idx, st in adamw["state"].items()}
    return {**state, "adamw": adamw,
            "acc": [whole(n, a) for n, a in zip(names, state["acc"])]}


def _local_optimizer_state(model, names, state: dict) -> dict:
    """A whole optimizer state (:func:`_whole_optimizer_state`) cut to this
    rank's parts of the parameters."""
    def local(name, value):
        return pmesh.local_part(model, name, value)

    adamw = dict(state["adamw"])
    adamw["state"] = {idx: {k: v if k == "step" else local(names[int(idx)], v)
                            for k, v in st.items()}
                      for idx, st in adamw["state"].items()}
    return {**state, "adamw": adamw,
            "acc": [local(n, a) for n, a in zip(names, state["acc"])]}
