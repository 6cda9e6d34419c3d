"""The epoch loop of the SHAS trainer.

Counterpart of ``train`` of ``wav2vecsegmenter_tpu/train/loop.py`` for the
bce tasks, on one device (reference train.py:215-747): the product's
default task (``conf/task/shas.yaml``: frozen backbone, trained SFC head)
and LNA fine-tuning (``finetune_wav2vec=True``: the model's trainable
split, ``SHAS.set_requires_grad``):

* per epoch a fresh random segmentation of the corpus, its
  ``pos_class_percentage`` -> the loss's ``pos_weight``;
* micro-steps with ``update_freq`` accumulation, the epoch-end flush of a
  partial accumulation, running train metrics every ``print_every_steps``;
* evaluation on the eval split at each epoch's end;
* at the end, the model saved in the reference's ``.pt`` layout that
  ``SHAS.save_full_state`` picks: the full state_dict under LNA, the
  head's alone (``{"state_dict": seg_model.state_dict()}``) otherwise;
  ``checkpoints.convert.load_reference_checkpoint`` reads both.

The run is on the first CUDA device and raises without one;
``runtime.device=cpu`` asks for the CPU (float32).  ``runtime.seed``
seeds the model's numpy weights, the per-epoch window grids and the
dropout and SpecAugment masks; the backbone then comes from a local HF
snapshot of the pretrained model where there is one, the head from
``finetune_from_model`` where that is set.  Not ported yet: checkpoint
rotation and best-checkpoint selection, resume, wandb, ``steps_per_call``,
device meshes and the in-training ST evaluation.
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
from ..cli.common import build_model, runtime_device_dtype
from ..config import to_plain
from ..constants import WAV2VEC_FRAME_LEN
from ..data.loader import FixedDataloaderGenerator, RandomDataloaderGenerator
from ..eval.metrics import evaluate, train_step_metrics
from ..infer.pipeline import WindowInference
from ..models.wav2vec2 import init_from_numpy
from ..ops import backend
from .loss import build_loss
from .step import AccumulatingAdamW, make_train_step

logger = logging.getLogger("wav2vecsegmenter_tpu_torch")


def _init_weights(model, config, seed: int) -> None:
    init_from_numpy(model, seed)
    if not load_pretrained_backbone(model):
        logger.warning("No local weights for %s: the backbone keeps seeded "
                       "random weights", model.wav2vec_model_name)
    if config.get("finetune_from_model"):
        load_reference_checkpoint(
            config.finetune_from_model, model,
            allow_random_wav2vec=bool(config.get("allow_random_wav2vec")))


def train(config, work_dir: str | Path | None = None, on_step=None) -> dict:
    """Run training.  Returns ``{"eval": last eval metrics, "history":
    per-micro-step loss, grad_norm, step_seconds (batch fetch to loss) and
    fetch_seconds (its batch's read and collate), "steps_per_epoch",
    "updates": optimizer updates applied, "model": the trained SHAS,
    "checkpoint": the saved checkpoint's path or None}``.  ``on_step``,
    when given, is called with each micro-step's metrics
    (``train.step.make_train_step``)."""
    task = config.task
    if task.get("autoregression"):
        raise NotImplementedError("the autoregressive task is not ported")
    rt = config.get("runtime") or {}
    backend.set_kernels(rt.get("kernels", "auto"))
    device, dtype = runtime_device_dtype(rt.get("device", "cuda"),
                                         rt.get("compute_dtype", "bfloat16"))
    seed = int(rt.get("seed", 0))
    results_path = Path(work_dir or ".") / config.exp_name
    results_path.mkdir(parents=True, exist_ok=True)

    model = build_model(to_plain(task.model), device)
    _init_weights(model, config, seed)
    params = model.set_requires_grad()
    logger.info("Model parameters: %.1fM (%.1fM trained)",
                sum(p.numel() for p in model.parameters()) / 1e6,
                sum(p.numel() for p in params) / 1e6)

    batch_size = int(config.batch_size)
    train_gen = RandomDataloaderGenerator(
        config.data.train.talk_list, config.data.train.segments_list,
        config.data.train.segment_length, batch_size, seed=seed)
    eg = task.get("eval_generator") or {}
    eval_gen = FixedDataloaderGenerator(
        config.data.eval.talk_list, config.data.eval.segments_list,
        config.data.eval.segment_length, batch_size,
        inference_times=int(eg.get("inference_times", 1)),
        remainder_ladder=bool(rt.get("infer_remainder_ladder", False)))

    # the first epoch's loader sizes the schedule (reference train.py:321-332)
    train_loader = train_gen.generate()
    update_freq = int(config.update_freq)
    max_epochs = int(config.max_epochs)
    total_steps = int(max_epochs * len(train_loader) / update_freq * 1.01)
    optimizer = AccumulatingAdamW(params, float(config.learning_rate),
                                  total_steps, update_freq)
    generator = torch.Generator(device=device).manual_seed(seed)
    engine = WindowInference(model, device, dtype)

    history: dict = {"loss": [], "grad_norm": [], "step_seconds": [],
                     "fetch_seconds": []}
    steps_per_epoch = []
    results: dict = {}
    print_every = int(config.get("print_every_steps", 100))
    for epoch in range(max_epochs):
        logger.info("Starting epoch %d ...", epoch)
        if epoch:
            train_loader = train_gen.generate()
        pos_pct = train_gen.dataset.pos_class_percentage
        loss_fn, _, ma_window = build_loss(to_plain(task.loss), pos_pct)
        logger.info("pos_class_percentage = %s", pos_pct)
        ma_steps = int(ma_window / (WAV2VEC_FRAME_LEN / 1000)) \
            if ma_window else 0
        pos_weight = loss_fn.pos_weight
        engine.loss_fn = loss_fn
        step = make_train_step(model, loss_fn, ma_steps, optimizer, dtype,
                               generator)

        steps_in_epoch = len(train_loader)
        steps_per_epoch.append(steps_in_epoch)
        losses, preds, targets = [], [], []
        t_epoch = t0 = time.perf_counter()
        # a micro-step's span runs from the request for its batch (the
        # windows' reads and the collate) to its loss on the host; the
        # optimizer's update, when one falls due, is inside it
        for n, batch in enumerate(train_loader, start=1):
            t_batch = time.perf_counter()
            metrics = step(batch, pos_weight)
            loss = float(metrics["loss"])  # waits for the device
            history["step_seconds"].append(time.perf_counter() - t0)
            history["fetch_seconds"].append(t_batch - t0)
            history["loss"].append(loss)
            history["grad_norm"].append(float(metrics["grad_norm"]))
            if on_step is not None:
                on_step(metrics)
            losses.append(loss)
            lg = metrics["logits"].cpu().numpy()
            t = min(lg.shape[1], batch.out_mask.shape[1])
            m = batch.out_mask[:, :t]
            preds.extend((1 / (1 + np.exp(-lg[:, :t])) >= 0.5)[m].tolist())
            targets.extend((batch.target[:, :t] >= 0.5)[m].tolist())
            if n % print_every == 0 or n == steps_in_epoch:
                sm = train_step_metrics(targets, preds, losses)
                logger.info(
                    "Step %d/%d loss=%.4f acc=%.4f f1=%.4f p=%.4f r=%.4f "
                    "grad_norm=%.4f (%.2f steps/s)", n, steps_in_epoch,
                    sm["loss"], sm["accuracy"], sm["f1"], sm["precision"],
                    sm["recall"], history["grad_norm"][-1],
                    n / (time.perf_counter() - t_epoch))
                losses, preds, targets = [], [], []
            t0 = time.perf_counter()
        optimizer.flush()  # the reference steps at the epoch's end
        results = evaluate(eval_gen, engine)
        logger.info("eval @ epoch %d: %s", epoch, results)

    checkpoint = None
    if config.get("save_ckpts", True):
        checkpoint = results_path / "ckpts" / "final.pt"
        checkpoint.parent.mkdir(parents=True, exist_ok=True)
        saved = model if model.save_full_state else model.seg_model
        torch.save({"state_dict": {k: v.detach().cpu() for k, v in
                                   saved.state_dict().items()}},
                   str(checkpoint))
        logger.info("Saved the %s to [%s].",
                    "model" if model.save_full_state else "head", checkpoint)
    return {"eval": results, "history": history,
            "steps_per_epoch": steps_per_epoch, "updates": optimizer.updates,
            "model": model, "checkpoint": checkpoint}
