"""Frame-level evaluation: micro/binary F1, precision and recall.

Counterpart of ``wav2vecsegmenter_tpu/eval/metrics.py``, through the port's
``WindowInference`` (reference lib/evaluate.py:130-214): per talk, average
the probabilities over ``inference_times`` shifted window grids, threshold
(the bce head) or take argmax == ``<B>`` of the logits summed over the
passes (the multi-class heads, targets off ``<PAD>`` zeroed, as the JAX
package counts them), gather predictions and targets over all talks, then
the metrics rounded to 4 decimals.  The scores are counted with numpy (the
card's machine has no scikit-learn); a ratio with a zero denominator is 0,
as scikit-learn's ``zero_division`` default gives.
"""

from __future__ import annotations

import numpy as np

from ..infer.pipeline import (WindowInference, collect_talk, dispatch_talk,
                              talk_logits_array)


def _scores(targets: np.ndarray, preds: np.ndarray) -> dict:
    """accuracy (micro F1 of a binary task), binary F1, precision, recall."""
    targets, preds = targets.astype(bool), preds.astype(bool)
    tp = int(np.sum(targets & preds))
    fp = int(np.sum(~targets & preds))
    fn = int(np.sum(targets & ~preds))

    def ratio(a, b):
        return a / b if b else 0.0

    return {"accuracy": ratio(int(np.sum(targets == preds)), len(targets)),
            "f1": ratio(2 * tp, 2 * tp + fp + fn),
            "precision": ratio(tp, tp + fp),
            "recall": ratio(tp, tp + fn)}


def evaluate(dataloader_generator, engine: WindowInference,
             vocab=None) -> dict:
    """eval_loss (when the engine has a loss_fn), eval_accuracy, eval_f1,
    eval_precision, eval_recall over every talk of the generator's split.
    One talk is dispatched ahead of the one being stitched.  eval_loss is
    the mean over (talk, pass) of each one's mean batch loss, as the JAX
    package takes it, so a talk with more batches weighs no more.  A
    multi-class engine (``engine.loss_tag`` not bce) needs the task's
    ``vocab``.  An autoregressive generator raises ``NotImplementedError``
    (ROADMAP C15)."""
    if getattr(dataloader_generator, "autoregression", False):
        raise NotImplementedError(
            "evaluation of the autoregressive task is not carried out: its "
            "batches (AutoRegBatch) carry no out_mask, on which the JAX "
            "trainer's evaluation fails (ROADMAP C15)")
    multiclass = engine.loss_tag != "bce"
    all_preds, all_targets, all_losses = [], [], []
    dataset = dataloader_generator.dataset
    inference_times = dataset.inference_times

    def dispatch_one(talk_id):
        passes = [dispatch_talk(engine,
                                dataloader_generator.generate(talk_id, it),
                                multiclass)
                  for it in range(inference_times)]
        return passes, dataset.duration_outframes

    talk_ids = iter(dataloader_generator.get_talk_ids())
    handles = []
    nxt = next(talk_ids, None)
    if nxt is not None:
        handles.append(dispatch_one(nxt))
    while handles:
        nxt = next(talk_ids, None)
        if nxt is not None:
            handles.append(dispatch_one(nxt))
        passes, duration = handles.pop(0)
        targets = np.zeros(duration)
        probs = np.zeros(duration)
        logits = 0.0
        for it, pending in enumerate(passes):
            losses: list = []
            talk_logits = None
            if multiclass:
                talk_logits = talk_logits_array(engine.model.vocab_size,
                                                duration)
            probs += collect_talk(pending, duration,
                                  targets if it == 0 else None, losses,
                                  talk_logits)
            if multiclass:
                logits = logits + talk_logits
            if losses:  # one mean per (talk, pass), as the JAX package
                all_losses.append(float(np.mean(losses)))
        probs /= inference_times
        if multiclass:
            all_preds.append(np.argmax(logits, axis=-1)
                             == vocab.boundary_token_id)
            targets = targets * (targets != vocab.pad_token_id)
        else:
            # the reference divides by inference_times a second time
            # (lib/evaluate.py:185), a no-op at the default of one pass
            all_preds.append(probs / inference_times > 0.5)
        all_targets.append(targets)
    dataset.release_cache()

    s = _scores(np.concatenate(all_targets), np.concatenate(all_preds))
    out = {"eval_loss": float(np.mean(all_losses))} if all_losses else {}
    out.update({f"eval_{k}": round(v, 4) for k, v in s.items()})
    return out


def train_step_metrics(all_targets, all_preds, all_losses) -> dict:
    """Running train metrics (reference train.py:508-527); nan frame
    metrics when no prediction was gathered."""
    loss = float(np.mean(all_losses)) if all_losses else float("nan")
    if len(all_preds) == 0:
        nan = float("nan")
        return {"loss": loss, "accuracy": nan, "f1": nan, "precision": nan,
                "recall": nan}
    return {"loss": loss, **_scores(np.asarray(all_targets),
                                    np.asarray(all_preds))}
