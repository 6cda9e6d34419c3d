"""The training step: loss, gradients, AdamW with accumulation.

Counterpart of ``wav2vecsegmenter_tpu/train/step.py`` for the frame tasks
(the bce, ce, ssl and ctc tags), the frozen backbone and LNA fine-tuning
(reference train.py:381-480).  ``AccumulatingAdamW``
stands for ``make_optimizer``, its ``flush`` method for
``make_accum_flush``; ``make_train_step`` keeps its name.  They cover:

* AdamW (b1 0.9, b2 0.999, eps 1e-8, weight decay 0.01) over the trainable
  parameters only (``model.trainable_parameters()``, the JAX
  ``trainable_mask``; a frozen parameter gets no gradient at all), the learning rate decayed to 0 on a cosine over the
  optimizer's updates, not its micro-steps (``optax.cosine_decay_schedule``
  evaluated at the count of updates applied before);
* ``update_freq`` accumulation (``optax.MultiSteps``): every k-th
  micro-step applies the mean of the k gradients;
* the epoch-end flush of a partial accumulation of r < k micro-steps, which
  applies sum(grads)/k, as the reference's ``loss / update_freq`` backward
  and optimizer step at ``step == steps_in_epoch`` do (train.py:474-480);
* the batch normalised on the device from its raw int16 samples (mean and
  count-1 variance over the batch's longest window);
* the per-epoch ``pos_weight`` operand of the BCE loss;
* the multi-class losses of JAX ``train/step.py:204-245``: ``ce``, the
  cross-entropy of the frame logits against the targets, summed over all
  B·T frames; ``ssl`` (``SHASWithSSL``), the same with every ``<NB>``
  target replaced by the CTC head's argmax offset by the vocabulary's
  special tokens (pseudo-labels); ``ctc``, the CTC loss of the ``lm_head``
  logits against the batch's transcript tokens (the special-token offset
  removed, ``<PAD>`` -> 0), over each row's exact conv frame count, meaned
  over the included rows;
* the autoregressive task (``task=arseg``, JAX ``train/step.py:184-195``):
  the teacher-forced decoder fed the batch's SEP-led ``in_target`` under
  its ``tgt_mask``, the cross-entropy of its logits against
  ``out_target`` (``<PAD>`` ignored) summed over every position of the
  batch (reference train.py:455-459); the batch comes normalized from the
  host (``AutoRegBatch``);
* the ``loss`` and ``grad_norm`` metrics, grad_norm the global norm of the
  micro-step's raw gradients of the trainable parameters;
* a mesh (``parallel.mesh``; JAX ``make_train_step(mesh=...)``): every rank
  gets the same global batch and takes its rows; its loss is its share of
  the global batch's loss (the bce mean over rows divided by the data
  ranks, the sums as they are, the ctc mean over the global batch's
  included rows), so the gradients summed over 'data' are the global
  batch's; dropout and SpecAugment draw the global batch's masks
  (``ops.shmap.rand_rows``); under FSDP the backward reduce-scatters them
  (``loss.backward``), else one all-reduce sums them; ``loss`` is the
  global batch's, ``grad_norm`` covers the whole parameters (split and
  sharded parts summed) and ``logits`` are the global batch's; a rank
  that read only its rows (``data.windows.LocalBatch``) keeps them as
  they are, and gathers the target fields the loop's metrics read
  (``rows``).

PyTorch runs eagerly, so there is no jit and no donated state: the
optimizer object carries the moments, the accumulation and the counts,
and its ``state_dict`` all of them, for a resumed run.
"""

from __future__ import annotations

import math

import torch

from ..data.collate import AutoRegBatch, Batch
from ..data.windows import LocalAutoRegBatch, LocalBatch
from ..infer.pipeline import (gather_rows, local_batch, normalize_int16,
                              upload)
from ..models.wav2vec2 import frame_lengths
from ..ops.shmap import global_rows
from ..parallel import mesh as pmesh
from .loss import compute_bce_loss


class AccumulatingAdamW:
    """AdamW with cosine decay and ``update_freq`` accumulation over
    ``params``."""

    def __init__(self, params, learning_rate: float, total_steps: int,
                 update_freq: int, weight_decay: float = 0.01) -> None:
        self.params = list(params)
        self.every_k = max(1, int(update_freq))
        self.base_lr = float(learning_rate)
        self.total_steps = max(1, int(total_steps))
        self.adamw = torch.optim.AdamW(self.params, lr=self.base_lr,
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)
        self.updates = 0     # optimizer updates applied (the schedule's count)
        self.mini_step = 0   # micro-steps accumulated since the last update
        self._acc = [torch.zeros_like(p) for p in self.params]

    def state_dict(self) -> dict:
        """The AdamW moments and step counts, the accumulation buffers and
        the counts: what a resumed run needs to continue exactly."""
        return {"adamw": self.adamw.state_dict(), "updates": self.updates,
                "mini_step": self.mini_step,
                "acc": [a.detach().clone() for a in self._acc]}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.updates = int(state["updates"])
        self.mini_step = int(state["mini_step"])
        if len(state["acc"]) != len(self._acc):
            raise ValueError(f"{len(state['acc'])} accumulation buffers for "
                             f"{len(self._acc)} parameters")
        for acc, saved in zip(self._acc, state["acc"]):
            acc.copy_(saved)

    def learning_rate(self) -> float:
        """The cosine schedule at the current update count."""
        count = min(self.updates, self.total_steps)
        return self.base_lr * 0.5 * (1.0 + math.cos(math.pi * count
                                                    / self.total_steps))

    def update(self, grads) -> None:
        """Accumulate one micro-step's gradients; apply their mean at the
        k-th."""
        for acc, g in zip(self._acc, grads):
            acc.add_(g)
        self.mini_step += 1
        if self.mini_step == self.every_k:
            self._apply()

    def flush(self) -> bool:
        """Epoch end: apply a partial accumulation (sum/k); False when
        there is none (always, with ``update_freq == 1``)."""
        if self.mini_step == 0:
            return False
        self._apply()
        return True

    def _apply(self) -> None:
        for group in self.adamw.param_groups:
            group["lr"] = self.learning_rate()
        for p, acc in zip(self.params, self._acc):
            p.grad = acc.div_(self.every_k)
        self.adamw.step()
        for p, acc in zip(self.params, self._acc):
            p.grad = None
            acc.zero_()
        self.updates += 1
        self.mini_step = 0


def batch_to_device(batch: Batch, device) -> dict:
    """The batch's tensors on ``device``, its audio normalised there."""
    def up(a):
        return upload(a, device)

    included = up(batch.included)
    out = {
        "audio": normalize_int16(up(batch.audio), batch.norm_length,
                                 included),
        "in_lengths": up(batch.in_lengths),
        "out_mask": up(batch.out_mask),
        "target": up(batch.target),
        "included": included,
    }
    if batch.tokens is not None:
        out["tokens"] = up(batch.tokens)
    return out


def autoreg_batch_to_device(batch: AutoRegBatch, device) -> dict:
    """The autoregressive batch's tensors on ``device`` (its audio
    normalized by the host)."""
    return {name: upload(getattr(batch, name), device)
            for name in ("audio", "in_lengths", "in_target", "out_target",
                         "tgt_mask")}


def frame_loss(model, loss_fn, loss_tag: str, vocab, b: dict, logits,
               pos_weight: float | None = None,
               ma_window_steps: int = 0):
    """(loss, frame logits) of one micro-step's forward output ``logits``
    (``SHASWithSSL``'s: (ctc logits, frame logits)) under ``loss_tag``."""
    if loss_tag == "bce":
        lf = loss_fn if pos_weight is None else \
            loss_fn.with_pos_weight(pos_weight)
        return compute_bce_loss(logits, b["target"], b["out_mask"], lf,
                                ma_window_steps), logits
    if loss_tag == "ce":
        return loss_fn(logits.reshape(-1, logits.shape[-1]),
                       b["target"].reshape(-1)).sum(), logits
    ctc_logits, frame_logits = logits
    if loss_tag == "ssl":
        target_ctc = ctc_logits.argmax(-1) + vocab.n_special_tokens
        target = b["target"].long()
        target = torch.where(target != vocab.nonboundary_token_id, target,
                             target_ctc)
        return loss_fn(frame_logits.reshape(-1, frame_logits.shape[-1]),
                       target.reshape(-1)).sum(), frame_logits
    if loss_tag == "ctc":
        tokens = b["tokens"]
        pad = tokens == vocab.pad_token_id
        labels = torch.where(pad, 0, tokens - vocab.n_special_tokens)
        # each row's true encoder frame count: the exact conv arithmetic,
        # not the 49.95 Hz estimate behind out_mask
        flen = frame_lengths(b["in_lengths"], model.w2v_cfg)
        t_enc = ctc_logits.shape[1]
        logit_paddings = (torch.arange(t_enc, device=flen.device)[None, :]
                          >= flen[:, None]).float()
        return loss_fn(ctc_logits, labels, logit_paddings, pad.float(),
                       example_mask=b["included"]), frame_logits
    raise NotImplementedError(f"loss tag '{loss_tag}' is not ported")


def loss_share(loss: torch.Tensor, loss_fn, loss_tag: str,
               autoregression: bool, b: dict, mesh) -> torch.Tensor:
    """This data rank's share of the global batch's loss, from the loss of
    its rows: the shares of the ranks sum to the global batch's loss."""
    if mesh is None or mesh.n_data == 1:
        return loss
    if loss_tag == "bce" and not autoregression:
        return loss / mesh.n_data   # a mean over equal row counts
    if loss_tag == "ctc" and getattr(loss_fn, "reduction", "") == "mean":
        local = b["included"].sum().float()
        total = pmesh.all_reduce(local.clone(), mesh.data_group)
        return loss * local / total.clamp_min(1)
    return loss                     # a sum over the rows


def grad_norm_of(names, grads, split: dict, mesh) -> torch.Tensor:
    """The global norm of the gradients of the parameters ``names`` on a
    mesh: each rank's squares summed over the ranks that hold parts of a
    parameter ('model' for a split one, ``split``; 'data' for an FSDP
    shard), a replicated parameter's counted once."""
    sums: dict = {}
    for name, g in zip(names, grads):
        sharded = hasattr(g, "to_local")
        key = (name in split, sharded)
        sq = (g.to_local() if sharded else g).float().square().sum()
        sums[key] = sums[key] + sq if key in sums else sq
    total = None
    for (is_split, sharded), sq in sorted(sums.items()):
        if is_split:
            sq = pmesh.all_reduce(sq, mesh.model_group)
        if sharded:
            sq = pmesh.all_reduce(sq, mesh.data_group)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def make_train_step(model, loss_fn, ma_window_steps: int,
                    optimizer: AccumulatingAdamW,
                    compute_dtype=torch.float32,
                    generator: torch.Generator | None = None,
                    loss_tag: str = "bce", vocab=None,
                    autoregression: bool = False, mesh=None,
                    fsdp: bool = False):
    """Returns ``step(batch, pos_weight) -> metrics``: one micro-step of
    ``model.train_forward`` on the device of the optimizer's parameters
    (dropout and SpecAugment drawn from ``generator``, by default a fresh
    one there), the loss of ``loss_tag`` (:func:`frame_loss`; the masked
    BCE loss with ``pos_weight`` for bce; with ``autoregression`` the
    decoder's cross-entropy summed over every position), the gradients of
    the optimizer's parameters, and the optimizer's update.  A parameter
    the loss does not reach gets a zero gradient, so that AdamW still
    applies its weight decay, as the JAX optimizer does.  On a ``mesh``
    (``fsdp``: the model is ``fully_shard``-ed over 'data') the step is the
    mesh step of the module docstring.  Metrics: ``loss``, ``grad_norm``
    (0-dim tensors), ``logits`` (the frame logits, detached) and the
    micro-step's raw ``grads`` (this rank's parts of them on a mesh), and
    for a rank's rows (``LocalBatch``) on a data mesh ``rows``: the global
    batch's ``out_mask`` and target (``out_target`` for ``AutoRegBatch``),
    gathered by one collective (``infer.pipeline.GatheredRows``)."""
    params = optimizer.params
    device = params[0].device if not hasattr(params[0], "to_local") \
        else params[0].to_local().device
    if generator is None:
        generator = torch.Generator(device=device)
    ids = {id(p): n for n, p in model.named_parameters()}
    names = [ids[id(p)] for p in params]
    split = pmesh.split_parameters(model) if mesh is not None else {}
    n_data = 1 if mesh is None else mesh.n_data

    def step(batch: Batch | AutoRegBatch,
             pos_weight: float | None = None) -> dict:
        rows = None
        if n_data > 1 and isinstance(batch, (LocalBatch, LocalAutoRegBatch)):
            rows = gather_rows(batch, ("out_target",) if autoregression
                               else ("out_mask", "target"), mesh, device)
        batch = local_batch(batch, mesh)
        with global_rows(mesh):
            if autoregression:
                b = autoreg_batch_to_device(batch, device)
                logits = model.train_forward(b["audio"], b["in_lengths"],
                                             b["in_target"], b["tgt_mask"],
                                             generator, compute_dtype)
                loss = loss_fn(logits.reshape(-1, logits.shape[-1]),
                               b["out_target"].reshape(-1)).sum()
            else:
                b = batch_to_device(batch, device)
                out = model.train_forward(b["audio"], b["in_lengths"],
                                          b["out_mask"], generator,
                                          compute_dtype)
                loss, logits = frame_loss(model, loss_fn, loss_tag, vocab,
                                          b, out, pos_weight,
                                          ma_window_steps)
        loss = loss_share(loss, loss_fn, loss_tag, autoregression, b, mesh)
        if fsdp:
            loss.backward()
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in params]
            for p in params:
                p.grad = None
        else:
            grads = [torch.zeros_like(p) if g is None else g for p, g in
                     zip(params, torch.autograd.grad(loss, params,
                                                     allow_unused=True))]
        loss = loss.detach()
        logits = logits.detach()
        if n_data > 1:
            if not fsdp:
                flat = torch.cat([g.reshape(-1) for g in grads])
                pmesh.all_reduce(flat, mesh.data_group)
                grads = [f.view_as(g) for f, g in zip(
                    flat.split([g.numel() for g in grads]), grads)]
            loss = pmesh.all_reduce(loss.clone(), mesh.data_group)
            logits = pmesh.all_gather(logits, mesh.data_group)
        if mesh is None:
            grad_norm = torch.sqrt(sum(g.float().square().sum()
                                       for g in grads))
        else:
            grad_norm = grad_norm_of(names, grads, split, mesh)
        optimizer.update(grads)
        out = {"loss": loss, "grad_norm": grad_norm, "logits": logits,
               "grads": grads}
        if rows is not None:
            out["rows"] = rows
        return out

    return step
