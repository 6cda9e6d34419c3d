"""Frame losses of the bce task.

Counterpart of ``wav2vecsegmenter_tpu/train/loss.py`` for the ``bce`` tag:
the reference instantiates ``torch.nn.BCEWithLogitsLoss`` or
``lib.loss.FocalLoss`` from the task config (train.py:352-374); each is a
callable ``(logits, targets) -> per-point loss`` here.  The ce, ssl and ctc
tags come with their heads.
"""

from __future__ import annotations

import torch


class BCEWithLogitsLoss:
    """torch.nn.BCEWithLogitsLoss(reduction='none') with pos_weight, in the
    JAX package's stable form: with log σ(x) = -(max(-x, 0) +
    log1p(exp(-|x|))), loss = -(pw·z·log σ(x) + (1 - z)·(log σ(x) - x))."""

    def __init__(self, pos_weight=None, reduction: str = "none", **_ignored):
        self.pos_weight = pos_weight
        self.reduction = reduction

    def with_pos_weight(self, pos_weight):
        """Copy with pos_weight replaced (the reference re-derives it from
        each epoch's regenerated dataset)."""
        return BCEWithLogitsLoss(pos_weight, self.reduction)

    def __call__(self, logits, targets):
        x, z = logits, targets
        pw = 1.0 if self.pos_weight is None else self.pos_weight
        log_sig = -(torch.clamp_min(-x, 0) + torch.log1p(torch.exp(-x.abs())))
        loss = -(pw * z * log_sig + (1 - z) * (log_sig - x))
        return _reduce(loss, self.reduction)


class FocalLoss:
    """Binary focal loss (reference lib/loss.py:6-37)."""

    def __init__(self, pos_weight=0.5, gamma=2.0, reduction="none",
                 **_ignored):
        self.pos_weight = 0.5 if pos_weight is None else pos_weight
        self.gamma = gamma
        self.reduction = reduction

    def with_pos_weight(self, pos_weight):
        return FocalLoss(pos_weight, self.gamma, self.reduction)

    def __call__(self, logits, targets):
        bce = BCEWithLogitsLoss(None, "none")(logits, targets)
        p_t = torch.exp(-bce)
        alpha = (1 - self.pos_weight) + targets * (2 * self.pos_weight - 1)
        return _reduce(alpha * (1 - p_t) ** self.gamma * bce, self.reduction)


def _reduce(loss, reduction: str):
    if reduction == "none":
        return loss
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    raise ValueError(reduction)


def moving_average(x: torch.Tensor, window: int) -> torch.Tensor:
    """Trailing moving average along the last axis (``moving_average_jax``;
    reference lib/segment.py:508-522)."""
    n = x.shape[-1]
    csum = torch.cumsum(x, dim=-1)
    csum = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=-1)
    idx = torch.arange(1, n + 1, device=x.device)
    lo = torch.clamp_min(idx - window, 0)
    return (csum[..., idx] - csum[..., lo]) / (idx - lo)


def compute_bce_loss(logits, target, out_mask, loss_fn,
                     ma_window_steps: int) -> torch.Tensor:
    """Masked per-frame loss, optionally down-weighted near boundaries by a
    moving average of the target, summed per row, meaned over the batch
    (reference train.py:408-454)."""
    t = min(logits.shape[1], target.shape[1])
    logits, target, out_mask = logits[:, :t], target[:, :t], out_mask[:, :t]
    loss_per_point = torch.where(out_mask, loss_fn(logits, target), 0.0)
    if ma_window_steps:
        target_ma = moving_average(target, ma_window_steps)
        loss_per_point = loss_per_point * (1.0 - (target - target_ma).abs())
    return loss_per_point.sum(dim=1).mean()


_LOSSES = {"torch.nn.BCEWithLogitsLoss": BCEWithLogitsLoss,
           "lib.loss.FocalLoss": FocalLoss}


def build_loss(loss_conf: dict, pos_class_percentage: float | None = None):
    """(loss_fn, tag, ma_window) from a task's loss config, with the
    reference's pos_weight auto-derivation (train.py:356-368): an unset
    pos_weight becomes 1 - the positive-class share."""
    conf = dict(loss_conf)
    target = conf.pop("_target_", "torch.nn.BCEWithLogitsLoss")
    tag = conf.pop("tag", "bce")
    ma_window = conf.pop("ma_window", None) or 0.0
    if tag != "bce" or target not in _LOSSES:
        raise NotImplementedError(
            f"loss {target} with tag '{tag}' is not ported (bce tag only)")
    if conf.get("pos_weight") is None and pos_class_percentage is not None:
        conf["pos_weight"] = 1.0 - pos_class_percentage
    return _LOSSES[target](**conf), tag, float(ma_window)
