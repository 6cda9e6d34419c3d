"""Frame and transcript losses.

Counterpart of ``wav2vecsegmenter_tpu/train/loss.py``: the reference
instantiates ``torch.nn.BCEWithLogitsLoss``, ``lib.loss.FocalLoss``,
``torch.nn.CrossEntropyLoss`` or ``torch.nn.CTCLoss`` from the task config
(train.py:352-374); each is a callable here.  BCE and focal serve the
``bce`` tag, cross-entropy the ``ce`` and ``ssl`` tags (its
``ignore_index`` the vocabulary's ``<PAD>``, as the JAX ``build_loss``
sets it), CTC the ``ctc`` tag.
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


class CrossEntropyLoss:
    """torch.nn.CrossEntropyLoss over the last dim of logits [N, V] against
    integer targets [N]; an ``ignore_index`` target contributes 0."""

    def __init__(self, ignore_index: int = -100, reduction: str = "none",
                 **_ignored):
        self.ignore_index = ignore_index
        self.reduction = reduction

    def __call__(self, logits, targets):
        loss = torch.nn.functional.cross_entropy(
            logits.float(), targets.long(), ignore_index=self.ignore_index,
            reduction="none")
        return _reduce(loss, self.reduction)


class CTCLoss:
    """torch.nn.CTCLoss over logits [B, T, C] (log-softmaxed here) and
    labels [B, U], with the JAX ``CTCLoss``'s padding interface: per row,
    ``logit_paddings`` [B, T] and ``label_paddings`` [B, U] (1 = padding).
    ``reduction='mean'`` divides each row's negative log likelihood by its
    label count clamped to 1 and means over the rows where
    ``example_mask`` holds (every row without one).  A masked row runs as
    an empty transcript over all T frames, so that an unusable row cannot
    put an infinity into the gradients.

    The log-softmax and the CTC recursions run in float64; the loss comes
    back in float32.  In float32, ATen's CTC gradient drifts with the
    frame count: over a 505-frame row, a fine-tuning step's gradient norm
    came out 8.3e-5 (relative) from the exact one, where the JAX
    package's float32 ``optax.ctc_loss`` is 2.1e-5 off.  The logits are
    [B, T, vocabulary], so the float64 sums cost little."""

    def __init__(self, blank: int = 0, reduction: str = "mean", **_ignored):
        self.blank = blank
        self.reduction = reduction

    def __call__(self, logits, labels, logit_paddings, label_paddings,
                 example_mask=None):
        t = logits.shape[1]
        in_lengths = (1 - logit_paddings).sum(-1).long()
        label_lengths = (1 - label_paddings).sum(-1).long()
        if example_mask is not None:
            in_lengths = torch.where(example_mask, in_lengths, t)
            label_lengths = torch.where(example_mask, label_lengths, 0)
        logp = torch.log_softmax(logits.double(), dim=-1).transpose(0, 1)
        loss = torch.nn.functional.ctc_loss(
            logp, labels.long(), in_lengths, label_lengths, blank=self.blank,
            reduction="none").float()
        if self.reduction == "mean":
            loss = loss / label_lengths.clamp_min(1)
        if example_mask is None:
            return _reduce(loss, self.reduction)
        loss = torch.where(example_mask, loss, 0.0)
        if self.reduction == "mean":
            return loss.sum() / example_mask.sum().clamp_min(1)
        if self.reduction == "sum":
            return loss.sum()
        return loss


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
           "lib.loss.FocalLoss": FocalLoss,
           "torch.nn.CrossEntropyLoss": CrossEntropyLoss,
           "torch.nn.CTCLoss": CTCLoss}


def build_loss(loss_conf: dict, pos_class_percentage: float | None = None,
               vocab=None):
    """(loss_fn, tag, ma_window) from a task's loss config, with the
    reference's pos_weight auto-derivation (train.py:356-368): an unset
    pos_weight of the bce tag becomes 1 - the positive-class share; the ce
    and ssl tags ignore the vocabulary's <PAD> target."""
    conf = dict(loss_conf)
    target = conf.pop("_target_", "torch.nn.BCEWithLogitsLoss")
    tag = conf.pop("tag", "bce")
    ma_window = conf.pop("ma_window", None) or 0.0
    if target not in _LOSSES or tag not in ("bce", "ce", "ssl", "ctc"):
        raise NotImplementedError(
            f"loss {target} with tag '{tag}' is not ported")
    if tag == "bce":
        if conf.get("pos_weight") is None and pos_class_percentage is not None:
            conf["pos_weight"] = 1.0 - pos_class_percentage
    elif tag in ("ce", "ssl"):
        conf["ignore_index"] = vocab.pad_token_id if vocab else -100
    return _LOSSES[target](**conf), tag, float(ma_window)
