"""Batched sliding-window inference: wav windows -> stitched talk probs.

Counterpart of ``wav2vecsegmenter_tpu/infer/pipeline.py`` for the bce
(sigmoid) head.  A batch uploads its raw int16 samples, is normalized on the
device (reference lib/datautils.py:120-125: mean and ddof=1 std over the
batch's longest window, rows with zero std and excluded rows zeroed), runs
the model, and downloads only the [B, T] probabilities: a ``non_blocking``
copy into pinned host memory followed by a CUDA event, so the host goes on
dispatching while the copy is in flight.

The stitch helpers (``stitch_row``, ``nan_fill``) mirror the JAX module's
for probabilities only (the logits of the ``dac_logits`` head are not
ported).  Their semantics replicate reference lib/evaluate.py:9-127.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.collate import Batch


def normalize_int16(audio: torch.Tensor, norm_length: int,
                    included: torch.Tensor) -> torch.Tensor:
    """int16 [B, L] -> float32 normalized over [0, norm_length), ddof=1."""
    x = audio.float() / 32768.0
    in_norm = torch.arange(x.shape[1], device=x.device) < norm_length
    count = float(norm_length)
    mean = torch.where(in_norm, x, 0.0).sum(1, keepdim=True) / count
    dev = torch.where(in_norm, x - mean, 0.0)
    std = torch.sqrt((dev * dev).sum(1, keepdim=True) / (count - 1))
    xn = torch.where(std > 0, dev / std.clamp_min(1e-12), 0.0)
    return torch.where(included[:, None], xn, 0.0)


class ProbsHandle:
    """A batch's probabilities on their way to the host."""

    def __init__(self, probs: torch.Tensor):
        self._event = None
        if probs.is_cuda:
            self._host = torch.empty(probs.shape, dtype=probs.dtype,
                                     pin_memory=True)
            self._host.copy_(probs, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = probs

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class WindowInference:
    """Runs window batches through a SHAS model on one device."""

    def __init__(self, model, device, compute_dtype=torch.float32):
        self.model = model
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype

    @torch.inference_mode()
    def run_batch(self, batch: Batch) -> ProbsHandle:
        def up(a):
            return torch.from_numpy(np.asarray(a)).to(self.device,
                                                      non_blocking=True)

        out_mask = up(batch.out_mask)
        audio = normalize_int16(up(batch.audio), batch.norm_length,
                                up(batch.included))
        logits = self.model(audio, up(batch.in_lengths), out_mask,
                            self.compute_dtype)
        probs = torch.where(out_mask, torch.sigmoid(logits.float()), 0.0)
        return ProbsHandle(probs)


def nan_fill(arr: np.ndarray, duration: int) -> None:
    """Fill frames that never got a prediction with the mean of their
    neighbourhood (reference lib/evaluate.py:118-125); in place."""
    for j in np.where(np.isnan(arr))[0]:
        lo, hi = max(0, j - 2), min(duration, j + 3)
        arr[j] = np.nanmean(arr[lo:hi])


def stitch_row(talk_probs, batch, i, probs, duration_outframes: int) -> None:
    """Scatter one window row into the talk array; an excluded (silent)
    row writes zeros.  A talk whose length lands on a .5 output frame puts
    the last window's end one past the talk array; it is clamped."""
    start, end = int(batch.starts[i]), int(batch.ends[i])
    end = min(end, duration_outframes)
    if end <= start:
        return
    talk_probs[start:end] = probs[i, :end - start] if batch.included[i] else 0


def dispatch_talk(engine: WindowInference, batches) -> list:
    """Upload and launch every window batch of one talk without waiting;
    returns (handle, batch) pairs for :func:`collect_talk`."""
    return [(engine.run_batch(batch), batch) for batch in batches]


def collect_talk(pending: list, duration_outframes: int) -> np.ndarray:
    """Download and stitch the handles of :func:`dispatch_talk` into the
    talk's frame probabilities, gaps filled."""
    talk_probs = np.full(duration_outframes, np.nan)
    for handle, batch in pending:
        probs = handle.numpy()
        for i in range(len(probs)):
            stitch_row(talk_probs, batch, i, probs, duration_outframes)
    nan_fill(talk_probs, duration_outframes)
    return talk_probs
