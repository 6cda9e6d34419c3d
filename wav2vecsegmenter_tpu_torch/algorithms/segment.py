"""Segment primitive and trim operations.

Behavioral contract follows reference lib/segment.py:13-158: a Segment
covers [start, end) in output-frame space (49.95 Hz); ``duration``/``offset``
round to 6 decimals when converting to seconds.

The port's copy of what pTHR, pDAC, pSTRM and pDAC-with-logits use of
``wav2vecsegmenter_tpu/algorithms/segment.py`` (tests/test_torch_copies.py
holds the two equal), with the soft trims of the synthetic-data tool's
tree.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import TARGET_SAMPLE_RATE


@dataclass
class Segment:
    start: float
    end: float
    probs: np.ndarray | None = None
    logits: np.ndarray | None = None
    decimal: int = 6

    @property
    def duration(self) -> float:
        return float(round((self.end - self.start) / TARGET_SAMPLE_RATE, self.decimal))

    @property
    def offset(self) -> float:
        return float(round(self.start / TARGET_SAMPLE_RATE, self.decimal))

    @property
    def offset_plus_duration(self) -> float:
        return round(self.offset + self.duration, self.decimal)


def trim(sgm: Segment, threshold: float) -> Segment:
    """Shrink to the span between the first/last probs >= threshold
    (reference lib/segment.py:34-53)."""
    included = np.where(sgm.probs >= threshold)[0]
    if not len(included):
        return Segment(sgm.start, sgm.start, probs=np.empty([0]))
    i, j = included[0], included[-1] + 1
    return Segment(sgm.start + i, sgm.start + j, probs=sgm.probs[i:j])


def argtrim(sgm: Segment, vocab) -> Segment:
    """Shrink to the span between the first/last argmax-non-boundary frames
    (reference lib/segment.py:56-78)."""
    preds = np.argmax(sgm.logits, axis=-1)
    included = np.where(preds != vocab.boundary_token_id)[0]
    if not len(included):
        return Segment(sgm.start, sgm.start, probs=np.empty([0]), logits=np.empty([0]))
    i, j = included[0], included[-1] + 1
    return Segment(
        sgm.start + i, sgm.start + j, probs=sgm.probs[i:j], logits=sgm.logits[i:j]
    )


def _empty(start: float) -> Segment:
    return Segment(start, start, probs=np.empty([0]))


def soft_trim(sgm: Segment, boundary_threshold: float, trim_threshold: float) -> Segment:
    """Trim variant for tree generation (reference lib/segment.py:81-110):
    frames outside the boundary-threshold span are pinned to prob 1 so they
    can never be chosen as split points, then the segment is trimmed to the
    trim-threshold span."""
    boundary_cand = np.where(sgm.probs >= boundary_threshold)[0]
    included = np.where(sgm.probs >= trim_threshold)[0]
    if not len(boundary_cand):
        return _empty(sgm.start)
    sgm.probs[: boundary_cand[0]] = 1
    sgm.probs[boundary_cand[-1] + 1 :] = 1
    i, j = included[0], included[-1] + 1
    return Segment(sgm.start + i, sgm.start + j, probs=sgm.probs[i:j])


def split_and_trim(sgm: Segment, split_idx: int, threshold: float):
    """Split at split_idx (the split frame itself is dropped) and trim both
    halves (reference lib/segment.py:113-134)."""
    probs_a = sgm.probs[:split_idx]
    sgm_a = Segment(sgm.start, sgm.start + len(probs_a), probs=probs_a)
    probs_b = sgm.probs[split_idx + 1 :]
    sgm_b = Segment(sgm_a.end + 1, sgm.end, probs=probs_b)
    return trim(sgm_a, threshold), trim(sgm_b, threshold)


def split_and_argtrim(sgm: Segment, split_idx: int, vocab):
    """As split_and_trim but with argmax trimming (reference lib/segment.py:137-158)."""
    sgm_a = Segment(
        sgm.start,
        sgm.start + split_idx,
        probs=sgm.probs[:split_idx],
        logits=sgm.logits[:split_idx],
    )
    sgm_b = Segment(
        sgm_a.end + 1,
        sgm.end,
        probs=sgm.probs[split_idx + 1 :],
        logits=sgm.logits[split_idx + 1 :],
    )
    return argtrim(sgm_a, vocab), argtrim(sgm_b, vocab)


def split_and_softtrim(
    sgm: Segment, split_idx: int, boundary_threshold: float, trim_threshold: float
):
    """As split_and_trim but with soft trimming (reference lib/segment.py:161-183)."""
    probs_a = sgm.probs[:split_idx]
    sgm_a = Segment(sgm.start, sgm.start + len(probs_a), probs=probs_a)
    probs_b = sgm.probs[split_idx + 1 :]
    sgm_b = Segment(sgm_a.end + 1, sgm.end, probs=probs_b)
    return (
        soft_trim(sgm_a, boundary_threshold, trim_threshold),
        soft_trim(sgm_b, boundary_threshold, trim_threshold),
    )
