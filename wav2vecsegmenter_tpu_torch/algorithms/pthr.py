"""Threshold-walk segmentation (pTHR) with lerped thresholds and trailing
moving average.

Behavioral contract: reference lib/segment.py:508-592.  The trailing
moving average (reference's O(n*window) Python loop at :508-522) is computed
with a vectorized cumulative sum; the threshold walk itself is a cheap O(n)
host scan over the already-stitched talk array.

The walk is factored as :class:`StreamingPTHR`, which can be fed
probabilities incrementally with bounded lookahead (at most
``max_segment_length`` frames); the batch ``pthr`` entry point drives it
over the full array, so online and offline share one implementation and
agree exactly.

A copy of ``wav2vecsegmenter_tpu/algorithms/pthr.py``: the port imports
nothing of the JAX package (tests/test_torch_copies.py holds the two equal).
"""

from __future__ import annotations

import numpy as np

from ..constants import TARGET_SAMPLE_RATE, WAV2VEC_FRAME_LEN
from .segment import Segment


def moving_average(arr: np.ndarray, window: int) -> np.ndarray:
    """Trailing (causal) moving average: out[i] = mean(arr[max(0,i-w+1):i+1]).

    Equivalent to reference lib/segment.py:508-522 but O(n) via cumsum.
    """
    arr = np.asarray(arr, dtype=np.float64)
    n = len(arr)
    if n == 0:
        return arr.copy()
    window = max(1, int(window))
    csum = np.concatenate([[0.0], np.cumsum(arr)])
    idx = np.arange(1, n + 1)
    lo = np.maximum(0, idx - window)
    return (csum[idx] - csum[lo]) / (idx - lo)


class StreamingMA:
    """Incremental trailing moving average, bit-identical to
    :func:`moving_average` for any feed partition.

    Bit-exactness (not just closeness) matters because the smoothed value
    is compared against a threshold curve: an ulp of drift can flip a
    boundary between online and offline.  ``np.cumsum`` accumulates
    sequentially left-to-right, so seeding a chunk's cumsum with the
    running total reproduces the offline global csum values exactly; the
    windowed mean then subtracts the SAME two csum floats the offline
    code does.
    """

    def __init__(self, window: int):
        self.window = max(1, int(window))
        # global csum values for indices _lo_idx.._n (csum[0] = 0.0)
        self._csum = np.zeros(1, np.float64)
        self._lo_idx = 0
        self._n = 0  # total values seen

    def feed(self, arr: np.ndarray) -> np.ndarray:
        arr = np.asarray(arr, dtype=np.float64)
        m = len(arr)
        if not m:
            return arr
        new = np.cumsum(np.concatenate([self._csum[-1:], arr]))[1:]
        full = np.concatenate([self._csum, new])  # indices _lo_idx.._n+m
        idx = np.arange(self._n + 1, self._n + m + 1)
        lo = np.maximum(0, idx - self.window)
        out = (full[idx - self._lo_idx] - full[lo - self._lo_idx]) / (idx - lo)
        self._n += m
        # future means reach back to csum[max(0, n+1-window)]
        keep_from = max(0, self._n + 1 - self.window)
        self._csum = full[keep_from - self._lo_idx:]
        self._lo_idx = keep_from
        return out


def build_thresholds(
    max_segm_len_steps: int,
    min_segm_len_steps: int,
    max_lerp_steps: int,
    min_lerp_steps: int,
    threshold: float,
) -> np.ndarray:
    """Per-offset threshold curve (reference lib/segment.py:543-552):
    0 below the min length, lerp 0->threshold over min_lerp, flat, then lerp
    threshold->2*threshold over the final max_lerp span."""
    thresholds = np.full((max_segm_len_steps,), threshold, dtype=np.float64)
    thresholds[:min_segm_len_steps] = 0
    if min_lerp_steps:
        thresholds[min_segm_len_steps : min_segm_len_steps + min_lerp_steps] = (
            np.arange(min_lerp_steps, dtype=float) / (min_lerp_steps / threshold)
        )
    if max_lerp_steps:
        thresholds[max_segm_len_steps - max_lerp_steps : max_segm_len_steps] = (
            threshold
            + np.arange(max_lerp_steps, dtype=float) / (max_lerp_steps / threshold)
        )
    return thresholds


class StreamingPTHR:
    """Incremental pTHR walk.

    Feed (already smoothed, if ma applies) probabilities with :meth:`feed`;
    a segment commits as soon as its end frame cannot be changed by future
    audio — the walk needs at most ``len(thresholds)+1`` frames of
    lookahead past a segment start.  :meth:`flush` resolves the final
    segment with the reference's ``end = total - 1`` semantics.

    Spans are (start_frame, end_frame) inclusive-end like the reference's
    walk (lib/segment.py:567-590); the 0.06 s expansion/clamp is applied by
    the callers.
    """

    def __init__(self, thresholds: np.ndarray, threshold: float):
        self.thresholds = np.asarray(thresholds, np.float64)
        self.threshold = threshold
        self._buf = np.zeros(0, np.float64)
        self._base = 0  # absolute frame index of _buf[0]
        self._start = 0  # absolute walk pointer
        self._flushed = False

    def feed(self, probs: np.ndarray) -> list[tuple[int, int]]:
        assert not self._flushed, "feed() after flush()"
        probs = np.asarray(probs, np.float64)
        if len(probs):
            self._buf = np.concatenate([self._buf, probs])
        return self._scan(final=False)

    def flush(self) -> list[tuple[int, int]]:
        assert not self._flushed, "flush() called twice"
        self._flushed = True
        return self._scan(final=True)

    def _scan(self, final: bool) -> list[tuple[int, int]]:
        spans: list[tuple[int, int]] = []
        L = len(self.thresholds)
        total_known = self._base + len(self._buf)

        def prob(i: int) -> float:
            return float(self._buf[i - self._base])

        while True:
            # advance past below-threshold starts
            while (self._start < total_known
                   and prob(self._start) <= self.threshold):
                self._start += 1
            # frames behind the walk pointer can never be revisited — drop
            # them NOW, or a long sub-threshold (silent) stream retains its
            # entire history in _buf despite the bounded-lookahead contract
            drop = self._start - self._base
            if drop > 0:
                self._buf = self._buf[drop:]
                self._base = self._start
            if self._start >= total_known:
                break
            avail = total_known - self._start
            part = self._buf[self._start - self._base:
                             self._start - self._base + min(avail, L)]
            below = np.where(part <= self.thresholds[: len(part)])[0]
            if len(below) > 0:
                end = self._start + int(below[0])
            elif final:
                # reference: end = min(start + L, total - 1)
                end = min(self._start + L, total_known - 1)
            elif avail >= L + 1:
                # full window seen and at least one frame beyond: the
                # offline min(start+L, total-1) can no longer bind
                end = self._start + L
            else:
                break  # need more lookahead
            spans.append((self._start, end))
            self._start = end + 1
        return spans


def pthr(
    probs: np.ndarray,
    max_segment_length: float = 18,
    min_segment_length: float = 0.2,
    max_lerp_range: float = 0,
    min_lerp_range: float = 0,
    threshold: float = 0.5,
    moving_average_window: float = 0,
) -> list[Segment]:
    """pTHR walk (reference lib/segment.py:525-592): advance to the first
    frame above threshold, then end the segment at the first frame whose
    (optionally smoothed) probability dips below the offset-dependent
    threshold curve; expand each segment by 0.06 s."""
    frame_length = WAV2VEC_FRAME_LEN / 1000
    max_steps = int(max_segment_length / frame_length)
    min_steps = int(min_segment_length / frame_length)
    max_lerp_steps = int(max_lerp_range / frame_length)
    min_lerp_steps = int(min_lerp_range / frame_length)

    thresholds = build_thresholds(
        max_steps, min_steps, max_lerp_steps, min_lerp_steps, threshold
    )

    if moving_average_window > 0:
        probs = moving_average(probs, int(moving_average_window / frame_length))

    total = len(probs)
    minu_frame = TARGET_SAMPLE_RATE * 0.06

    walker = StreamingPTHR(thresholds, threshold)
    spans = walker.feed(probs)
    spans.extend(walker.flush())
    return [
        Segment(max(0, s - minu_frame), min(e + minu_frame, total - 1))
        for s, e in spans
    ]
