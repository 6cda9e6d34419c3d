"""Streaming segmentation algorithm (pSTRM).

Re-implementation of the "Streaming" algorithm of Gaido et al. 2021 with the
same observable behavior as reference lib/segment.py:419-505, but using
integer run-length encoding instead of Python string find/sort — the
reference builds a '0101...' string per talk and regex-scans it; here runs of
0s are located with vectorized NumPy.

Chunks of ``max_segm_len`` frames are consumed left to right (simulating a
stream); in each chunk the longest pause after the first ``min_segm_len``
frames is located, the speech before it is emitted as a segment, and the
remainder after the pause is carried over to the next chunk.

The chunk loop is factored as :class:`StreamingSTRM`, which can be fed
frame predictions incrementally (true streaming); the batch entry points
below drive it over a full array, so online and offline runs share one
implementation and agree exactly.

A copy of ``wav2vecsegmenter_tpu/algorithms/strm.py``: the port imports
nothing of the JAX package (tests/test_torch_copies.py holds the two equal).
"""

from __future__ import annotations

import numpy as np

from ..constants import TARGET_SAMPLE_RATE, WAV2VEC_FRAME_LEN
from .segment import Segment


def _longest_zero_run(bits: np.ndarray) -> tuple[int, int]:
    """(start, length) of the longest run of zeros; ties pick the *first*
    run (np.argmax returns the first maximum, matching the reference: its
    str.split() locates the first occurrence of the max-pause string)."""
    if len(bits) == 0:
        return -1, 0
    padded = np.concatenate([[1], bits, [1]])
    diffs = np.diff(padded)
    starts = np.where(diffs == -1)[0]
    ends = np.where(diffs == 1)[0]
    if len(starts) == 0:
        return -1, 0
    lengths = ends - starts
    # The reference sorts runs ascending by length, takes the last as the
    # max-pause *string*, then str.split() finds its FIRST occurrence — for
    # tied maximal runs that is the first such run.
    idx = int(np.argmax(lengths))
    return int(starts[idx]), int(lengths[idx])


class StreamingSTRM:
    """Incremental pSTRM chunker.

    Feed thresholded frame predictions with :meth:`feed`; spans are
    committed as soon as a full ``max_segm_len`` chunk (minus carried-over
    leftover) is available, exactly as the reference's offline loop would
    have committed them.  :meth:`flush` processes the final partial chunk
    (the reference's ``end = total`` case) and must be called once at
    stream end.

    Spans are ``(start, end, is_speech)`` in absolute frame indices,
    equivalent to the reference's list of '0'/'1' strings
    (lib/segment.py:454-505) with spans instead of substrings.
    """

    def __init__(self, max_segm_len: int, min_segm_len: int,
                 min_pause_len: int):
        self.max_len = max_segm_len
        self.min_len = min_segm_len
        self.min_pause = min_pause_len
        self._buf = np.zeros(0, dtype=np.int8)  # pending frames
        self._buf_start = 0  # absolute index of _buf[0]
        self._leftover_len = 0  # prefix of _buf carried from the last chunk
        self._flushed = False

    def feed(self, bits: np.ndarray) -> list[tuple[int, int, bool]]:
        assert not self._flushed, "feed() after flush()"
        if len(bits):
            self._buf = np.concatenate(
                [self._buf, np.asarray(bits, dtype=np.int8)])
        spans: list[tuple[int, int, bool]] = []
        # a chunk is ready when leftover + fresh frames reach max_len
        while len(self._buf) >= self.max_len:
            spans.extend(self._process_chunk(self.max_len))
        return spans

    def flush(self) -> list[tuple[int, int, bool]]:
        """Process the final (possibly partial) chunk, mirroring the
        reference loop's last iteration where ``end = total``."""
        assert not self._flushed, "flush() called twice"
        self._flushed = True
        spans: list[tuple[int, int, bool]] = []
        # only fresh frames end the stream; bare leftover is dropped at
        # stream end exactly like the reference (its loop exits when
        # start == total with the leftover unprocessed)
        while len(self._buf) > self._leftover_len:
            spans.extend(self._process_chunk(len(self._buf)))
        return spans

    def _process_chunk(self, size: int) -> list[tuple[int, int, bool]]:
        cur = self._buf[:size]
        cur_start = self._buf_start
        spans: list[tuple[int, int, bool]] = []

        def emit(s: int, e: int):
            if e > s:
                seg = self._buf[s - self._buf_start: e - self._buf_start]
                spans.append((s, e, bool(seg.any())))

        second = cur[self.min_len:]
        run_start, run_len = _longest_zero_run(second)

        if run_len > self.min_pause:
            first_len = min(self.min_len, len(cur))
            abs_pause_start = cur_start + first_len + run_start
            abs_pause_end = abs_pause_start + run_len
            first_part = cur[:first_len]
            if len(first_part) == 0 or not first_part.any():
                # first_part is a pause: emit separately
                emit(cur_start, cur_start + first_len)
                if run_start > 0:
                    emit(cur_start + first_len, abs_pause_start)
            else:
                emit(cur_start, abs_pause_start)
            emit(abs_pause_start, abs_pause_end)
            consumed = abs_pause_end - self._buf_start
            self._leftover_len = size - consumed
        else:
            emit(cur_start, cur_start + size)
            consumed = size
            self._leftover_len = 0

        self._buf = self._buf[consumed:]
        self._buf_start += consumed
        return spans


def split_predictions_strm(
    preds: np.ndarray, max_segm_len: int, min_segm_len: int, min_pause_len: int
) -> list[tuple[int, int, bool]]:
    """Offline chunked streaming split over a full prediction array
    (reference lib/segment.py:454-505)."""
    s = StreamingSTRM(max_segm_len, min_segm_len, min_pause_len)
    spans = s.feed(np.asarray(preds, dtype=np.int8))
    spans.extend(s.flush())
    return spans


def get_segments(spans: list[tuple[int, int, bool]], total_frames: int) -> list[Segment]:
    """Speech spans -> Segments, each expanded by 0.06 s on both sides
    (reference lib/segment.py:389-416)."""
    minu_frame = TARGET_SAMPLE_RATE * 0.06
    segments = []
    for s, e, is_speech in spans:
        if is_speech:
            start = max(0, s - minu_frame)
            end = min(e + minu_frame, total_frames)
            segments.append(Segment(start, end))
    return segments


def strm(
    probs: np.ndarray,
    max_segment_length: float = 18,
    min_segment_length: float = 0.2,
    min_pause_length: float = 0.2,
    threshold: float = 0.5,
) -> list[Segment]:
    """pSTRM entry point (reference lib/segment.py:419-443)."""
    frame_length = WAV2VEC_FRAME_LEN / 1000
    max_steps = int(max_segment_length / frame_length)
    min_steps = int(min_segment_length / frame_length)
    min_pause_steps = int(min_pause_length / frame_length)

    preds = (probs > threshold).astype(np.int8)
    spans = split_predictions_strm(preds, max_steps, min_steps, min_pause_steps)
    return get_segments(spans, len(preds))
