"""Probabilistic divide-and-conquer segmentation (pDAC).

Contract matches reference lib/segment.py:186-286 (pdac,
pdac_with_logits): recursively split a talk
at the lowest-probability frame until every segment is under
max_segment_length, skipping splits that would create a segment shorter than
min_segment_length.  The recursion runs on the host with an explicit stack,
so hour-long talks can't hit Python's recursion limit.

The port's copy of ``wav2vecsegmenter_tpu/algorithms/pdac.py``
(tests/test_torch_copies.py holds the two equal).
"""

from __future__ import annotations

import numpy as np

from .segment import (Segment, argtrim, split_and_argtrim, split_and_trim,
                      trim)


def pdac(
    probs: np.ndarray,
    max_segment_length: float = 18,
    min_segment_length: float = 0.2,
    threshold: float = 0.5,
) -> list[Segment]:
    """pDAC over frame probabilities (reference lib/segment.py:186-235).

    Split candidates are visited in ascending probability; a candidate above
    ``threshold`` aborts the search and keeps the segment whole.
    """
    segments: list[Segment] = []
    root = trim(Segment(0, len(probs), probs=probs), threshold)

    # Explicit DFS stack preserving the reference's output order: children are
    # processed left-first, appending leaves in temporal order.
    stack = [root]
    while stack:
        sgm = stack.pop()
        if sgm.duration < max_segment_length:
            segments.append(sgm)
            continue
        sorted_indices = np.argsort(sgm.probs)
        placed = False
        for split_idx in sorted_indices:
            if sgm.probs[split_idx] > threshold:
                segments.append(sgm)
                placed = True
                break
            sgm_a, sgm_b = split_and_trim(sgm, int(split_idx), threshold)
            if (
                sgm_a.duration > min_segment_length
                and sgm_b.duration > min_segment_length
            ):
                # push right first so left is processed first (temporal order)
                stack.append(sgm_b)
                stack.append(sgm_a)
                placed = True
                break
        if not placed:
            segments.append(sgm)

    return segments


def pdac_with_logits(
    probs: np.ndarray,
    logits: np.ndarray,
    vocab,
    max_segment_length: float = 18,
    min_segment_length: float = 0.2,
) -> list[Segment]:
    """pDAC using argmax-boundary trimming; split candidates visited in
    *descending* probability (reference lib/segment.py:238-286)."""
    segments: list[Segment] = []
    root = argtrim(Segment(0, len(logits), probs=probs, logits=logits), vocab)

    stack = [root]
    while stack:
        sgm = stack.pop()
        if sgm.duration < max_segment_length:
            segments.append(sgm)
            continue
        sorted_indices = np.argsort(sgm.probs)[::-1]
        placed = False
        for split_idx in sorted_indices:
            sgm_a, sgm_b = split_and_argtrim(sgm, int(split_idx), vocab)
            if (
                sgm_a.duration > min_segment_length
                and sgm_b.duration > min_segment_length
            ):
                stack.append(sgm_b)
                stack.append(sgm_a)
                placed = True
                break
        if not placed:
            segments.append(sgm)

    return segments
