"""Window-grid generation for sliding-window inference.

Semantics mirror the reference's fixed grids: lib/dataset.py:612-639
(FixedSegmentationDatasetNoTarget.fixed_length_segmentation) and the
identical logic at lib/dataset.py:354-400.  Returns (starts, ends) int
arrays in input space (16 kHz samples).

Copies of ``fixed_window_grid`` and ``random_window_grid`` of
``wav2vecsegmenter_tpu/core/windows.py`` (tests/test_torch_copies.py holds
them equal); the random training grid follows reference
lib/dataset.py:193-222.
"""

from __future__ import annotations

import numpy as np

from .frames import (
    inframes_to_outframes,
    outframes_to_inframes,
    secs_to_inframes,
    secs_to_outframes,
)


def fixed_window_grid(
    duration_inframes: int,
    segment_length_secs: float,
    inference_times: int = 1,
    iteration: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Fixed-length segmentation of a talk, offset by ``iteration``.

    ``iteration`` in [0, inference_times) shifts the grid start by
    ``L / inference_times * iteration`` so multiple passes cover window
    boundaries differently; a trailing remainder < 2 s is merged into the
    final window (reference lib/dataset.py:624-636).
    """
    segment_length_inframes = int(secs_to_inframes(segment_length_secs))

    start = round(segment_length_inframes / inference_times * iteration)
    if start > duration_inframes:
        start = 0
    grid = np.arange(start, duration_inframes, segment_length_inframes).astype(int)
    if grid[0] != 0:
        grid = np.insert(grid, 0, 0)
    if grid[-1] != duration_inframes:
        if duration_inframes - grid[-1] < secs_to_inframes(2):
            grid[-1] = duration_inframes
        else:
            grid = np.append(grid, duration_inframes)

    return grid[:-1], grid[1:]


def random_window_grid(
    total_frames: int,
    segment_length_secs: float,
    rng: np.random.RandomState | np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Random segmentation of a talk for one training epoch.

    Grid step is ``L - L/10`` in output space with each start jittered
    backwards by up to 10% of the window (reference lib/dataset.py:201-217);
    windows are clipped to [0, total_frames].
    """
    if rng is None:
        rng = np.random
    segment_length_outframes = int(secs_to_outframes(segment_length_secs))
    max_overlap = int(secs_to_outframes(segment_length_secs / 10))
    segment_length_inframes = int(secs_to_inframes(segment_length_secs))

    start_range = np.arange(
        0,
        int(inframes_to_outframes(total_frames)),
        step=segment_length_outframes - max_overlap,
    )
    if hasattr(rng, "randint"):
        jitter = rng.randint(0, max_overlap, size=len(start_range))
    else:  # np.random.Generator
        jitter = rng.integers(0, max_overlap, size=len(start_range))
    start_range = start_range - jitter
    start_range = outframes_to_inframes(start_range)

    starts = np.maximum(0, start_range)
    ends = np.minimum(start_range + segment_length_inframes, total_frames)
    return starts.astype(int), ends.astype(int)
