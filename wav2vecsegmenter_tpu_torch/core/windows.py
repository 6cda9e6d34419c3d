"""Window-grid generation for sliding-window inference.

Semantics mirror the reference's fixed grids: lib/dataset.py:612-639
(FixedSegmentationDatasetNoTarget.fixed_length_segmentation) and the
identical logic at lib/dataset.py:354-400.  Returns (starts, ends) int
arrays in input space (16 kHz samples).

A copy of ``fixed_window_grid`` of ``wav2vecsegmenter_tpu/core/windows.py``
(tests/test_torch_copies.py holds the two equal); the random training grid
comes with the training slice.
"""

from __future__ import annotations

import numpy as np

from .frames import secs_to_inframes


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
