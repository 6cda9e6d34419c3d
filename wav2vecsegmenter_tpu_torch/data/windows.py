"""Sliding inference windows over one wav, batched into static shapes.

Mirrors ``FixedSegmentationDatasetNoTarget`` (wav2vecsegmenter_tpu/data/
datasets.py) and ``BatchIterator``'s audio buckets, remainder ladder and
seeded shuffle (wav2vecsegmenter_tpu/data/loader.py), which import pandas;
this module needs numpy only.  The window grid, wav decoding and collation
are the port's own copies (``core.windows``, ``data.audio``,
``data.collate``).  Batches are collated in the consumer's thread, in
window order or in the seeded shuffled order; the examples' targets, where
a dataset has them, go into the batch.
"""

from __future__ import annotations

import numpy as np

from ..core.frames import inframes_to_outframes, secs_to_inframes
from ..core.windows import fixed_window_grid
from .audio import WaveformCache, assert_sample_rate
from .collate import collate, out_len_for


class FixedSegmentationDatasetNoTarget:
    """Fixed-length windows over a single wav, no targets — the inference
    product path (reference lib/dataset.py:571-668)."""

    def __init__(self, path_to_wav, segment_length: float = 20,
                 inference_times: int = 1):
        self.path_to_wav = str(path_to_wav)
        self.segment_length = segment_length
        self.inference_times = inference_times
        self.duration_inframes = assert_sample_rate(path_to_wav)
        self.duration_outframes = int(
            inframes_to_outframes(self.duration_inframes))
        self.starts = np.array([], int)
        self.ends = np.array([], int)
        self._wav_cache = WaveformCache(1)  # decode once, slice every window

    def fixed_length_segmentation(self, iteration: int) -> None:
        self.starts, self.ends = fixed_window_grid(
            self.duration_inframes, self.segment_length,
            self.inference_times, iteration)

    def __len__(self) -> int:
        return len(self.starts)

    def __getitem__(self, idx: int):
        s, e = int(self.starts[idx]), int(self.ends[idx])
        waveform = self._wav_cache.window(self.path_to_wav, s, e - s)
        start = int(inframes_to_outframes(s + 1e-6))
        end = int(inframes_to_outframes(e + 1e-6))
        return waveform, None, start, end


def audio_bucket_lengths(segment_length_secs: float) -> tuple[int, int]:
    """(standard, tail) static audio lengths: a window is at most
    segment_length + 2 s after the short-tail merge."""
    std = int(secs_to_inframes(segment_length_secs))
    tail = int(secs_to_inframes(segment_length_secs + 2))
    return std, tail


class BatchIterator:
    """Static-shape, device-normalized batches of a dataset, in order or,
    with ``shuffle``, in the order of ``RandomState(seed).shuffle``."""

    def __init__(self, dataset, batch_size: int, segment_length_secs: float,
                 remainder_ladder: bool = True, shuffle: bool = False,
                 seed: int | None = None) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.std_len, self.tail_len = audio_bucket_lengths(segment_length_secs)
        self.remainder_ladder = remainder_ladder
        self.shuffle = shuffle
        self.seed = seed

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def _slots_for(self, n: int) -> int:
        """Rows of a batch of ``n`` examples: ``batch_size``, or for a final
        partial batch under the ladder the smallest power of two >= n."""
        if not self.remainder_ladder or n >= self.batch_size:
            return self.batch_size
        slots = 1
        while slots < n:
            slots *= 2
        return min(slots, self.batch_size)

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed).shuffle(order)
        for i in range(0, n, self.batch_size):
            examples = [self.dataset[j] for j in order[i:i + self.batch_size]]
            longest = max(len(ex[0]) for ex in examples)
            audio_len = self.std_len if longest <= self.std_len else self.tail_len
            yield collate(examples, self._slots_for(len(examples)), audio_len,
                          out_len_for(audio_len), device_normalize=True)
