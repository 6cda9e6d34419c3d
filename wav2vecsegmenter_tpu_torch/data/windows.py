"""Sliding inference windows over one wav, batched into static shapes.

Mirrors ``FixedSegmentationDatasetNoTarget`` (wav2vecsegmenter_tpu/data/
datasets.py) and ``BatchIterator``'s audio buckets, remainder ladder and
seeded shuffle (wav2vecsegmenter_tpu/data/loader.py), which import pandas;
this module needs none.  The window grid, wav decoding and collation
are the port's own copies (``core.windows``, ``data.audio``,
``data.collate``).  Batches come in window order or in the seeded shuffled
order; the examples' targets, where a dataset has them, go into the batch,
padded with ``pad_token_id`` (a vocabulary's ``<PAD>`` for the multi-class
tasks), and with ``ctc_vocab`` the windows' encoded transcripts.  With
``autoregression`` (``task=arseg``) the batches are ``AutoRegBatch``es
(``collate_autoreg``: the targets as SEP-led decoder input and SEP-tailed
output, ``sep_token_id`` from the vocabulary), normalized on the host, as
the JAX loader turns device normalization off for them.

The batches are read and collated ahead of the consumer, as the JAX
loader reads them: a producer thread maps ``dataset.__getitem__`` over each
batch's indices on a pool of ``READER_THREADS`` threads and hands the
collated batches over a queue of ``READER_PREFETCH``.  With ``pin_memory`` (a CUDA consumer) each batch's audio
lies in pinned host memory, so that its upload can be asynchronous; the
reader thread itself creates no CUDA tensor and launches nothing.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core.frames import inframes_to_outframes, secs_to_inframes
from ..core.windows import fixed_window_grid
from .audio import WaveformCache, assert_sample_rate
from .collate import collate, collate_autoreg, out_len_for

# the JAX loader's defaults: reader threads, and batches read ahead
READER_THREADS = 4
READER_PREFETCH = 2


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
    with ``shuffle``, in the order of ``RandomState(seed).shuffle``, read
    ``prefetch`` batches ahead on ``num_threads`` threads.  ``read_seconds``
    holds each batch's read + collate time in the reader, in batch order,
    for the current iteration."""

    def __init__(self, dataset, batch_size: int, segment_length_secs: float,
                 remainder_ladder: bool = True, shuffle: bool = False,
                 seed: int | None = None, pin_memory: bool = False,
                 pad_token_id: float = 0.0, ctc_vocab=None,
                 autoregression: bool = False,
                 sep_token_id: int = 3, min_multiple: int = 1) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.std_len, self.tail_len = audio_bucket_lengths(segment_length_secs)
        self.remainder_ladder = remainder_ladder
        # a mesh's data ranks: every slot count a multiple of them
        self.min_multiple = max(1, int(min_multiple))
        self.shuffle = shuffle
        self.seed = seed
        self.pin_memory = pin_memory
        self.pad_token_id = pad_token_id
        # CTC task: the windows' transcripts (``dataset.transcript``),
        # encoded into the batch's tokens
        self.ctc_vocab = ctc_vocab
        self.autoregression = autoregression
        self.sep_token_id = sep_token_id
        self.read_seconds: list[float] = []

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def _slots_for(self, n: int) -> int:
        """Rows of a batch of ``n`` examples: ``batch_size``, or for a final
        partial batch under the ladder the smallest power of two >= n,
        rounded up to ``min_multiple``."""
        if not self.remainder_ladder or n >= self.batch_size:
            return self.batch_size
        m = self.min_multiple
        slots = 1
        while slots < n:
            slots *= 2
        slots = ((slots + m - 1) // m) * m
        return min(slots, self.batch_size)

    def _index_batches(self) -> list[np.ndarray]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed).shuffle(order)
        return [order[i:i + self.batch_size]
                for i in range(0, len(order), self.batch_size)]

    def _collate(self, examples, idx):
        longest = max(len(ex[0]) for ex in examples)
        audio_len = self.std_len if longest <= self.std_len else self.tail_len
        slots, out_len = self._slots_for(len(examples)), out_len_for(audio_len)
        if self.autoregression:
            batch = collate_autoreg(examples, slots, audio_len, out_len,
                                    int(self.pad_token_id), self.sep_token_id)
            return self._pinned(batch)
        transcripts = None
        if self.ctc_vocab is not None:
            transcripts = [self.dataset.transcript(int(j)) for j in idx]
        batch = collate(examples, slots, audio_len, out_len,
                        self.pad_token_id, device_normalize=True,
                        transcripts=transcripts, ctc_vocab=self.ctc_vocab)
        return self._pinned(batch)

    def _pinned(self, batch):
        if self.pin_memory:  # the numpy view keeps the pinned tensor alive
            batch.audio = torch.from_numpy(batch.audio).pin_memory().numpy()
        return batch

    def _serial_batches(self):
        """The same batches, read and collated in the caller's thread."""
        for idx in self._index_batches():
            yield self._collate([self.dataset[j] for j in idx], idx)

    def __iter__(self):
        idx_batches = self._index_batches()
        self.read_seconds = read_seconds = []
        q: queue.Queue = queue.Queue(maxsize=READER_PREFETCH)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            """``q.put`` that gives up once the consumer has abandoned the
            iteration, instead of blocking the producer on a full queue."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(
                        READER_THREADS,
                        thread_name_prefix="batch-reader") as pool:
                    for idx in idx_batches:
                        if stop.is_set():
                            return
                        t0 = time.perf_counter()
                        batch = self._collate(
                            list(pool.map(self.dataset.__getitem__, idx)),
                            idx)
                        read_seconds.append(time.perf_counter() - t0)
                        if not put_or_stop(batch):
                            return
            except BaseException as e:  # re-raised in the consumer
                put_or_stop(e)
                return
            put_or_stop(None)

        threading.Thread(target=produce, name="batch-producer",
                         daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
