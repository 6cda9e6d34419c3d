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

On a mesh's data axis (``n_data`` > 1) each rank reads and collates only
its rows of every batch of the same seeded index: the ``LocalBatch``es it
yields equal, bitwise, the rows that ``parallel.mesh.local_rows`` cuts
from the whole batch.  What spans the batch comes from the index without
reading audio (``dataset.window_span``): the slot count, the audio bucket,
``norm_length``, the +-1 frame correction and ``n_real``.
"""

from __future__ import annotations

import dataclasses
import math
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core.frames import inframes_to_outframes, secs_to_inframes
from ..core.windows import fixed_window_grid
from .audio import WaveformCache, assert_sample_rate, read_wav_window
from .collate import (AutoRegBatch, Batch, collate, collate_autoreg,
                      out_len_for)

# the JAX loader's defaults: reader threads, and batches read ahead
READER_THREADS = 4
READER_PREFETCH = 2


def out_span(s: int, e: int) -> tuple[int, int]:
    """The output-frame (start, end) of the input-frame window [s, e)."""
    return (int(inframes_to_outframes(s + 1e-6)),
            int(inframes_to_outframes(e + 1e-6)))


@dataclasses.dataclass
class LocalBatch(Batch):
    """One data rank's rows of a batch, read alone: ``local_rows`` of the
    whole batch, whose row count is ``global_slots``."""
    global_slots: int = 0


@dataclasses.dataclass
class LocalAutoRegBatch(AutoRegBatch):
    """:class:`LocalBatch` of an ``AutoRegBatch``."""
    global_slots: int = 0


class FixedSegmentationDatasetNoTarget:
    """Fixed-length windows over a single wav, no targets — the inference
    product path (reference lib/dataset.py:571-668).  The wav is decoded
    once and every window sliced from it, unless ``whole_talk`` is False:
    a data rank that holds only some rows of each batch reads each of its
    windows alone (``read_wav_window``)."""

    has_targets = False

    def __init__(self, path_to_wav, segment_length: float = 20,
                 inference_times: int = 1, whole_talk: bool = True):
        self.path_to_wav = str(path_to_wav)
        self.segment_length = segment_length
        self.inference_times = inference_times
        self.duration_inframes = assert_sample_rate(path_to_wav)
        self.duration_outframes = int(
            inframes_to_outframes(self.duration_inframes))
        self.starts = np.array([], int)
        self.ends = np.array([], int)
        self._wav_cache = WaveformCache(1) if whole_talk else None

    def fixed_length_segmentation(self, iteration: int) -> None:
        self.starts, self.ends = fixed_window_grid(
            self.duration_inframes, self.segment_length,
            self.inference_times, iteration)

    def __len__(self) -> int:
        return len(self.starts)

    def window_span(self, idx: int) -> tuple[int, int, int]:
        """(samples, start, end) of window ``idx`` without reading it."""
        s, e = int(self.starts[idx]), int(self.ends[idx])
        return (e - s, *out_span(s, e))

    def __getitem__(self, idx: int):
        s, e = int(self.starts[idx]), int(self.ends[idx])
        if self._wav_cache is None:
            waveform = read_wav_window(self.path_to_wav, s, e - s)
        else:
            waveform = self._wav_cache.window(self.path_to_wav, s, e - s)
        return (waveform, None, *out_span(s, e))


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
    for the current iteration.  With ``n_data`` > 1 the batches are rank
    ``data_rank``'s rows (``LocalBatch``), read alone; the dataset then
    gives each window's span (``window_span``) and says whether its
    examples carry targets (``has_targets``)."""

    def __init__(self, dataset, batch_size: int, segment_length_secs: float,
                 remainder_ladder: bool = True, shuffle: bool = False,
                 seed: int | None = None, pin_memory: bool = False,
                 pad_token_id: float = 0.0, ctc_vocab=None,
                 autoregression: bool = False,
                 sep_token_id: int = 3, min_multiple: int = 1,
                 n_data: int = 1, data_rank: int = 0) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.std_len, self.tail_len = audio_bucket_lengths(segment_length_secs)
        self.remainder_ladder = remainder_ladder
        self.n_data, self.data_rank = n_data, data_rank
        # every slot count a multiple of the data ranks (``min_multiple``
        # only where one rank must round as a mesh of that many does)
        self.min_multiple = math.lcm(max(1, int(min_multiple)), n_data)
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

    def _own_rows(self, idx: np.ndarray) -> np.ndarray:
        """The indices of ``idx`` whose rows this rank holds."""
        slots = self._slots_for(len(idx))
        if slots % self.n_data:
            raise ValueError(f"a batch of {slots} rows does not split over "
                             f"{self.n_data} data ranks")
        per = slots // self.n_data
        return idx[self.data_rank * per:(self.data_rank + 1) * per]

    def _batch(self, idx: np.ndarray, read):
        """The batch of the indices ``idx``, or this rank's rows of it,
        from the examples that ``read`` returns for a list of indices."""
        if self.n_data == 1:
            examples = read(idx)
            batch = self._collate(examples, self._transcripts(idx),
                                  self._slots_for(len(idx)),
                                  max(len(ex[0]) for ex in examples))
        else:
            batch = self._collate_rows(read(self._own_rows(idx)), idx)
        return self._pinned(batch)

    def _transcripts(self, idx) -> list[str] | None:
        if self.ctc_vocab is None:
            return None
        return [self.dataset.transcript(int(j)) for j in idx]

    def _collate(self, examples, transcripts, slots: int, longest: int):
        """``examples`` into ``slots`` rows, in the audio bucket of a batch
        whose longest window has ``longest`` samples."""
        audio_len = self.std_len if longest <= self.std_len else self.tail_len
        out_len = out_len_for(audio_len)
        if self.autoregression:
            return collate_autoreg(examples, slots, audio_len, out_len,
                                   int(self.pad_token_id), self.sep_token_id)
        return collate(examples, slots, audio_len, out_len,
                       self.pad_token_id, device_normalize=True,
                       transcripts=transcripts, ctc_vocab=self.ctc_vocab)

    def _collate_rows(self, examples, idx):
        """This rank's rows of the batch ``idx`` from ``examples``, its own
        windows' (``_own_rows``): the batch's longest window and widest
        output span come from the index, and a silent stand-in window that
        long and that wide, collated after the rank's rows, gives
        ``collate`` the batch's ``norm_length`` and +-1 frame correction
        (and ``collate_autoreg`` the span it normalizes over).  Its row
        then takes a padding row's values, and the extra row goes."""
        own = self._own_rows(idx)
        slots = self._slots_for(len(idx))
        per = slots // self.n_data
        spans = [self.dataset.window_span(int(j)) for j in idx]
        lengths = dict(zip(idx.tolist(), (n for n, _, _ in spans)))
        for j, ex in zip(own.tolist(), examples):
            if len(ex[0]) != lengths[j]:
                raise ValueError(
                    f"window {j} read {len(ex[0])} samples where its span "
                    f"has {lengths[j]}: the rows of a data rank need the "
                    "batch's lengths from the index")
        longest = max(n for n, _, _ in spans)
        widest = max(e - s for _, s, e in spans)
        target = np.zeros(0, np.float32) if self.dataset.has_targets else None
        stand_in = (np.zeros(longest, np.float32), target, 0, widest)
        k = len(examples)
        transcripts = self._transcripts(own)
        rows = self._collate(list(examples) + [stand_in],
                             None if transcripts is None
                             else transcripts + [""], per + 1, longest)
        fields = {}
        for f in dataclasses.fields(rows):
            v = getattr(rows, f.name)
            if isinstance(v, np.ndarray) and v.ndim and v.shape[0] == per + 1:
                v[k] = v[-1]
                v = v[:per]
            fields[f.name] = v
        if self.autoregression:
            return LocalAutoRegBatch(**fields, global_slots=slots)
        fields["n_real"] = len(idx)
        return LocalBatch(**fields, global_slots=slots)

    def _pinned(self, batch):
        if self.pin_memory:  # the numpy view keeps the pinned tensor alive
            batch.audio = torch.from_numpy(batch.audio).pin_memory().numpy()
        return batch

    def _serial_batches(self):
        """The same batches, read and collated in the caller's thread."""
        for idx in self._index_batches():
            yield self._batch(idx, lambda ix: [self.dataset[j] for j in ix])

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
                        batch = self._batch(idx, lambda ix: list(
                            pool.map(self.dataset.__getitem__, ix)))
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
