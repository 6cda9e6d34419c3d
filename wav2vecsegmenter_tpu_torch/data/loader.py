"""Per-epoch training loaders and fixed-grid evaluation loaders.

Counterpart of the generators of ``wav2vecsegmenter_tpu/data/loader.py``
(reference lib/dataset.py:671-813), over the port's datasets
(``data.datasets``) and its ``BatchIterator`` (``data.windows``), which
reads ahead on a thread pool and, with ``pin_memory``, leaves each
batch's audio in pinned host memory.  Batches carry raw int16 audio for
normalization on the device, and the windows' targets; with a ``vocab``
(the multi-class tasks) the targets are padded with its ``<PAD>`` id, and
with ``ctc`` the batches carry the windows' encoded transcripts; with
``autoregression`` (``task=arseg``) they are ``AutoRegBatch``es, SEP-wrapped
with the vocabulary's ``<SEP>`` and normalized on the host.  On a mesh's
data axis (``n_data`` ranks, this one ``data_rank``) each rank reads only
its rows of every batch (``data.windows.LocalBatch``).
"""

from __future__ import annotations

import numpy as np

from .datasets import FixedSegmentationDataset, RandomSegmentationDataset
from .windows import BatchIterator


def _vocab_kwargs(vocab, ctc: bool, autoregression: bool) -> dict:
    """``BatchIterator``'s target pad, transcript vocabulary and
    autoregressive collation, as the JAX generators pass them."""
    return {"pad_token_id": vocab.pad_token_id if vocab else 0.0,
            "ctc_vocab": vocab if ctc else None,
            "autoregression": autoregression,
            "sep_token_id": vocab.sep_token_id if vocab else 3}


class RandomDataloaderGenerator:
    """Per-epoch random resegmentation (reference lib/dataset.py:671-734):
    each ``generate`` draws the next epoch seed, which seeds both the
    window grid and the shuffle."""

    def __init__(self, talk_list, segments_list, segment_length, batch_size,
                 seed: int | None = None,
                 pin_memory: bool = False, vocab=None,
                 ctc: bool = False, autoregression: bool = False,
                 n_data: int = 1, data_rank: int = 0) -> None:
        self.vocab = vocab
        self.ranks = {"n_data": n_data, "data_rank": data_rank}
        self.ctc = ctc
        self.autoregression = autoregression
        self.talk_list = talk_list
        self.segments_list = segments_list
        self.segment_length = segment_length
        self.batch_size = batch_size
        self.pin_memory = pin_memory
        self._rng = np.random.RandomState(seed)
        self.dataset: RandomSegmentationDataset | None = None

    def skip_epoch_seeds(self, n: int) -> None:
        """Advance the per-epoch seed stream without building datasets."""
        for _ in range(max(0, int(n))):
            self._rng.randint(0, 2**31 - 1)

    def generate(self) -> BatchIterator:
        seed = int(self._rng.randint(0, 2**31 - 1))
        self.dataset = RandomSegmentationDataset(
            self.talk_list, self.segments_list, self.segment_length, seed)
        return BatchIterator(self.dataset, self.batch_size,
                             float(self.segment_length),
                             remainder_ladder=False, shuffle=True, seed=seed,
                             pin_memory=self.pin_memory, **self.ranks,
                             **_vocab_kwargs(self.vocab, self.ctc,
                                             self.autoregression))


class FixedDataloaderGenerator:
    """Fixed-grid loaders (reference lib/dataset.py:737-813): evaluation,
    and the training loader of ``task=shas_fix``."""

    def __init__(self, talk_list, segments_list, segment_length, batch_size,
                 inference_times: int = 1,
                 remainder_ladder: bool = False,
                 pin_memory: bool = False, vocab=None,
                 ctc: bool = False, autoregression: bool = False,
                 min_multiple: int = 1, n_data: int = 1,
                 data_rank: int = 0) -> None:
        self.vocab = vocab
        self.ranks = {"n_data": n_data, "data_rank": data_rank}
        self.ctc = ctc
        self.autoregression = autoregression
        self.batch_size = batch_size
        self.segment_length = segment_length
        self.remainder_ladder = remainder_ladder
        # a one-rank reference of a mesh's ladder (``BatchIterator``)
        self.min_multiple = min_multiple
        self.pin_memory = pin_memory
        self.dataset = FixedSegmentationDataset(
            talk_list, segments_list, segment_length, inference_times,
            whole_talk=n_data == 1)

    def generate(self, talk_id, iteration: int) -> BatchIterator:
        """Windows of one talk (or of every talk, for ``talk_id == ""``)."""
        if talk_id == "":
            self.dataset.generate_fixed_segments_all_talks(iteration)
        else:
            self.dataset.generate_fixed_segments(talk_id, iteration)
        return BatchIterator(self.dataset, self.batch_size,
                             float(self.segment_length),
                             remainder_ladder=self.remainder_ladder,
                             pin_memory=self.pin_memory,
                             min_multiple=self.min_multiple, **self.ranks,
                             **_vocab_kwargs(self.vocab, self.ctc,
                                             self.autoregression))

    def get_talk_ids(self) -> list:
        return self.dataset.corpus.talk_ids()
