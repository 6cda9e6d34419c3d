"""The port's background batch reader (``data.windows.BatchIterator``):
batches read ahead on a thread pool and handed over a bounded queue, as the
JAX loader's.  The threaded batches must equal the serial builder's
(``_serial_batches``) and the JAX loader's exactly, for the random training
generator over three epochs (with ``skip_epoch_seeds``) and the fixed grid
with and without the remainder ladder; the segment path's yaml must not
change; an abandoned iteration must stop its threads, and a reader's
exception must reach the consumer.
"""

import dataclasses
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch

from wav2vecsegmenter_tpu.data import loader as jloader
from wav2vecsegmenter_tpu_torch.cli import common as tcommon
from wav2vecsegmenter_tpu_torch.data import audio as taudio
from wav2vecsegmenter_tpu_torch.data import loader as tloader
from wav2vecsegmenter_tpu_torch.data import windows as twindows
from wav2vecsegmenter_tpu_torch.data.windows import (
    BatchIterator, FixedSegmentationDatasetNoTarget)
from wav2vecsegmenter_tpu_torch.models.shas import SHAS
from wav2vecsegmenter_tpu_torch.models.wav2vec2 import (Wav2Vec2Config,
                                                         init_from_numpy)

from .helpers import TINY_W2V, make_speechlike_wav

PTHR = {"tag": "pthr", "max_segment_length": 28, "min_segment_length": 0.2,
        "max_lerp_range": 4, "min_lerp_range": 0.4, "threshold": 0.1,
        "moving_average_window": 0.1}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three talks (13.3 s, 9.1 s, 5.2 s) with true segments, written as
    the JAX package's data prep writes them (pandas TSVs)."""
    root = tmp_path_factory.mktemp("reader_corpus")
    talks, segments = [], []
    for i, secs in enumerate((13.3, 9.1, 5.2)):
        path = root / f"ted_{i}.wav"
        make_speechlike_wav(path, duration_secs=secs, seed=i)
        talks.append({"id": f"ted_{i}", "path": str(path),
                      "total_frames": int(secs * 16000)})
        for s0 in np.arange(0.2, secs - 1.0, 2.7):
            segments.append({"talk_id": f"ted_{i}", "start": int(s0 * 16000),
                             "end": int(min(s0 + 2.1, secs) * 16000)})
    pd.DataFrame(talks).to_csv(root / "talks.tsv", sep="\t")
    pd.DataFrame(segments).to_csv(root / "segments.tsv", sep="\t")
    return str(root / "talks.tsv"), str(root / "segments.tsv")


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for field in dataclasses.fields(g):
            a, b = getattr(g, field.name), getattr(w, field.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype, field.name
                np.testing.assert_array_equal(a, b, err_msg=field.name)
            else:
                assert a == b, field.name


def _reader_threads() -> list:
    return [t for t in threading.enumerate()
            if t.name == "batch-producer" or t.name.startswith("batch-reader")]


def _wait_for_no_reader(timeout: float = 2.0) -> list:
    deadline = time.monotonic() + timeout
    while _reader_threads() and time.monotonic() < deadline:
        time.sleep(0.02)
    return _reader_threads()


def test_random_generator_batches(corpus):
    """Three epochs, the third after skipping a seed: threaded == serial ==
    the JAX loader's, and each batch's read time is recorded."""
    talks, segments = corpus
    got = tloader.RandomDataloaderGenerator(talks, segments, 4, 3, seed=7)
    want = jloader.RandomDataloaderGenerator(talks, segments, 4, 3,
                                             num_workers=2, seed=7,
                                             device_normalize=True)
    for epoch in range(3):
        if epoch == 2:
            got.skip_epoch_seeds(1)
            want.skip_epoch_seeds(1)
        loader = got.generate()
        threaded = list(loader)
        assert len(loader.read_seconds) == len(threaded)
        assert all(s >= 0 for s in loader.read_seconds)
        _assert_same_batches(threaded, list(loader._serial_batches()))
        _assert_same_batches(threaded, list(want.generate()))
        assert (got.dataset.pos_class_percentage
                == want.dataset.pos_class_percentage)


@pytest.mark.parametrize("ladder", [False, True])
def test_fixed_generator_batches(corpus, ladder):
    """Per talk and over every talk (the shas_fix training grid), two
    inference passes, with and without the remainder ladder."""
    talks, segments = corpus
    got = tloader.FixedDataloaderGenerator(talks, segments, 4, 3,
                                           inference_times=2,
                                           remainder_ladder=ladder)
    want = jloader.FixedDataloaderGenerator(talks, segments, 4, 3,
                                            num_workers=2, inference_times=2,
                                            device_normalize=True,
                                            remainder_ladder=ladder)
    for talk in want.get_talk_ids() + [""]:
        for it in range(2):
            loader = got.generate(talk, it)
            threaded = list(loader)
            _assert_same_batches(threaded, list(loader._serial_batches()))
            _assert_same_batches(threaded, list(want.generate(talk, it)))
    if ladder:  # the ladder right-sizes some talk's last batch
        assert any(b.audio.shape[0] < 3 for talk in want.get_talk_ids()
                   for b in got.generate(talk, 0))


def test_fixed_grid_decodes_each_talk_once(corpus, monkeypatch):
    """The reader's four threads all miss the cache on a talk's first
    batch: one decodes the wav, the others wait for it."""
    talks, segments = corpus
    calls = []
    real = taudio.read_wav_window

    def counted(path, offset=0, num_frames=None):
        calls.append(str(path))
        time.sleep(0.05)  # widen the window in which the threads miss
        return real(path, offset, num_frames)

    monkeypatch.setattr(taudio, "read_wav_window", counted)
    gen = tloader.FixedDataloaderGenerator(talks, segments, 2, 4)
    for talk in gen.get_talk_ids():
        assert len(list(gen.generate(talk, 0))) > 0
    assert sorted(calls) == sorted(set(calls)) and len(calls) == 3


def _tiny_model() -> SHAS:
    model = SHAS(wav2vec_keep_layers=2, n_transformer_enc_layers=1,
                 n_transformer_enc_heads=4, init_dropout=0.0,
                 w2v_cfg=Wav2Vec2Config(**dataclasses.asdict(TINY_W2V)))
    init_from_numpy(model, seed=0)
    return model.eval()


def test_segment_wavs_two_passes_unchanged(tmp_path, monkeypatch):
    """segment_wavs with inference_times=2 (the grid rewritten between
    passes): the same yaml rows and probabilities with the reader as with
    the serial builder, and one read time a batch."""
    wavs = [tmp_path / "a.wav", tmp_path / "b.wav"]
    make_speechlike_wav(wavs[0], duration_secs=47.3, seed=0)
    make_speechlike_wav(wavs[1], duration_secs=25.0, seed=1)
    model = _tiny_model()

    def run():
        probs, reads = {}, []
        rows = tcommon.segment_wavs(model, wavs, PTHR, 2, 20.0, 2,
                                    torch.device("cpu"), torch.float32,
                                    talk_probs=probs, read_seconds=reads)
        return rows, probs, reads

    rows, probs, reads = run()
    with monkeypatch.context() as m:
        m.setattr(BatchIterator, "__iter__", BatchIterator._serial_batches)
        rows_serial, probs_serial, _ = run()
    assert rows == rows_serial and rows
    for name in probs:
        np.testing.assert_array_equal(probs[name], probs_serial[name])
    n_batches = 0
    for w in wavs:
        ds = FixedSegmentationDatasetNoTarget(w, 20.0, 2)
        for it in range(2):
            ds.fixed_length_segmentation(it)
            n_batches += len(BatchIterator(ds, 2, 20.0))
    assert len(reads) == n_batches


def test_abandoned_iteration_stops_the_reader(tmp_path, monkeypatch):
    """A break after the first batch: the producer gives up its put on the
    full queue, and it and its pool are gone after a short join."""
    monkeypatch.setattr(twindows, "READER_PREFETCH", 1)
    wav = tmp_path / "long.wav"
    make_speechlike_wav(wav, duration_secs=120.0, seed=2)
    ds = FixedSegmentationDatasetNoTarget(wav, 20.0, 1)
    ds.fixed_length_segmentation(0)
    assert _wait_for_no_reader() == []
    loader = BatchIterator(ds, 1, 20.0)
    for _ in loader:
        assert _reader_threads()  # the reader is running
        break
    assert _wait_for_no_reader() == []
    # an exception in the consumer's loop body abandons it the same way
    with pytest.raises(KeyError):
        for _ in BatchIterator(ds, 1, 20.0):
            raise KeyError("consumer")
    assert _wait_for_no_reader() == []


class _Failing:
    """A dataset whose fifth example cannot be read."""

    def __len__(self):
        return 8

    def __getitem__(self, idx):
        if idx == 4:
            raise OSError(f"unreadable window {idx}")
        return np.full(16000, 0.1, np.float32), None, 0, 49


def test_reader_exception_reaches_the_consumer():
    got = []
    with pytest.raises(OSError, match="unreadable window 4"):
        for batch in BatchIterator(_Failing(), 2, 1.0):
            got.append(batch)
    assert len(got) == 2  # the batches before the failing one arrived
    assert _wait_for_no_reader() == []
