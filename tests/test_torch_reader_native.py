"""The port's input path against the JAX package's.

* Window reads: the port's ``data/audio.py`` reads through its native
  loader (``data/native_audio.py``, ``native/audio/wav_loader.cpp``) and
  must equal the JAX module's stdlib ``wave`` route at sample widths 1, 2
  and 4, mono and stereo, offsets at the start, the middle and past the
  end, and ``num_frames=None``; where the loader alone answers otherwise
  (ROADMAP C26), the port takes the stdlib's route.
* A data mesh's ranks read only their rows (``data.windows.LocalBatch``):
  each rank's batches equal, bitwise, the rows ``parallel.mesh.local_rows``
  cuts from the one-rank batches, for the random training generator, the
  fixed grid (with the remainder ladder), the CTC and autoregressive
  collations and the inference windows; a rank's dataset reads its rows'
  windows and no other.  On gloo ranks (``data=2``): the generators, the
  ``segment_wavs`` sweep (probabilities within the port's float32 model
  tolerance of one rank's, the yaml within tests/test_packing.py's row
  bounds), and frozen micro-steps fed a rank's rows equal those fed the
  whole batches.
"""

import dataclasses
import json
import shutil
import wave

import numpy as np
import pandas as pd
import pytest
import torch

from wav2vecsegmenter_tpu.data import audio as jaudio
from wav2vecsegmenter_tpu_torch.cli.common import segment_wavs
from wav2vecsegmenter_tpu_torch.core import runtime
from wav2vecsegmenter_tpu_torch.data import audio as taudio
from wav2vecsegmenter_tpu_torch.data import datasets as tdatasets
from wav2vecsegmenter_tpu_torch.data import loader as tloader
from wav2vecsegmenter_tpu_torch.data import native_audio
from wav2vecsegmenter_tpu_torch.data import vocab as tvocab
from wav2vecsegmenter_tpu_torch.data.windows import (
    BatchIterator, FixedSegmentationDatasetNoTarget, LocalAutoRegBatch,
    LocalBatch)
from wav2vecsegmenter_tpu_torch.models.wav2vec2 import init_from_numpy

from .helpers import make_speechlike_wav
from .torch_mesh_worker import build
from .torch_tiny import threads_per_worker  # noqa: F401

FRAMES = 5003  # an odd count: the last window of a read is partial
PROBS_ATOL = 2e-4  # tests/test_torch_precision.py: the port's model tolerance
ROW_OFFSET_S, ROW_DURATION_S = 0.06, 0.12  # tests/test_packing.py's bounds
PTHR = {"tag": "pthr", "max_segment_length": 28, "min_segment_length": 0.2,
        "max_lerp_range": 4, "min_lerp_range": 0.4, "threshold": 0.1,
        "moving_average_window": 0.1}


def _write_pcm(path, width: int, channels: int, seed: int = 0) -> None:
    rng = np.random.RandomState(seed + 10 * width + channels)
    n = FRAMES * channels
    if width == 1:
        raw = rng.randint(0, 256, n).astype(np.uint8)
    elif width == 2:
        raw = rng.randint(-32768, 32768, n).astype("<i2")
    else:
        raw = rng.randint(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype("<i4")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(width)
        f.setframerate(16000)
        f.writeframes(raw.tobytes())


def _answer(read, *args):
    """``read(*args)``, or the exception it raises as (type, message)."""
    try:
        return read(*args)
    except Exception as e:  # noqa: BLE001 - the answer is what is compared
        return (type(e), str(e))


def _assert_same(got, want, what):
    if isinstance(want, tuple):
        assert got == want, what
    else:
        assert isinstance(got, np.ndarray), (what, got)
        assert got.dtype == want.dtype, what
        np.testing.assert_array_equal(got, want, err_msg=str(what))


# (offset, num_frames): the start, the middle, the last partial stretch,
# the end, past the end, and nothing asked
READS = [(0, None), (0, 1), (0, FRAMES), (2500, 1000), (2500, None),
         (4990, 100), (FRAMES, None), (FRAMES, 10), (FRAMES + 700, None),
         (FRAMES + 700, 10), (2500, 0)]


@pytest.mark.parametrize("channels", [1, 2], ids=["mono", "stereo"])
@pytest.mark.parametrize("width", [1, 2, 4])
def test_reads_equal_the_jax_stdlib_route(tmp_path, monkeypatch, width,
                                          channels):
    """The port's wav_info, read_wav_window and WaveformCache against the
    JAX module's stdlib route, read by read (an exception's type and
    message too)."""
    monkeypatch.setattr(jaudio, "_native", False)
    path = tmp_path / f"w{width}c{channels}.wav"
    _write_pcm(path, width, channels)
    assert taudio.wav_info(path) == jaudio.wav_info(path) \
        == (FRAMES, 16000, channels)
    for offset, n in READS:
        _assert_same(_answer(taudio.read_wav_window, path, offset, n),
                     _answer(jaudio.read_wav_window, path, offset, n),
                     (offset, n))
    ours, theirs = taudio.WaveformCache(1), jaudio.WaveformCache(1)
    np.testing.assert_array_equal(ours.full(path), theirs.full(path))
    np.testing.assert_array_equal(ours.window(path, 7, 900),
                                  theirs.window(path, 7, 900))


def test_loader_alone_differs_where_the_port_routes_to_wave(tmp_path,
                                                           monkeypatch):
    """ROADMAP C26: the native loader's own answers that are not the
    stdlib's, and the port's, which are.  Widths 1 and 4 (the loader
    refuses them), a start past the end (it returns nothing, the stdlib
    raises), a negative offset (it clamps to 0) or frame count (it reads
    to the end), and an IEEE float file (it reports a header the stdlib
    refuses)."""
    monkeypatch.setattr(jaudio, "_native", False)
    assert native_audio.available()
    for width in (1, 4):
        path = tmp_path / f"w{width}.wav"
        _write_pcm(path, width, 1)
        with pytest.raises(OSError):
            native_audio.read_window(str(path), 0, 10)
        _assert_same(taudio.read_wav_window(path, 0, 10),
                     jaudio.read_wav_window(path, 0, 10), width)
    path = tmp_path / "w2.wav"
    _write_pcm(path, 2, 1)
    for offset, n in ((FRAMES + 700, 10), (-5, 10), (100, -1)):
        loader = native_audio.read_window(str(path), offset, n)
        want = _answer(jaudio.read_wav_window, path, offset, n)
        assert isinstance(want, tuple) or len(loader) != len(want)
        _assert_same(_answer(taudio.read_wav_window, path, offset, n), want,
                     (offset, n))
    # a float32 (format 3) header: the stdlib knows no such format
    floats = tmp_path / "f32.wav"
    data = np.zeros(100, "<f4").tobytes()
    floats.write_bytes(
        b"RIFF" + (36 + len(data)).to_bytes(4, "little") + b"WAVEfmt "
        + (16).to_bytes(4, "little") + (3).to_bytes(2, "little")
        + (1).to_bytes(2, "little") + (16000).to_bytes(4, "little")
        + (64000).to_bytes(4, "little") + (4).to_bytes(2, "little")
        + (32).to_bytes(2, "little") + b"data"
        + len(data).to_bytes(4, "little") + data)
    assert native_audio.wav_info(str(floats)) == (100, 16000, 1)
    want = _answer(jaudio.wav_info, floats)
    assert isinstance(want, tuple)
    assert _answer(taudio.wav_info, floats) == want


def test_reader_backend_reports_the_route(tmp_path, monkeypatch):
    """``native`` where a C++ compiler builds the loader; ``wave`` when the
    library is missing, whose reads still equal the JAX stdlib route."""
    want = "native" if shutil.which("g++") else "wave"
    assert taudio.reader_backend() == want
    monkeypatch.setattr(native_audio, "_LIB", None)
    monkeypatch.setattr(native_audio, "_TRIED", True)
    monkeypatch.setattr(taudio, "_native", None)
    monkeypatch.setattr(jaudio, "_native", False)
    assert taudio.reader_backend() == "wave"
    path = tmp_path / "a.wav"
    _write_pcm(path, 2, 2)
    np.testing.assert_array_equal(taudio.read_wav_window(path, 30, 4000),
                                  jaudio.read_wav_window(path, 30, 4000))


# ------------------------------------------------------- a rank's rows


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three talks (13.3, 9.1 and 5.2 s) with transcribed true segments,
    as the JAX package's data prep writes them."""
    root = tmp_path_factory.mktemp("reader_native")
    talks, segments = [], []
    for i, secs in enumerate((13.3, 9.1, 5.2)):
        path = root / f"ted_{i}.wav"
        make_speechlike_wav(path, duration_secs=secs, seed=i)
        talks.append({"id": f"ted_{i}", "path": str(path),
                      "total_frames": int(secs * 16000)})
        for j, s0 in enumerate(np.arange(0.2, secs - 1.0, 2.7)):
            segments.append({"talk_id": f"ted_{i}", "start": int(s0 * 16000),
                             "end": int(min(s0 + 2.1, secs) * 16000),
                             "tgt_text": f"talk {i} segment {j}"})
    pd.DataFrame(talks).to_csv(root / "talks.tsv", sep="\t")
    pd.DataFrame(segments).to_csv(root / "segments.tsv", sep="\t")
    return root


def _local_rows(x, n: int, r: int):
    k = x.shape[0] // n
    return x[r * k:(r + 1) * k]


def _assert_rows(whole, part, n: int, r: int):
    """``part`` is rank r's rows of ``whole``, bitwise, and says so."""
    assert isinstance(part, (LocalBatch, LocalAutoRegBatch))
    assert part.global_slots == len(whole.included)
    for f in dataclasses.fields(whole):
        a, b = getattr(whole, f.name), getattr(part, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(_local_rows(a, n, r), b,
                                          err_msg=f.name)
        else:
            assert a == b, f.name


def _generators(root, kind: str, **ranks):
    """Every batch of one loader of ``kind`` on the corpus."""
    talks, segments = str(root / "talks.tsv"), str(root / "segments.tsv")
    if kind == "random":
        return list(tloader.RandomDataloaderGenerator(
            talks, segments, 4, 4, seed=7, **ranks).generate())
    if kind == "windows":
        ds = FixedSegmentationDatasetNoTarget(root / "ted_0.wav", 4.0, 2)
        ds.fixed_length_segmentation(1)
        return list(BatchIterator(ds, 4, 4.0, min_multiple=2, **ranks))
    kw = {"fixed": {}, "ladder": {"remainder_ladder": True},
          "ctc": {"vocab": tvocab.UppercasedCharVocabulary(), "ctc": True},
          "autoreg": {"vocab": tvocab.BaseVocabulary(),
                      "autoregression": True}}[kind]
    gen = tloader.FixedDataloaderGenerator(talks, segments, 4, 4,
                                           inference_times=2, min_multiple=2,
                                           **kw, **ranks)
    return [b for talk in gen.get_talk_ids() + [""] for it in range(2)
            for b in gen.generate(talk, it)]


@pytest.mark.parametrize("kind", ["random", "fixed", "ladder", "ctc",
                                  "autoreg", "windows"])
def test_rank_rows_equal_the_whole_batchs(corpus, kind):
    """Ranks 0 and 1 of ``data=2``: each batch the rows local_rows cuts
    from the one-rank batch, bitwise."""
    whole = _generators(corpus, kind)
    for r in range(2):
        parts = _generators(corpus, kind, n_data=2, data_rank=r)
        assert len(parts) == len(whole)
        for w, p in zip(whole, parts):
            _assert_rows(w, p, 2, r)


def test_rank_rows_cover_the_batch_wide_terms(corpus):
    """The fixed grid's batches hold both audio buckets (a talk's merged
    short tail is longer than the window) and the ladder's right-sized
    remainders; the random epoch a partial last batch, a rank whose rows
    are all shorter than its batch's longest window (its rows normalize
    over the batch's ``norm_length``) and a batch whose ends the +-1 frame
    correction moved."""
    ladder = _generators(corpus, "ladder")
    assert len({b.audio.shape[1] for b in ladder}) == 2
    assert any(len(b.included) < 4 for b in ladder)
    gen = tloader.RandomDataloaderGenerator(
        str(corpus / "talks.tsv"), str(corpus / "segments.tsv"), 4, 4,
        seed=7)
    loader = gen.generate()
    whole = list(loader)
    assert whole[-1].n_real < len(whole[-1].included)
    corrected = False
    for w, idx in zip(whole, loader._index_batches()):
        widest = max(e - s for _, s, e in map(gen.dataset.window_span, idx))
        n = w.n_real
        corrected |= int((w.ends[:n] - w.starts[:n]).max()) < widest
    shorter = False
    for r in range(2):
        for p in _generators(corpus, "random", n_data=2, data_rank=r):
            shorter |= int(p.in_lengths.max()) < p.norm_length
    assert shorter and corrected


def test_a_rank_reads_only_its_windows(corpus, monkeypatch):
    """Each rank's dataset reads its rows' windows of every batch, once,
    and the ranks together read the epoch."""
    seen: list = []
    real = tdatasets._GridDataset.__getitem__

    def counted(self, idx):
        seen.append(int(idx))
        return real(self, idx)

    monkeypatch.setattr(tdatasets._GridDataset, "__getitem__", counted)
    reads = []
    for r in range(2):
        seen.clear()
        loader = tloader.RandomDataloaderGenerator(
            str(corpus / "talks.tsv"), str(corpus / "segments.tsv"), 4, 4,
            seed=7, n_data=2, data_rank=r).generate()
        batches = list(loader)
        want = [int(j) for idx in loader._index_batches()
                for j in idx[2 * r:2 * r + 2]]
        assert sorted(seen) == sorted(want)
        assert len(loader.read_seconds) == len(batches)
        reads.append(set(seen))
    assert not reads[0] & reads[1]
    assert reads[0] | reads[1] == set(range(len(loader.dataset)))


def test_a_batch_that_does_not_split_raises(corpus):
    gen = tloader.RandomDataloaderGenerator(
        str(corpus / "talks.tsv"), str(corpus / "segments.tsv"), 4, 3,
        seed=7, n_data=2, data_rank=0)
    with pytest.raises(ValueError, match="does not split"):
        list(gen.generate())


def _tiny_model():
    model = build("shas", {}, {})
    init_from_numpy(model, seed=0)
    return model.eval()


def _sweep_rows(wavs, r: int) -> list:
    """The windows rank r of ``data=2`` reads in the gloo sweep: its rows
    of each batch of 4 (the ladder's remainders a multiple of 2), both
    passes of each talk."""
    out = []
    for wav in wavs:
        ds = FixedSegmentationDatasetNoTarget(wav, 4.0, 2)
        for it in range(2):
            ds.fixed_length_segmentation(it)
            it_ = BatchIterator(ds, 4, 4.0, n_data=2, data_rank=r)
            out += [int(j) for idx in it_._index_batches()
                    for j in it_._own_rows(idx)]
    return sorted(out)


def test_data_ranks_on_gloo(corpus, tmp_path):
    """Two gloo ranks of ``data=2`` (``core.runtime.launch_ranks``): each
    rank's generator batches are its rows of the one-rank batches and it
    read only their windows; the segment sweep (batch 3 padded to 4, two
    passes, the ladder) stitches probabilities within PROBS_ATOL of the
    one-rank sweep's, on every rank, with yaml rows within the row bounds;
    two frozen micro-steps fed a rank's rows equal those fed the whole
    batches, and the gathered targets and masks are the whole batch's."""
    wavs = [str(corpus / "ted_0.wav"), str(corpus / "ted_1.wav")]
    job = {"talks": str(corpus / "talks.tsv"),
           "segments": str(corpus / "segments.tsv"), "wavs": wavs,
           "algorithm": PTHR}
    ranks = runtime.launch_ranks("tests.torch_reader_ranks:data_ranks",
                                 [json.dumps(job)], 2)["ranks"]
    random = _generators(corpus, "random")
    talks = str(corpus / "talks.tsv"), str(corpus / "segments.tsv")
    fixed = tloader.FixedDataloaderGenerator(*talks, 4, 4, inference_times=2,
                                             remainder_ladder=True,
                                             min_multiple=2)
    fixed_batches = [list(fixed.generate(t, it))
                     for t in fixed.get_talk_ids() for it in range(2)]
    probs: dict = {}
    rows = segment_wavs(_tiny_model(), wavs, PTHR, 4, 4.0, 2,
                        torch.device("cpu"), torch.float32, talk_probs=probs)
    loader = tloader.RandomDataloaderGenerator(*talks, 4, 4,
                                               seed=7).generate()
    epoch = loader._index_batches()
    for r, got in enumerate(ranks):
        assert got["ranks"] == {"n_data": 2, "data_rank": r}
        for w, p in zip(random, got["random"], strict=True):
            _assert_rows(w, p, 2, r)
        for talk_w, talk_p in zip(fixed_batches, got["fixed"], strict=True):
            for w, p in zip(talk_w, talk_p, strict=True):
                _assert_rows(w, p, 2, r)
        assert sorted(got["random_reads"]) == sorted(
            int(j) for idx in epoch for j in idx[2 * r:2 * r + 2])
        assert sorted(got["sweep_reads"]) == _sweep_rows(wavs, r)
        assert got["rows"] == ranks[0]["rows"]
        for name, p in probs.items():
            np.testing.assert_allclose(got["probs"][name], p,
                                       atol=PROBS_ATOL, rtol=0)
        for a, b in zip(got["step_rows"], got["step_whole"], strict=True):
            assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
        for run, batch in zip(got["step_rows"], random):
            np.testing.assert_array_equal(run["rows"]["out_mask"],
                                          batch.out_mask)
            np.testing.assert_array_equal(run["rows"]["target"],
                                          batch.target)
    mine = ranks[0]["rows"]
    assert len(mine) == len(rows) > 0
    for a, b in zip(mine, rows):
        assert a["wav"] == b["wav"]
        assert abs(a["offset"] - b["offset"]) <= ROW_OFFSET_S + 1e-9
        assert abs(a["duration"] - b["duration"]) <= ROW_DURATION_S + 1e-9
