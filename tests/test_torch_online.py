"""The port's online segmenters (``infer/online.py``) against the JAX
package's on the same weights and audio: ``OnlineSegmenter`` (pSTRM and
pTHR + moving average; tumbling and hop mode; fed in one piece or in
chunks) and ``MultiStreamSegmenter`` (equal to one segmenter per stream,
with a silent window and the 699/700-frame spans of 14 s windows) commit
the segments the JAX ones commit.  The JAX engine runs its XLA path in
float32, the port's engine float32 on the CPU.  After tests/test_online.py.
"""

import numpy as np
import pytest
import torch

from wav2vecsegmenter_tpu.infer import online as jonline
from wav2vecsegmenter_tpu.infer import pipeline as jpipe
from wav2vecsegmenter_tpu.ops.backend import set_backend
from wav2vecsegmenter_tpu_torch.core.frames import inframes_to_outframes
from wav2vecsegmenter_tpu_torch.infer import online as tonline
from wav2vecsegmenter_tpu_torch.infer import pipeline as tpipe

from .torch_tiny import threads_per_worker, tiny_pair  # noqa: F401

STRM = dict(algorithm="strm", max_segment_length=3, min_segment_length=0.2,
            min_pause_length=0.2, threshold=0.5)
PTHR = dict(algorithm="pthr", max_segment_length=2.5, min_segment_length=0.2,
            threshold=0.5, moving_average_window=0.1)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(JAX engine, port engine) on one set of weights; the JAX package's
    XLA path for the module's duration."""
    jm, params, model = tiny_pair(tmp_path_factory.mktemp("online") / "c.pt")
    set_backend("xla")
    yield (jpipe.WindowInference(jm, params),
           tpipe.WindowInference(model, "cpu", torch.float32))
    set_backend("auto")


def _wav(seed: int, secs: float, period: int = 32000) -> np.ndarray:
    rng = np.random.RandomState(seed)
    n = int(secs * 16000)
    return (rng.randn(n).astype(np.float32) * 0.1
            * ((np.arange(n) % period) < period * 3 // 4))


def _run(cls, engine, wav, chunks, **kw):
    seg = cls(engine, **kw)
    got = []
    for i in range(0, len(wav), chunks):
        got.extend(seg.feed(wav[i: i + chunks]))
    n_before_finish = len(got)
    got.extend(seg.finish())
    assert [(s.offset, s.duration) for s in got] == [
        (s.offset, s.duration) for s in seg.segments]
    return [(s.offset, s.duration) for s in got], n_before_finish


@pytest.mark.parametrize("algo,seg_len,secs", [
    (STRM, 4.0, 19.3),
    # 14 s windows: 699- and 700-frame spans, collate's -1 correction
    (STRM, 14.0, 45.2),
    (PTHR, 4.0, 14.6),
])
def test_online_segmenter_commits_as_jax(engines, algo, seg_len, secs):
    wav = _wav(7, secs)
    wav[int(2 * seg_len * 16000): int(3 * seg_len * 16000)] = 0.0  # silent
    want, _ = _run(jonline.OnlineSegmenter, engines[0], wav, 37000,
                   segment_length=seg_len, **algo)
    got, early = _run(tonline.OnlineSegmenter, engines[1], wav, 37000,
                      segment_length=seg_len, **algo)
    assert got == want and len(got) > 0
    assert early > 0  # segments committed before finish()


@pytest.mark.parametrize("algo", [STRM, PTHR])
@pytest.mark.parametrize("hop", [dict(hop_secs=4, lookahead_secs=0),
                                 dict(hop_secs=1, lookahead_secs=1)])
def test_hop_mode_commits_as_jax(engines, algo, hop):
    wav = _wav(11, 13.0)
    want, _ = _run(jonline.OnlineSegmenter, engines[0], wav, 16000,
                   segment_length=4, **algo, **hop)
    got, _ = _run(tonline.OnlineSegmenter, engines[1], wav, 16000,
                  segment_length=4, **algo, **hop)
    assert got == want and len(got) > 0
    if hop["hop_secs"] == 4 and algo is STRM:
        # a full hop runs the tumbling grid (tests/test_online.py); the
        # final flush differs (a trailing full window), which pTHR's tail
        # sees
        tumbling, _ = _run(tonline.OnlineSegmenter, engines[1], wav, 16000,
                           segment_length=4, **algo)
        assert got == tumbling


def test_single_shot_equals_chunked(engines):
    wav = _wav(9, 11.7, period=16000)
    kw = dict(segment_length=4.0, max_segment_length=3)
    one, _ = _run(tonline.OnlineSegmenter, engines[1], wav, len(wav), **kw)
    many, _ = _run(tonline.OnlineSegmenter, engines[1], wav, 13000, **kw)
    assert one == many and len(one) > 0


class _CountingEngine:
    """Delegates run_batch, recording each batch's rows and audio."""

    def __init__(self, engine):
        self._engine = engine
        self.batches = []

    def run_batch(self, batch):
        self.batches.append(batch)
        return self._engine.run_batch(batch)


def _mux(cls, engine, wavs, steps, seg_len, **kw):
    """Per-stream segments of a multiplexer fed at a different rate per
    stream."""
    mux = cls(engine, max_batch=4, segment_length=seg_len, **kw)
    pos = [0] * len(wavs)
    while any(p < len(w) for p, w in zip(pos, wavs)):
        chunks = {}
        for k, w in enumerate(wavs):
            if pos[k] < len(w):
                chunks[k] = w[pos[k]: pos[k] + steps[k]]
                pos[k] += steps[k]
        mux.feed(chunks)
    mux.finish_all()
    return [[(s.offset, s.duration) for s in mux.segments(k)]
            for k in range(len(wavs))]


@pytest.mark.parametrize("algo", [STRM, PTHR])
def test_multistream_equals_single_streams_and_jax(engines, algo):
    seg_len = 4.0
    wavs = [_wav(23 + k, secs, 16000 + 4000 * k)
            for k, secs in enumerate((18.7, 13.2, 21.0))]
    wavs[0][int(seg_len * 16000): int(2 * seg_len * 16000)] = 0.0
    steps = [int(f * seg_len * 16000) for f in (1.3, 0.7, 2.1)]
    single = [_run(tonline.OnlineSegmenter, engines[1], w, len(w),
                   segment_length=seg_len, **algo)[0] for w in wavs]
    jcount, tcount = (_CountingEngine(e) for e in engines)
    want = _mux(jonline.MultiStreamSegmenter, jcount, wavs, steps, seg_len,
                **algo)
    got = _mux(tonline.MultiStreamSegmenter, tcount, wavs, steps, seg_len,
               **algo)
    assert got == single == want and all(got)
    # the same batches, padded to the same power-of-two slots, collated
    # alike; at least one ran several windows
    assert len(tcount.batches) == len(jcount.batches)
    for a, b in zip(tcount.batches, jcount.batches):
        np.testing.assert_array_equal(a.audio, b.audio)
        np.testing.assert_array_equal(a.out_mask, b.out_mask)
        assert a.n_real == b.n_real
    assert max(b.n_real for b in tcount.batches) > 1


def test_multistream_groups_fractional_spans(engines):
    """At segment_length=14 windows span 699 or 700 frames; streams at
    different window indices batch apart, so each equals its single
    stream."""
    seg_len = 14.0
    wavs = [_wav(31, 43.1, 16000), _wav(32, 57.4, 20000)]
    single = [_run(tonline.OnlineSegmenter, engines[1], w, len(w),
                   segment_length=seg_len, **STRM)[0] for w in wavs]
    seen = []

    class SpyMux(tonline.MultiStreamSegmenter):
        def _batched_probs(self, examples):
            seen.append({ex[3] for ex in examples})
            return super()._batched_probs(examples)

    W = int(seg_len * 16000)
    mux = SpyMux(engines[1], max_batch=4, segment_length=seg_len, **STRM)
    mux.feed({1: wavs[1][: 2 * W]})  # stream 1 runs two windows ahead
    pos, step = [0, 2 * W], int(1.5 * W)
    while any(p < len(w) for p, w in zip(pos, wavs)):
        mux.feed({k: w[pos[k]: pos[k] + step]
                  for k, w in enumerate(wavs) if pos[k] < len(w)})
        pos = [p + step for p in pos]
    mux.finish_all()
    got = [[(s.offset, s.duration) for s in mux.segments(k)]
           for k in range(2)]
    assert got == single and all(got)
    assert any(spans == {699, 700} for spans in seen), seen


def test_hop_mode_multistream_equals_single(engines):
    kw = dict(PTHR, threshold=0.4, hop_secs=2, lookahead_secs=1)
    wavs = [_wav(13 + k, 12.0, 32000 + 1600 * k) for k in range(3)]
    single = [_run(tonline.OnlineSegmenter, engines[1], w, 16000,
                   segment_length=4, **kw)[0] for w in wavs]
    got = _mux(tonline.MultiStreamSegmenter, engines[1], wavs, [16000] * 3,
               4, **kw)
    assert got == single and all(got)


def test_frame_clock_robust_to_short_rows():
    """Exactly n_out frames reach the core per window when the model's row
    is shorter than the window's span, and for a sub-frame final window."""

    class ShortRows:
        def numpy(self):
            return np.full((1, 3), 0.9, np.float32)

    class ShortRowEngine:
        def run_batch(self, batch):
            return ShortRows()

    seg = tonline.OnlineSegmenter(ShortRowEngine(), segment_length=14.0,
                                  **dict(STRM, max_segment_length=2.0))
    fed = []
    real_feed = seg._core.feed
    seg._core.feed = lambda arr: (fed.append(len(arr)), real_feed(arr))[1]
    W = seg.window_inframes
    rng = np.random.RandomState(0)
    for _ in range(3):
        seg.feed((rng.randn(W) * 0.1 + 0.5).astype(np.float32))
    seg.feed(np.full(300, 0.5, np.float32))  # a sub-frame tail
    seg.finish()
    assert sum(fed) == int(inframes_to_outframes(3 * W + 300)) \
        == seg._out_head


def test_hop_validation_and_dac_refusal(engines):
    engine = engines[1]
    with pytest.raises(ValueError, match="hop_secs"):
        tonline.OnlineSegmenter(engine, segment_length=4, hop_secs=5)
    with pytest.raises(ValueError, match="lookahead"):
        tonline.OnlineSegmenter(engine, segment_length=4, hop_secs=2,
                                lookahead_secs=3)
    with pytest.raises(NotImplementedError, match="dac"):
        tonline.OnlineSegmenter(engine, algorithm="dac")
    mux = tonline.MultiStreamSegmenter(engine)
    with pytest.raises(ValueError, match="segment_length"):
        mux.add_stream("a", segment_length=8)
