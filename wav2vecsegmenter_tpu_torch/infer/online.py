"""Online (streaming) segmentation: commit segments while audio arrives.

Counterpart of ``wav2vecsegmenter_tpu/infer/online.py``.
:class:`OnlineSegmenter` accepts 16 kHz samples incrementally, runs the
encoder on fixed-length windows as soon as they fill (batch 1), and drives
the incremental cores the offline entry points use
(:class:`~..algorithms.strm.StreamingSTRM`,
:class:`~..algorithms.pthr.StreamingPTHR` + ``StreamingMA``), so committed
boundaries match an offline run over the same per-window probabilities
exactly.  :class:`MultiStreamSegmenter` serves many streams through one
engine, batching their filled windows.

The engine is a :class:`~.pipeline.WindowInference`; its ``run_batch``
returns a handle whose ``numpy()`` waits for the batch's probabilities, so
a round of batches is dispatched to the card before any is read back.

Latency model: a boundary commits once (a) its encoder window has filled
(window_secs of buffering) and (b) the algorithm's bounded lookahead is
satisfied — a full ``max_segment_length`` chunk for pSTRM, at most
``max_segment_length`` + 1 frames past a segment start for pTHR.  Both are
constants independent of stream length.

Normalization note: each window normalizes over its own length (a batch-1
collate), which is the reference semantics for batch_size=1; offline runs
with larger batches normalize tail windows over the batch-max length
instead.
"""

from __future__ import annotations

import numpy as np

from ..algorithms.pthr import StreamingMA, StreamingPTHR, build_thresholds
from ..algorithms.segment import Segment
from ..algorithms.strm import StreamingSTRM
from ..constants import TARGET_SAMPLE_RATE, WAV2VEC_FRAME_LEN
from ..core.frames import inframes_to_outframes, secs_to_inframes
from ..data.collate import collate, out_len_for
from .pipeline import WindowInference

_FRAME_LEN = WAV2VEC_FRAME_LEN / 1000


class OnlineSegmenter:
    """Feed samples, receive finalized speech segments incrementally.

    Usage::

        seg = OnlineSegmenter(engine, algorithm="pthr", threshold=0.1,
                              moving_average_window=0.1)
        for chunk in audio_source:          # arbitrary chunk sizes
            for s in seg.feed(chunk):
                ...                         # committed Segment
        tail = seg.finish()                 # flush final partial window

    ``engine`` is a :class:`WindowInference` built from a trained SFC model
    (the object the offline CLIs use).  ``algorithm`` is ``"strm"`` or
    ``"pthr"`` (the reference's two causal algorithms; pDAC needs the whole
    talk and stays offline-only).
    """

    def __init__(
        self,
        engine: WindowInference,
        segment_length: float = 20,
        algorithm: str = "strm",
        max_segment_length: float = 18,
        min_segment_length: float = 0.2,
        min_pause_length: float = 0.2,
        threshold: float = 0.5,
        max_lerp_range: float = 0,
        min_lerp_range: float = 0,
        moving_average_window: float = 0,
        hop_secs: float | None = None,
        lookahead_secs: float | None = None,
    ):
        self.engine = engine
        self.window_inframes = int(secs_to_inframes(segment_length))
        self.out_len = out_len_for(self.window_inframes)
        self.threshold = threshold
        self.algorithm = algorithm
        # Low-latency hop mode (the serving lag/quality knob): instead of
        # waiting for a full window (up to segment_length of buffering lag),
        # re-run the encoder every ``hop_secs`` over the TRAILING
        # segment_length of audio and commit only frames older than
        # ``lookahead_secs`` — every committed frame then has at least
        # lookahead_secs of right context (the tumbling default gives its
        # last frames none) at a compute cost of ~segment_length/hop_secs
        # forwards per audio second.  Encoder buffering lag drops from
        # <= segment_length to <= hop_secs + lookahead_secs; the algorithm
        # core's own bounded lookahead is unchanged.  Probabilities differ
        # from an offline run (different window grid + per-window
        # normalization); how far the committed boundaries move is not
        # measured yet (ROADMAP A10(b)).
        self.hop_inframes = None
        self.lookahead_out = 0
        if hop_secs is not None:
            if not 0 < hop_secs <= segment_length:
                raise ValueError("hop_secs must be in (0, segment_length]")
            if lookahead_secs is None:
                lookahead_secs = (segment_length - hop_secs) / 2
            if lookahead_secs < 0 or hop_secs + lookahead_secs > segment_length:
                raise ValueError(
                    "need hop_secs + lookahead_secs <= segment_length (a "
                    "committed frame must lie inside the current window)")
            self.hop_inframes = int(secs_to_inframes(hop_secs))
            self.lookahead_out = int(lookahead_secs / _FRAME_LEN)
            self._recv = 0            # absolute samples received
            self._buf_start = 0       # absolute index of _pending[0]
            self._next_hop_at = self.hop_inframes
            self._fed_out = 0         # output frames already fed to the core
        max_steps = int(max_segment_length / _FRAME_LEN)
        min_steps = int(min_segment_length / _FRAME_LEN)
        if algorithm == "strm":
            self._core = StreamingSTRM(
                max_steps, min_steps, int(min_pause_length / _FRAME_LEN))
            self._ma = None
        elif algorithm == "pthr":
            thresholds = build_thresholds(
                max_steps, min_steps,
                int(max_lerp_range / _FRAME_LEN),
                int(min_lerp_range / _FRAME_LEN),
                threshold,
            )
            self._core = StreamingPTHR(thresholds, threshold)
            self._ma = (StreamingMA(int(moving_average_window / _FRAME_LEN))
                        if moving_average_window > 0 else None)
        else:
            raise NotImplementedError(
                f"online algorithm '{algorithm}' (strm/pthr are causal; "
                "dac needs the whole talk)")
        self._minu = TARGET_SAMPLE_RATE * 0.06  # 0.06 s expansion, frames
        self._pending = np.zeros(0, np.float32)
        self._consumed_inframes = 0  # absolute sample index of _pending[0]
        self._out_head = 0  # absolute output-frame index fed to the core
        self._segments: list[Segment] = []
        self._finished = False

    # ------------------------------------------------------------------
    def feed(self, samples: np.ndarray) -> list[Segment]:
        """Consume samples; returns segments finalized by this call."""
        self._buffer(samples)
        out: list[Segment] = []
        for example, meta in self._pop_jobs():
            out.extend(self._run_job(example, meta))
        return out

    def _buffer(self, samples: np.ndarray) -> None:
        """Append samples without running any windows (MultiStream path)."""
        assert not self._finished, "feed() after finish()"
        samples = np.asarray(samples, np.float32)
        if samples.ndim != 1:
            raise ValueError("feed expects a mono 1-D float array")
        if len(samples):
            self._pending = np.concatenate([self._pending, samples])
            if self.hop_inframes is not None:
                self._recv += len(samples)

    def _pop_windows(self) -> list[np.ndarray]:
        """Pop every full window currently buffered, in stream order."""
        wins: list[np.ndarray] = []
        while len(self._pending) >= self.window_inframes:
            wins.append(self._pending[: self.window_inframes])
            self._pending = self._pending[self.window_inframes:]
        return wins

    def _pop_jobs(self) -> list[tuple]:
        """Every encoder job currently runnable: [(collate example, meta)].
        Tumbling mode pops full windows; hop mode pops one trailing-window
        job per elapsed hop."""
        if self.hop_inframes is None:
            return [self._tumble_job(w) for w in self._pop_windows()]
        jobs = []
        while self._recv >= self._next_hop_at:
            win_end = self._next_hop_at
            win_start = max(0, win_end - self.window_inframes)
            a = win_start - self._buf_start
            window = np.array(self._pending[a: win_end - self._buf_start])
            start_out = int(inframes_to_outframes(win_start))
            end_out = int(inframes_to_outframes(win_end))
            commit_until = max(self._fed_out,
                               end_out - self.lookahead_out)
            jobs.append(((window, None, 0, end_out - start_out),
                         ("hop", start_out, commit_until)))
            self._next_hop_at += self.hop_inframes
        # drop history the next window can no longer reach
        keep_from = max(0, self._next_hop_at - self.window_inframes)
        if keep_from > self._buf_start:
            self._pending = self._pending[keep_from - self._buf_start:]
            self._buf_start = keep_from
        return jobs

    def _tumble_job(self, window: np.ndarray) -> tuple:
        example, end_out = self._window_example(window)
        return example, ("tumble", end_out)

    def _apply_probs(self, probs: np.ndarray, meta: tuple) -> list[Segment]:
        """Feed one job's probabilities to the algorithm core.  Hop jobs
        commit only the window's frames in [fed, commit_until) — committed
        once, each with >= lookahead_secs of right context."""
        if meta[0] == "tumble":
            return self._apply_window(probs, meta[1])
        _, start_out, commit_until = meta
        lo = self._fed_out - start_out
        hi = commit_until - start_out
        if hi <= lo:
            return []
        feed = probs[max(lo, 0): hi]
        if lo < 0:
            # 49.95 Hz rounding can leave a frame between the previous
            # commit and this window's start; backfill with the window's
            # first prediction (same spirit as the stitch's NaN fill)
            feed = np.concatenate([np.repeat(probs[:1], -lo), feed])
        self._fed_out = commit_until
        return self._apply_window(feed, commit_until)

    def finish(self) -> list[Segment]:
        """Flush the final partial window and the algorithm core; returns
        the remaining segments.  ``segments`` then holds the full list."""
        assert not self._finished, "finish() called twice"
        out: list[Segment] = []
        if self.hop_inframes is not None:
            win_end = self._recv
            win_start = max(0, win_end - self.window_inframes)
            start_out = int(inframes_to_outframes(win_start))
            end_out = int(inframes_to_outframes(win_end))
            if end_out > self._fed_out and end_out > start_out:
                a = win_start - self._buf_start
                window = np.array(self._pending[a: win_end - self._buf_start])
                # final flush commits through the end (no lookahead left)
                out.extend(self._run_job(
                    (window, None, 0, end_out - start_out),
                    ("hop", start_out, end_out)))
            self._pending = np.zeros(0, np.float32)
        elif len(self._pending):
            out.extend(self._run_window(self._pending))
            self._pending = np.zeros(0, np.float32)
        out.extend(self._commit(self._core.flush()))
        self._finished = True
        # clamp the trailing 0.06 s expansion to the true stream length —
        # offline clamps every segment (get_segments: total; pthr walk:
        # total-1) but only trailing ones can exceed
        clamp = (self._out_head if self.algorithm == "strm"
                 else self._out_head - 1)
        for s in reversed(self._segments):
            if s.end > clamp:
                s.end = clamp
            else:
                break
        return out

    @property
    def segments(self) -> list[Segment]:
        return list(self._segments)

    # ------------------------------------------------------------------
    # Per-window steps, split so MultiStreamSegmenter can batch the engine
    # call across streams while reusing the exact same clock/core logic.

    def _window_example(self, window: np.ndarray):
        """Advance the input clock; returns (collate example, end_out)."""
        start_in = self._consumed_inframes
        end_in = start_in + len(window)
        self._consumed_inframes = end_in
        start_out = int(inframes_to_outframes(start_in))
        end_out = int(inframes_to_outframes(end_in))
        return (window, None, 0, end_out - start_out), end_out

    @staticmethod
    def _row_probs(batch, raw_row, i: int, n_out: int) -> np.ndarray:
        """Exactly n_out usable probabilities from collated row ``i``.

        The absolute frame clock advances by n_out per window, so EXACTLY
        n_out frames must reach the core.  The usable frames are
        min(collate's span, the raw row width): collate's -1 correction can
        under-shoot the estimate, and for long windows (fractional 49.95 Hz
        accumulating past one frame) the conv output can exceed the row's
        out_len columns."""
        if not batch.included[i]:
            # silent window: the offline stitch writes prob 0 for excluded
            # rows (pipeline.stitch_row), i.e. below any threshold
            return np.zeros(n_out, np.float32)
        raw_row = np.asarray(raw_row)
        valid = min(int(batch.ends[i] - batch.starts[i]), len(raw_row), n_out)
        if valid <= 0:
            # degenerate sub-frame window: nothing usable — feed silence
            # like the excluded-row path
            return np.zeros(n_out, np.float32)
        probs = raw_row[:valid]
        if valid < n_out:
            # repeat the final prediction so the frame clock stays aligned
            # (same spirit as the offline stitch's NaN fill)
            probs = np.concatenate(
                [probs, np.repeat(probs[-1:], n_out - valid)])
        return probs

    def _apply_window(self, probs: np.ndarray, end_out: int) -> list[Segment]:
        """Feed one window's probabilities to the algorithm core."""
        self._out_head = end_out
        if self.algorithm == "strm":
            feed = (probs > self.threshold).astype(np.int8)
        else:
            feed = self._ma.feed(probs) if self._ma is not None else probs
        return self._commit(self._core.feed(feed))

    def _run_window(self, window: np.ndarray) -> list[Segment]:
        return self._run_job(*self._tumble_job(window))

    def _run_job(self, example: tuple, meta: tuple) -> list[Segment]:
        n_out = example[3]
        batch = collate(
            [example],
            batch_size=1,
            audio_len=self.window_inframes,
            out_len=self.out_len,
        )
        if not batch.included[0]:
            probs = np.zeros(n_out, np.float32)
        else:
            raw = self.engine.run_batch(batch).numpy()
            probs = self._row_probs(batch, raw[0], 0, n_out)
        return self._apply_probs(probs, meta)

    def _commit(self, spans) -> list[Segment]:
        new: list[Segment] = []
        for span in spans:
            if self.algorithm == "strm":
                s, e, is_speech = span
                if not is_speech:
                    continue
            else:
                s, e = span  # inclusive walk end, expanded the same way
            seg = Segment(max(0, s - self._minu), e + self._minu)
            self._segments.append(seg)
            new.append(seg)
        return new


class MultiStreamSegmenter:
    """Serve many concurrent audio streams through ONE batched engine.

    A batch-1 forward leaves most of the card idle; real deployments serve
    many streams at once.  This multiplexer holds one
    :class:`OnlineSegmenter` state per stream and, on every :meth:`feed`
    call, runs all streams' newly filled windows through the engine in
    batches of up to ``max_batch`` windows, padded to the next power of
    two: the kernels see at most log2(max_batch)+1 batch shapes (1, 2, 4,
    8 by default), and cuDNN autotunes the positional conv once for each.
    Every batch of a feed round is dispatched before any is read back, so
    uploads and host work overlap the card's compute.

    Committed segments are those of one :class:`OnlineSegmenter` per
    stream wherever a row's probabilities do not depend on the batch it
    runs in: full windows all share ``segment_length`` samples, so the
    reference's batch-max normalization sees identical statistics
    regardless of batching, and windows are grouped by their output span
    before batching so collate's batch-level ±1-frame correction
    (lib/evaluate.py:62-68 semantics) cannot couple streams whose
    fractional 49.95 Hz clocks disagree (e.g. 699- vs 700-frame windows at
    segment_length=14).  Final partial windows flush batch-1 through the
    stream's own :meth:`OnlineSegmenter.finish`.

    Usage::

        mux = MultiStreamSegmenter(engine, algorithm="pthr", threshold=0.1)
        mux.add_stream("a"); mux.add_stream("b")
        done = mux.feed({"a": chunk_a, "b": chunk_b})  # {sid: [Segment]}
        tail_a = mux.finish("a")
    """

    def __init__(self, engine: WindowInference, max_batch: int = 8,
                 **stream_kwargs):
        self.engine = engine
        self.max_batch = int(max_batch)
        assert self.max_batch >= 1
        self._stream_kwargs = stream_kwargs
        self._streams: dict = {}

    # ------------------------------------------------------------------
    def add_stream(self, sid, **overrides) -> None:
        """Register a stream; ``overrides`` adjust the algorithm per stream
        (the encoder is algorithm-independent, so mixed-algorithm streams
        still batch together).  ``segment_length`` is the shared window
        shape and cannot differ per stream."""
        if sid in self._streams:
            raise ValueError(f"stream {sid!r} already exists")
        if "segment_length" in overrides:
            raise ValueError(
                "segment_length is shared by all streams of a "
                "MultiStreamSegmenter (one window shape)")
        self._streams[sid] = OnlineSegmenter(
            self.engine, **{**self._stream_kwargs, **overrides})

    def stream(self, sid) -> OnlineSegmenter:
        return self._streams[sid]

    def segments(self, sid) -> list[Segment]:
        return self._streams[sid].segments

    # ------------------------------------------------------------------
    def feed(self, chunks: dict) -> dict:
        """Buffer per-stream samples, then run every filled window across
        all streams in batched forwards.  Returns {sid: [Segment]} with the
        segments each stream finalized this round (sids with none are
        omitted).  Unknown sids are added automatically."""
        for sid, samples in chunks.items():
            if sid not in self._streams:
                self.add_stream(sid)
            self._streams[sid]._buffer(samples)

        # jobs in per-stream chronological order
        jobs = []  # (sid, stream, example, meta)
        for sid in chunks:
            st = self._streams[sid]
            for example, meta in st._pop_jobs():
                jobs.append((sid, st, example, meta))

        out: dict = {}
        if jobs:
            probs = self._batched_probs([ex for _, _, ex, _ in jobs])
            for (sid, st, _ex, meta), p in zip(jobs, probs):
                segs = st._apply_probs(p, meta)
                if segs:
                    out.setdefault(sid, []).extend(segs)
        return out

    def finish(self, sid) -> list[Segment]:
        """Flush one stream (final partial window batch-1 + core flush)."""
        return self._streams[sid].finish()

    def finish_all(self) -> dict:
        return {sid: st.finish() for sid, st in self._streams.items()
                if not st._finished}

    # ------------------------------------------------------------------
    def _batched_probs(self, examples: list) -> list[np.ndarray]:
        """Probabilities for each example, batching engine calls.

        Groups by output span (collate's ±1 correction is batch-level),
        slabs each group at <= max_batch windows, dispatches every slab
        before collecting any."""
        groups: dict[int, list[int]] = {}
        for i, example in enumerate(examples):
            groups.setdefault(example[3], []).append(i)

        any_st = next(iter(self._streams.values()))
        audio_len = any_st.window_inframes
        out_len = any_st.out_len

        slabs = []  # (idxs, batch, handle | None)
        for idxs in groups.values():
            for k in range(0, len(idxs), self.max_batch):
                part = idxs[k: k + self.max_batch]
                rows = [examples[i] for i in part]
                slots = 1 << (len(part) - 1).bit_length()
                batch = collate(rows, batch_size=slots,
                                audio_len=audio_len, out_len=out_len)
                # an all-silent slab does no device work
                handle = (self.engine.run_batch(batch)
                          if batch.included.any() else None)
                slabs.append((part, batch, handle))

        result: list = [None] * len(examples)
        for part, batch, handle in slabs:
            raw = None if handle is None else handle.numpy()
            for row, i in enumerate(part):
                n_out = examples[i][3]
                if raw is None:
                    result[i] = np.zeros(n_out, np.float32)
                else:
                    result[i] = OnlineSegmenter._row_probs(
                        batch, raw[row], row, n_out)
        return result
