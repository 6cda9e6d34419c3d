"""Segmentation datasets with targets: random training grids and fixed
evaluation grids.

Counterpart of ``wav2vecsegmenter_tpu/data/datasets.py``, which reads its
TSVs with pandas; here they are read with the standard ``csv`` module.  The
contracts are the SHAS data prep's (reference lib/dataset.py:36-41):
``talks.tsv`` with an index column and (id, path, total_frames),
``segments.tsv`` with an index column and (talk_id, start, end) in
input-space frames.  Target construction replicates lib/dataset.py:68-144
(per-talk binary frame vector -> per-window (start, end) spans in output
space, with the overlap bump).  Talk ids are kept as strings.  An optional
``tgt_text`` column of ``segments.tsv`` carries the CTC task's transcripts
(JAX ``data/datasets.py``: each window's transcript joins the texts of the
true segments it fully contains).
"""

from __future__ import annotations

import csv

import numpy as np

from ..core.frames import inframes_to_outframes
from ..core.windows import fixed_window_grid, random_window_grid
from .audio import WaveformCache, read_wav_window
from .windows import out_span


def _read_tsv(path) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f, delimiter="\t"))


class SegmentationCorpus:
    """talks + true segments for a split (base of both dataset flavors)."""

    def __init__(self, talk_list: str, segments_list: str) -> None:
        self.talks = [{"id": r["id"], "path": r["path"],
                       "total_frames": int(float(r["total_frames"]))}
                      for r in _read_tsv(talk_list)]
        self._by_id = {t["id"]: t for t in self.talks}
        self._segments: dict[str, list[tuple[int, int]]] = {}
        rows = _read_tsv(segments_list)
        for r in rows:
            self._segments.setdefault(r["talk_id"], []).append(
                (int(float(r["start"])), int(float(r["end"]))))
        # transcripts for the CTC task: the reference left them unloaded
        # (lib/dataset.py:45 "[TODO] load self.tgt_text")
        self.has_text = bool(rows) and "tgt_text" in rows[0]
        # talk_id -> start-sorted (starts, ends, texts), one binary search
        # per window
        self._text_index: dict = {}
        if self.has_text:
            by_talk: dict = {}
            for r in rows:
                by_talk.setdefault(r["talk_id"], []).append(
                    (int(float(r["start"])), int(float(r["end"])),
                     (r["tgt_text"] or "").strip()))
            for tid, segs in by_talk.items():
                segs.sort(key=lambda x: x[0])
                self._text_index[tid] = (np.array([x[0] for x in segs]),
                                         np.array([x[1] for x in segs]),
                                         [x[2] for x in segs])

    def window_transcript(self, talk_id, start: int, end: int) -> str:
        """Transcript of the window [start, end) in input-space frames: the
        texts of the true segments fully contained in the window, joined by
        spaces (a partly overlapping segment's text covers audio outside
        the window, so it is left out)."""
        entry = self._text_index.get(talk_id)
        if entry is None:
            return ""
        starts, ends, texts = entry
        lo = int(np.searchsorted(starts, start, side="left"))
        out = []
        for i in range(lo, len(starts)):
            if starts[i] > end:
                break
            if ends[i] <= end and texts[i]:
                out.append(texts[i])
        return " ".join(out)

    def talk_ids(self) -> list[str]:
        return [t["id"] for t in self.talks]

    def talk_row(self, talk_id) -> dict:
        return self._by_id[talk_id]

    def talk_label_vector(self, talk_id) -> np.ndarray:
        """Binary 1/0 per input-space frame: inside a true segment or not
        (reference lib/dataset.py:83-87)."""
        labels = np.zeros(self.talk_row(talk_id)["total_frames"],
                          dtype=np.uint8)
        for start, end in self._segments.get(talk_id, ()):
            labels[start:end] = 1
        return labels


def window_targets(labels_window: np.ndarray) -> list[tuple[int, int]]:
    """True (start, end) spans of a window in OUTPUT space.

    Replicates reference _get_targets_for_segment (lib/dataset.py:99-127)
    including the +1 bump when a span's rounded start collides with the
    previous span's end."""
    lw = labels_window
    change = list(np.where(lw[1:] != lw[:-1])[0] + 1)
    targets: list[tuple[int, int]] = []
    for s, e in zip([0] + change, change + [len(lw)]):
        if lw[s] == 1:
            so = int(inframes_to_outframes(s))
            eo = int(inframes_to_outframes(e))
            if targets and so <= targets[-1][1]:
                so += 1
            targets.append((so, eo))
    return targets


def construct_target(spans: list[tuple[int, int]],
                     duration_inframes: int) -> np.ndarray:
    """Window spans -> dense binary target in output space
    (reference _construct_target, lib/dataset.py:129-144)."""
    target_len = int(inframes_to_outframes(duration_inframes))
    target = np.zeros(target_len, dtype=np.float32)
    for s, e in spans:
        target[s : min(e, target_len + 1)] = 1
    return target


class _GridDataset:
    """Windows over a corpus with targets; yields numpy examples
    (waveform, target, start_out, end_out)."""

    has_targets = True

    def __init__(self, corpus: SegmentationCorpus):
        self.corpus = corpus
        # rows: (talk_id, path, start_in, end_in, spans)
        self.rows: list = []
        # parallel to rows when the corpus carries tgt_text (CTC task)
        self.transcripts: list[str] = []
        self.n_pos = 0
        self.n_all = 0
        # set by the fixed grid (talk-sequential access); the random
        # training grid reads windows corpus-wide in shuffled order
        self._wav_cache: WaveformCache | None = None

    def _add_talk_windows(self, talk_id, starts, ends) -> None:
        path = self.corpus.talk_row(talk_id)["path"]
        labels = self.corpus.talk_label_vector(talk_id)
        for s, e in zip(starts, ends):
            spans = window_targets(labels[s:e])
            self.rows.append((talk_id, path, int(s), int(e), spans))
            self.n_pos += sum(ee - ss for ss, ee in spans)
            self.n_all += int(inframes_to_outframes(e - s))
            if self.corpus.has_text:
                self.transcripts.append(
                    self.corpus.window_transcript(talk_id, int(s), int(e)))

    def transcript(self, idx: int) -> str:
        """The window's transcript for the CTC task ('' without a
        tgt_text column)."""
        return self.transcripts[idx] if self.transcripts else ""

    @property
    def pos_class_percentage(self) -> float:
        return self.n_pos / max(1, self.n_all)

    def __len__(self) -> int:
        return len(self.rows)

    def window_span(self, idx: int) -> tuple[int, int, int]:
        """(samples, start, end) of window ``idx`` without reading it."""
        _, _, s, e, _ = self.rows[idx]
        return (e - s, *out_span(s, e))

    def __getitem__(self, idx: int):
        talk_id, path, s, e, spans = self.rows[idx]
        if self._wav_cache is not None:
            waveform = self._wav_cache.window(path, s, e - s)
        else:
            waveform = read_wav_window(path, s, e - s)
        target = construct_target(spans, e - s)
        return (waveform, target, *out_span(s, e))


class RandomSegmentationDataset(_GridDataset):
    """Fresh random segmentation of every talk; regenerated each epoch
    (reference lib/dataset.py:147-257)."""

    def __init__(self, talk_list, segments_list, segment_length,
                 seed: int | None = None):
        super().__init__(SegmentationCorpus(talk_list, segments_list))
        rng = np.random.RandomState(seed)
        self.segment_length = segment_length
        for talk in self.corpus.talks:
            starts, ends = random_window_grid(talk["total_frames"],
                                              segment_length, rng)
            self._add_talk_windows(talk["id"], starts, ends)


class FixedSegmentationDataset(_GridDataset):
    """Fixed-length segmentation of one talk (or all), per inference pass
    (reference lib/dataset.py:335-497).  Talks are decoded whole and their
    windows sliced, unless ``whole_talk`` is False: a data rank that holds
    only some rows of each batch reads each of its windows alone."""

    def __init__(self, talk_list, segments_list, segment_length,
                 inference_times: int = 1, whole_talk: bool = True):
        super().__init__(SegmentationCorpus(talk_list, segments_list))
        self.segment_length = segment_length
        self.inference_times = inference_times
        self.duration_outframes: int | None = None
        if whole_talk:
            self._wav_cache = WaveformCache(2)

    def generate_fixed_segments(self, talk_id, iteration: int) -> None:
        self.rows, self.transcripts = [], []
        total = self.corpus.talk_row(talk_id)["total_frames"]
        self.duration_outframes = int(inframes_to_outframes(total))
        starts, ends = fixed_window_grid(total, self.segment_length,
                                         self.inference_times, iteration)
        self._add_talk_windows(talk_id, starts, ends)

    def generate_fixed_segments_all_talks(self, iteration: int) -> None:
        self.rows, self.transcripts = [], []
        for talk in self.corpus.talks:
            starts, ends = fixed_window_grid(
                talk["total_frames"], self.segment_length,
                self.inference_times, iteration)
            self._add_talk_windows(talk["id"], starts, ends)

    def release_cache(self) -> None:
        """Drop decoded waveforms between evals (the dataset lives for the
        whole training run)."""
        if self._wav_cache is not None:
            self._wav_cache.clear()
