"""The plain reference of the training data path: window grids, targets
and batch normalization, in NumPy, written from the reference
implementation's semantics (reference lib/dataset.py, lib/datautils.py,
lib/evaluate.py) and imported from nothing of the program.

Frames: input space is 16 kHz samples, output space 49.95 Hz classifier
frames; every conversion goes through ``np.round``.
"""

from __future__ import annotations

import wave

import numpy as np

IN_RATE, OUT_RATE = 16000, 49.95
CONV = ((10, 5), (3, 2), (3, 2), (3, 2), (3, 2), (2, 2), (2, 2))


def to_out(x):
    return np.round(np.asarray(x) * OUT_RATE / IN_RATE).astype(int)


def to_in(x):
    return np.round(np.asarray(x) * IN_RATE / OUT_RATE).astype(int)


def secs_in(x):
    return np.round(np.asarray(x) * IN_RATE).astype(int)


def conv_frames(n: int) -> int:
    for k, s in CONV:
        n = (n - k) // s + 1
    return int(n)


def out_span(s: int, e: int) -> tuple[int, int]:
    return int(to_out(s + 1e-6)), int(to_out(e + 1e-6))


def read_wav(path) -> np.ndarray:
    with wave.open(str(path), "rb") as f:
        return np.frombuffer(f.readframes(f.getnframes()), "<i2")


def random_grid(n: int, secs: float, rng):
    """One epoch's random windows (lib/dataset.py:193-222): a step of
    0.9 L in output space, each start moved back by up to 0.1 L."""
    seg_out = int(np.round(secs * OUT_RATE))
    overlap = int(np.round(secs / 10 * OUT_RATE))
    seg_in = int(secs_in(secs))
    starts = np.arange(0, int(to_out(n)), step=seg_out - overlap)
    starts = to_in(starts - rng.randint(0, overlap, size=len(starts)))
    return np.maximum(0, starts).astype(int), \
        np.minimum(starts + seg_in, n).astype(int)


def window_spans(labels: np.ndarray) -> list[tuple[int, int]]:
    """A window's true segments in output space (lib/dataset.py:99-127),
    a start that meets the previous end moved on by one."""
    change = list(np.where(labels[1:] != labels[:-1])[0] + 1)
    out: list[tuple[int, int]] = []
    for s, e in zip([0] + change, change + [len(labels)]):
        if labels[s] == 1:
            so, eo = int(to_out(s)), int(to_out(e))
            if out and so <= out[-1][1]:
                so += 1
            out.append((so, eo))
    return out


def target(spans, n_in: int) -> np.ndarray:
    t = np.zeros(int(to_out(n_in)), np.float32)
    for s, e in spans:
        t[s:min(e, len(t) + 1)] = 1
    return t


def batch(windows: list, bucket: int) -> dict:
    """A batch of windows [(int16 samples, target or None, s_out, e_out)]
    as the model sees it (lib/datautils.py:57-142): every row zero-padded
    to the longest window and normalized over it (mean and ddof=1 std of
    the padded row), silent rows zeroed and excluded, then padded with
    zeros to ``bucket`` samples; the output mask; and the batch-level
    one-frame correction (lib/evaluate.py:62-68) where the conv stack
    gives fewer frames than the widest window spans."""
    n = len(windows)
    longest = max(len(w[0]) for w in windows)
    out_len = int(to_out(bucket))
    audio = np.zeros((n, bucket), np.float32)
    in_lengths = np.array([len(w[0]) for w in windows])
    included = np.array([bool(np.any(w[0])) for w in windows])
    starts = np.array([w[2] for w in windows])
    ends = np.array([w[3] for w in windows])
    out_mask = np.zeros((n, out_len), bool)
    tgt = np.zeros((n, out_len), np.float32)
    for i, (wav, t, s, e) in enumerate(windows):
        row = np.zeros(longest)
        row[:len(wav)] = wav / 32768.0
        if included[i]:
            audio[i, :longest] = (row - row.mean()) / row.std(ddof=1)
        out_mask[i, :e - s] = True
        if t is not None:
            tgt[i, :len(t[:out_len])] = t[:out_len]
    widest = int((ends - starts).max())
    if conv_frames(longest) < widest:
        ends = ends - 1
        out_mask[:, widest - 1:] = False
    return {"audio": audio, "in_lengths": in_lengths, "included": included,
            "starts": starts, "ends": ends, "out_mask": out_mask,
            "target": tgt}
