"""Wav decoding with random-access window reads.

Replaces the reference's torchaudio sox_io seek-reads (lib/dataset.py:
659-663).  Backends, as in ``wav2vecsegmenter_tpu/data/audio.py``:
  * the native C++ loader (``native/audio/wav_loader.cpp`` through the
    port's binding, ``data.native_audio``, built into ``_build/`` on first
    use) — a ``ctypes`` call that releases the interpreter lock while it
    reads into a preallocated buffer, so that the background reader's
    threads (``data.windows``) do not hold up the thread that launches
    the device's work;
  * the stdlib ``wave`` module (16-bit PCM mono is what MuST-C ships) where
    the loader cannot be built, and for every case where the loader's
    answer is not the stdlib's: encodings other than 16-bit PCM (it
    refuses to read them, and reports the header of an IEEE float file,
    which the stdlib refuses), a window that starts past the end (the
    stdlib raises), a negative offset or frame count, and a file it
    cannot open.
:func:`reader_backend` says which one reads 16-bit PCM.  Samples are
returned float32 in [-1, 1) (int16 / 32768, torchaudio's convention).

The port's copy of the JAX module, with its own binding of the same
loader (tests/test_torch_copies.py holds the two modules equal, and
tests/test_torch_reader_native.py the native route equal to the JAX
module's stdlib route, format by format).
"""

from __future__ import annotations

import collections
import threading
import wave
from pathlib import Path

import numpy as np

from ..constants import INPUT_SAMPLE_RATE
from . import native_audio

_native = None


def _get_native():
    global _native
    if _native is None:
        _native = native_audio if native_audio.available() else False
    return _native


def reader_backend() -> str:
    """``"native"`` when the C++ loader reads 16-bit PCM windows, else
    ``"wave"`` (the loader could not be built).  It reports; it sets
    nothing."""
    return "native" if _get_native() else "wave"


def wav_info(path: str | Path) -> tuple[int, int, int]:
    """(num_frames, sample_rate, channels)."""
    nat = _get_native()
    if nat:
        try:
            info = nat.wav_info(str(path))
            # the loader's header for a file it reads (16-bit PCM) only
            if nat.read_window(str(path), 0, 1).size == 1:
                return info
        except OSError:
            pass
    with wave.open(str(path), "rb") as f:
        return f.getnframes(), f.getframerate(), f.getnchannels()


def read_wav_window(path: str | Path, offset: int = 0,
                    num_frames: int | None = None) -> np.ndarray:
    """Read ``num_frames`` samples starting at ``offset`` -> float32 [-1, 1)."""
    nat = _get_native()
    if nat and offset >= 0 and (num_frames is None or num_frames > 0):
        try:
            data = nat.read_window(str(path), int(offset),
                                   -1 if num_frames is None
                                   else int(num_frames))
        except OSError:  # not 16-bit PCM, or unreadable
            data = None
        # an empty read is a window at or past the end, where the stdlib
        # raises for a start past it
        if data is not None and data.size:
            return data
    with wave.open(str(path), "rb") as f:
        n_channels = f.getnchannels()
        sampwidth = f.getsampwidth()
        total = f.getnframes()
        if num_frames is None:
            num_frames = total - offset
        num_frames = max(0, min(num_frames, total - offset))
        f.setpos(int(offset))
        raw = f.readframes(int(num_frames))
    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"Unsupported sample width {sampwidth} in {path}")
    if n_channels > 1:
        # the reference keeps only the first channel (waveform[0],
        # lib/dataset.py:257) — match that, not a downmix
        data = np.ascontiguousarray(data.reshape(-1, n_channels)[:, 0])
    return data


class WaveformCache:
    """Thread-safe tiny LRU of fully-decoded waveforms.

    The fixed-grid inference dataset reads the SAME wav once per window and
    once per pass; access is talk-sequential, so a small LRU turns all but
    the first read into memory slices.  A miss decodes under the lock, so
    that reader threads which miss the same talk together decode it once.
    """

    def __init__(self, capacity: int = 2):
        self._cap = capacity
        self._data: "collections.OrderedDict[str, np.ndarray]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()

    def full(self, path: str | Path) -> np.ndarray:
        key = str(path)
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                return self._data[key]
            data = read_wav_window(key, 0, None)
            self._data[key] = data
            self._data.move_to_end(key)
            while len(self._data) > self._cap:
                self._data.popitem(last=False)
        return data

    def window(self, path: str | Path, offset: int,
               num_frames: int) -> np.ndarray:
        full = self.full(path)
        return full[offset : offset + num_frames]

    def clear(self) -> None:
        """Drop cached waveforms (a long-lived eval dataset would otherwise
        pin the last talks' full decodes between evals)."""
        with self._lock:
            self._data.clear()


def assert_sample_rate(path: str | Path) -> int:
    """Sample-rate guard (reference lib/dataset.py:600-602)."""
    n, sr, _ = wav_info(path)
    assert sr == INPUT_SAMPLE_RATE, (
        f"Audio needs to have sample rate of {INPUT_SAMPLE_RATE} (got {sr})"
    )
    return n
