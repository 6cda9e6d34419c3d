"""Kaldi-compatible 80-dim log-mel filterbank extraction.

Native replacement for the fairseq ``extract_fbank_features`` import the
reference uses (lib/eval_scripts/prepare_custom_dataset.py:16-24), which
wraps torchaudio.compliance.kaldi.fbank.  Defaults replicate that path:
25 ms povey-windowed frames at 10 ms shift, snip_edges, DC removal,
preemphasis 0.97, 512-point FFT, 80 kaldi-mel triangles over 20 Hz..nyquist,
natural log, input scaled to int16 range (fairseq multiplies by 2**15).

Vectorized NumPy — one matmul per utterance; fast enough that feature
extraction is I/O bound.

The port's copy of ``wav2vecsegmenter_tpu/stpipe/fbank.py``
(tests/test_torch_copies.py holds the two equal).
"""

from __future__ import annotations

import numpy as np

_MEL_LOW_HZ = 20.0


def _kaldi_mel(hz):
    return 1127.0 * np.log(1.0 + np.asarray(hz) / 700.0)


def _povey_window(n: int) -> np.ndarray:
    # kaldi 'povey' window: hann^0.85
    i = np.arange(n)
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * i / (n - 1))
    return hann ** 0.85


def mel_filterbank(num_bins: int, fft_bins: int, sample_rate: int,
                   low_freq: float = _MEL_LOW_HZ,
                   high_freq: float = 0.0) -> np.ndarray:
    """Kaldi-style triangular mel filters [num_bins, fft_bins//2+1]."""
    nyquist = sample_rate / 2.0
    if high_freq <= 0:
        high_freq = nyquist + high_freq
    mel_low = _kaldi_mel(low_freq)
    mel_high = _kaldi_mel(high_freq)
    mel_points = np.linspace(mel_low, mel_high, num_bins + 2)
    n_freqs = fft_bins // 2 + 1
    fft_freqs = np.arange(n_freqs) * sample_rate / fft_bins
    mel_freqs = _kaldi_mel(fft_freqs)

    fb = np.zeros((num_bins, n_freqs), np.float64)
    for b in range(num_bins):
        left, center, right = mel_points[b], mel_points[b + 1], mel_points[b + 2]
        up = (mel_freqs - left) / (center - left)
        down = (right - mel_freqs) / (right - center)
        fb[b] = np.maximum(0.0, np.minimum(up, down))
    return fb


def fbank80(
    waveform: np.ndarray,
    sample_rate: int = 16000,
    num_mel_bins: int = 80,
    frame_length_ms: float = 25.0,
    frame_shift_ms: float = 10.0,
    preemphasis: float = 0.97,
    scale_to_int16: bool = True,
) -> np.ndarray:
    """waveform float32 [-1,1] -> log-mel features [T, num_mel_bins]."""
    x = np.asarray(waveform, np.float64)
    if scale_to_int16:
        x = x * 32768.0
    win = int(sample_rate * frame_length_ms / 1000)   # 400
    hop = int(sample_rate * frame_shift_ms / 1000)    # 160
    if len(x) < win:
        return np.zeros((0, num_mel_bins), np.float32)
    n_frames = 1 + (len(x) - win) // hop

    idx = np.arange(win)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = x[idx]  # [T, win]

    # remove DC, raw-energy-free kaldi pipeline
    frames = frames - frames.mean(axis=1, keepdims=True)
    # preemphasis with first-sample duplication (kaldi semantics)
    pre = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
    frames = frames - preemphasis * pre
    frames = frames * _povey_window(win)

    n_fft = 1
    while n_fft < win:
        n_fft *= 2  # round_to_power_of_two -> 512
    spec = np.fft.rfft(frames, n=n_fft, axis=1)
    power = np.abs(spec) ** 2

    fb = mel_filterbank(num_mel_bins, n_fft, sample_rate)
    mel = power @ fb.T
    mel = np.log(np.maximum(mel, 1.192092955078125e-07))  # FLT_EPSILON floor
    return mel.astype(np.float32)
