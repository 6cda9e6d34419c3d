"""Pure frame-space conversion functions.

These replicate the conversion semantics of the reference dataset layer
(reference lib/dataset.py:52-66 and :604-610): all conversions go
through ``np.round`` (banker's rounding) and produce integer frame counts.

Three spaces:
  * seconds     — wall-clock audio time
  * in-frames   — 16 kHz waveform samples ("input space")
  * out-frames  — 49.95 Hz classifier frames ("output space")

A copy of ``wav2vecsegmenter_tpu/core/frames.py``: the port imports nothing
of the JAX package (tests/test_torch_copies.py holds the two equal).
"""

from __future__ import annotations

import numpy as np

from ..constants import INPUT_SAMPLE_RATE, TARGET_SAMPLE_RATE

# samples per output frame (~320.32)
IN_TRG_RATIO = INPUT_SAMPLE_RATE / TARGET_SAMPLE_RATE
TRG_IN_RATIO = 1.0 / IN_TRG_RATIO


def secs_to_outframes(x):
    """seconds -> output-space frames (np.round, as reference lib/dataset.py:52)."""
    return np.round(np.asarray(x) * TARGET_SAMPLE_RATE).astype(int)


def outframes_to_inframes(x):
    """output space -> input space (reference lib/dataset.py:56)."""
    return np.round(np.asarray(x) * IN_TRG_RATIO).astype(int)


def inframes_to_outframes(x):
    """input space -> output space (reference lib/dataset.py:60)."""
    return np.round(np.asarray(x) * TRG_IN_RATIO).astype(int)


def secs_to_inframes(x):
    """seconds -> input-space frames (reference lib/dataset.py:64)."""
    return np.round(np.asarray(x) * INPUT_SAMPLE_RATE).astype(int)


# wav2vec2 feature-extractor conv geometry
CONV_KERNEL_SIZES = (10, 3, 3, 3, 3, 2, 2)
CONV_STRIDES = (5, 2, 2, 2, 2, 2, 2)


def conv_output_length(input_length, kernel_sizes=CONV_KERNEL_SIZES,
                       strides=CONV_STRIDES):
    """Exact output length of the wav2vec2 strided-conv feature extractor.

    Mirrors HF ``Wav2Vec2Model._get_feat_extract_output_lengths``: repeated
    floor((L - kernel) / stride) + 1 over the 7 conv layers.  This is the
    *true* number of encoder frames, which can differ by +-1 from the
    49.95 Hz estimate — the mismatch the reference patches in three places
    (reference lib/models.py:222-232, train.py:409-430,
    lib/evaluate.py:62-70).
    """
    length = np.asarray(input_length)
    for k, s in zip(kernel_sizes, strides):
        length = (length - k) // s + 1
    return length
