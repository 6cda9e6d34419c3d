"""Global frame-math constants.

Semantics mirror the reference (lib/constants.py:1-14): the wav2vec 2.0
feature extractor downsamples 16 kHz audio by 320x, but the effective output
frame rate used for all second<->frame conversions is 49.95 frames/s ("50
(16000/320) wasn't exactly correct" per the reference), because the strided
convolutions drop a few samples at segment edges.

The port's copy of the constants of ``wav2vecsegmenter_tpu/constants.py`` it
uses (tests/test_torch_copies.py holds them equal).
"""

INPUT_SAMPLE_RATE = 16_000
# Output (classifier) frame rate in frames/sec.
TARGET_SAMPLE_RATE = 49.95
# Duration of one wav2vec 2.0 output frame in milliseconds.
WAV2VEC_FRAME_LEN = 20
