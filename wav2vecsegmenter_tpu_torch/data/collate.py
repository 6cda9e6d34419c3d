"""Batch assembly with reference-exact normalization, static device shapes.

The reference CollateFn (lib/datautils.py:57-142) pads each batch to its own
max length and normalizes every non-empty waveform with mean/std computed
over the *padded* row (zeros included; torch.std => ddof=1).  Here:

  * normalization statistics are computed over ``norm_length`` = the batch's
    max true length — bit-matching the reference's padded-row statistics;
  * the buffer is then padded further to a static bucket length, which does
    not affect statistics and keeps two audio shapes per segment length.

Batches shorter than ``batch_size`` are padded with empty rows
(included=False), matching the reference's handling of all-zero windows
(probs forced to 0 at lib/evaluate.py:109-111).

The port's copy of ``Batch``, ``collate`` and ``out_len_for`` of
``wav2vecsegmenter_tpu/data/collate.py`` (tests/test_torch_copies.py holds
the two equal), the CTC task's transcript tokens included, and of
``AutoRegBatch`` / ``collate_autoreg``, the autoregressive task's batch
(SEP-led decoder input, SEP-tailed target, host-normalized audio).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.frames import conv_output_length, inframes_to_outframes


@dataclass
class Batch:
    audio: np.ndarray        # [B, L_static] float32 normalized, or int16 raw
    in_lengths: np.ndarray   # [B] int32 true sample counts
    target: np.ndarray | None  # [B, T_static] float32
    out_mask: np.ndarray     # [B, T_static] bool
    included: np.ndarray     # [B] bool (False for padding rows / silent windows)
    starts: np.ndarray       # [B] int32 output-space start frames
    ends: np.ndarray         # [B] int32 output-space end frames
    # device-normalize path: audio is int16 *raw* samples and normalization
    # stats are computed on the device over [0, norm_length)
    norm_length: int = 0
    device_normalize: bool = False
    # real example rows (the rest are static-shape padding)
    n_real: int = 0
    # CTC task: encoded window transcripts [B, U_static] (vocab ids, padded
    # with the vocab pad id) — None for every other task
    tokens: np.ndarray | None = None


def collate(
    examples: list,
    batch_size: int,
    audio_len: int,
    out_len: int,
    pad_token_id: float = 0.0,
    device_normalize: bool = False,
    transcripts: list[str] | None = None,
    ctc_vocab=None,
) -> Batch:
    """examples: list of (waveform, target|None, start, end) numpy tuples.

    With ``device_normalize`` the waveforms are left raw (as int16) and
    normalization moves to the device (see infer/pipeline.py)."""
    n = len(examples)
    assert n <= batch_size
    audio = np.zeros((batch_size, audio_len),
                     np.int16 if device_normalize else np.float32)
    in_lengths = np.zeros(batch_size, np.int32)
    included = np.zeros(batch_size, bool)
    starts = np.zeros(batch_size, np.int32)
    ends = np.zeros(batch_size, np.int32)
    has_target = n > 0 and examples[0][1] is not None
    target = (
        np.full((batch_size, out_len), pad_token_id, np.float32)
        if has_target else None
    )
    out_mask = np.zeros((batch_size, out_len), bool)

    norm_length = max((len(ex[0]) for ex in examples), default=0)

    for i, (wav, tgt, s, e) in enumerate(examples):
        L = len(wav)
        if device_normalize:
            # exact int16 round-trip (decoders produce int16/32768 floats);
            # clip before the cast: a +full-scale sample from a 24/32-bit
            # source rounds to 32768, which astype(int16) would wrap
            audio[i, :L] = np.clip(
                np.rint(wav * 32768.0), -32768, 32767).astype(np.int16)
        else:
            audio[i, :L] = wav
        in_lengths[i] = L
        included[i] = bool(wav.sum())
        starts[i] = s
        ends[i] = e
        out_sl = e - s
        out_mask[i, :out_sl] = True
        if has_target and tgt is not None:
            t = tgt[:out_len]
            target[i, : len(t)] = t

    # Reference-equivalent normalization: stats over the batch-max padded row
    # (lib/datautils.py:120-125; torch.std => ddof=1).
    if not device_normalize:
        for i in range(n):
            if not included[i]:
                continue
            row = audio[i, :norm_length]
            mean = row.mean(dtype=np.float64)
            std = row.std(ddof=1, dtype=np.float64)
            audio[i, :norm_length] = ((row - mean) / std).astype(np.float32)

    # Replicate the reference's batch-level +-1 frame correction
    # (lib/evaluate.py:62-68): when the conv stack yields fewer frames than
    # the widest out row, every row's end is decremented before stitching.
    if n:
        size1 = int(conv_output_length(norm_length))
        size2 = int((ends[:n] - starts[:n]).max())
        if size1 < size2:
            ends[:n] -= 1
            # the reference also crops out_mask's width (out_mask[:, :-1]),
            # shrinking the widest rows' key set in the seg-head attention
            out_mask[:, size2 - 1 :] = False

    # CTC targets: encoded transcripts, statically padded to the bucket's
    # output-frame count.  Each row truncates to ITS OWN logit length
    # (conv_output_length of the row's real audio, the same arithmetic the
    # ctc step uses) — capping at the bucket-wide out_len would let a short
    # row in a long bucket carry U > T labels, an infeasible CTC sequence
    # whose ~|log_epsilon| loss poisons the batch mean silently (torch
    # surfaces inf there).  Over-long transcripts indicate a window far too
    # short for its text; truncation bounds the damage to that row.
    tokens = None
    if transcripts is not None and ctc_vocab is not None:
        tokens = np.full((batch_size, out_len), ctc_vocab.pad_token_id,
                         np.int32)
        for i, text in enumerate(transcripts):
            # clamp at 0: a window shorter than the conv receptive field
            # (~400 samples) yields a negative conv_output_length, and a
            # negative flen would slice labels off the END instead of
            # truncating to empty — recreating the U > T infeasible row
            flen = max(0, min(out_len, int(conv_output_length(in_lengths[i]))))
            ids = ctc_vocab.encode_transcript(text)[:flen]
            tokens[i, : len(ids)] = ids

    return Batch(audio, in_lengths, target, out_mask, included, starts, ends,
                 norm_length=norm_length, device_normalize=device_normalize,
                 n_real=n, tokens=tokens)


def out_len_for(audio_len: int) -> int:
    """Static output-frame count for a static audio bucket."""
    return int(inframes_to_outframes(audio_len))


@dataclass
class AutoRegBatch:
    audio: np.ndarray          # [B, L] float32, normalized
    in_lengths: np.ndarray     # [B]
    in_target: np.ndarray      # [B, T+1] token ids (SEP-led, no tail)
    out_target: np.ndarray     # [B, T+1] token ids (no head, SEP-tailed)
    src_mask: np.ndarray       # [B, T] bool encoder key mask
    tgt_mask: np.ndarray       # [B, T+1] bool decoder key mask
    included: np.ndarray
    starts: np.ndarray
    ends: np.ndarray


def collate_autoreg(
    examples: list,
    batch_size: int,
    audio_len: int,
    out_len: int,
    pad_token_id: int,
    sep_token_id: int,
) -> AutoRegBatch:
    """Autoregressive batch (reference AutoRegCollateFn,
    lib/datautils.py:145-248): targets wrapped in SEP tokens, shifted into
    teacher-forcing in/out pairs; masks mirror the -1-for-SEP semantics."""
    n = len(examples)
    t_tgt = out_len + 2  # SEP + frames + SEP
    audio = np.zeros((batch_size, audio_len), np.float32)
    in_lengths = np.zeros(batch_size, np.int32)
    included = np.zeros(batch_size, bool)
    starts = np.zeros(batch_size, np.int32)
    ends = np.zeros(batch_size, np.int32)
    target = np.full((batch_size, t_tgt), pad_token_id, np.float32)
    tgt_pad_mask = np.zeros((batch_size, t_tgt - 1), bool)

    norm_length = max((len(ex[0]) for ex in examples), default=0)
    for i, (wav, tgt, s, e) in enumerate(examples):
        L = len(wav)
        audio[i, :L] = wav
        in_lengths[i] = L
        included[i] = bool(wav.sum())
        starts[i] = s
        ends[i] = e
        row = np.concatenate([[sep_token_id], tgt, [sep_token_id]])
        row = row[:t_tgt]
        target[i, : len(row)] = row
        tgt_pad_mask[i, : len(row) - 1] = True  # -1 for tail SEP

    for i in range(n):
        if not included[i]:
            continue
        row = audio[i, :norm_length]
        mean = row.mean(dtype=np.float64)
        std = row.std(ddof=1, dtype=np.float64)
        audio[i, :norm_length] = ((row - mean) / std).astype(np.float32)

    src_mask = tgt_pad_mask[:, 1:]  # -1 for head SEP
    return AutoRegBatch(
        audio=audio,
        in_lengths=in_lengths,
        in_target=target[:, :-1].astype(np.int32),
        out_target=target[:, 1:].astype(np.int32),
        src_mask=src_mask,
        tgt_mask=tgt_pad_mask,
        included=included,
        starts=starts,
        ends=ends,
    )
