"""The one traffic generator: synthetic talks from a traffic file's
parameters and a seed.

A talk is speech-like audio: bursts of amplitude-modulated noise between
short pauses, 16 kHz 16-bit mono.  The audio follows ``talk_pcm`` of
``chip_smoke.py`` (commit 3acaaec): Gaussian noise at 0.1 of full scale
inside speech, a loudness of 0.6 + 0.4 sin(2 pi t / 7.3 + phase).  Where
``talk_pcm`` paused every 3.5 s in 100 s talks, the bursts and pauses here
are drawn from the seed, and the talk lengths from a log-normal
distribution.  The bursts are the talks' true segments, as
``write_corpus`` wrote them (an index column first, input-space frames).

Every seed gets the same talk lengths (the distribution's quantiles) in
another order, so that two seeds ask for the same work; the seed draws
the bursts, the samples and the order.
"""

from __future__ import annotations

import os
import statistics
import wave
from pathlib import Path

import numpy as np
import torch

SAMPLE_RATE = 16000
ROOM_NOISE = 0.002    # the level between bursts, of full scale


def sub_seeds(seed: int, n: int = 8) -> list[int]:
    """``n`` independent 32-bit seeds drawn from ``seed`` (any size)."""
    return [int(s) for s in np.random.SeedSequence(int(seed)).generate_state(n)]


def talk_lengths(talks: dict) -> list[float]:
    """The talks' lengths in seconds: the quantiles (i + 0.5) / n of a
    log-normal distribution of ``median_s`` and ``sigma``, clipped to
    [``min_s``, ``max_s``], longest first."""
    n = int(talks["count"])
    z = [statistics.NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
    secs = [min(max(talks["median_s"] * float(np.exp(talks["sigma"] * v)),
                    talks["min_s"]), talks["max_s"]) for v in z]
    return sorted((round(s, 2) for s in secs), reverse=True)


def bursts(secs: float, speech: dict, seed: int) -> list[tuple[int, int]]:
    """The speech bursts of a talk, (start, end) in samples: a pause, a
    burst, a pause, ... with lengths uniform in ``pause_s`` and
    ``burst_s``."""
    rng = np.random.RandomState(seed)
    n = int(round(secs * SAMPLE_RATE))
    out, t = [], rng.uniform(*speech["pause_s"])
    while True:
        end = t + rng.uniform(*speech["burst_s"])
        s, e = int(t * SAMPLE_RATE), min(int(end * SAMPLE_RATE), n)
        if s >= n:
            return out
        out.append((s, e))
        t = end + rng.uniform(*speech["pause_s"])


def talk_pcm(lengths: list[float], segs: list[list[tuple[int, int]]],
             seed: int, device) -> list[np.ndarray]:
    """Every talk's int16 samples, drawn on ``device`` in a few large
    calls: noise at 0.1 of full scale in the bursts and at
    ``ROOM_NOISE`` in the pauses, times a slowly varying loudness."""
    g = torch.Generator(device=device).manual_seed(seed)
    ns = [int(round(s * SAMPLE_RATE)) for s in lengths]
    total = sum(ns)
    noise = torch.randn(total, generator=g, device=device)
    phases = torch.rand(len(ns), generator=g, device=device) * 2 * np.pi
    level = torch.full((total,), ROOM_NOISE, device=device)
    offset = 0
    for n, talk in zip(ns, segs):
        for s, e in talk:
            level[offset + s:offset + e] = 0.1
        offset += n
    talk_index = torch.repeat_interleave(
        torch.arange(len(ns), device=device),
        torch.tensor(ns, device=device))
    starts = torch.tensor([0] + list(np.cumsum(ns)[:-1]), device=device)
    t = (torch.arange(total, device=device) - starts[talk_index]) / SAMPLE_RATE
    loud = 0.6 + 0.4 * torch.sin(2 * np.pi * t / 7.3 + phases[talk_index])
    pcm = torch.clamp(noise * level * loud * 32768.0, -32768, 32767)
    pcm = pcm.round().to(torch.int16).cpu().numpy()
    return np.split(pcm, np.cumsum(ns)[:-1])


def write_wav(path: Path, pcm: np.ndarray) -> None:
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(SAMPLE_RATE)
        f.writeframes(pcm.astype("<i2").tobytes())


def write_talks(root: Path, traffic: dict, seed: int, device) -> list[dict]:
    """The traffic's distinct talks as wav files under ``root``: [{"path",
    "secs", "samples", "bursts"}], in an order drawn from the seed."""
    s_order, s_bursts, s_pcm = sub_seeds(seed, 3)
    lengths = talk_lengths(traffic["talks"])
    order = np.random.RandomState(s_order).permutation(len(lengths))
    lengths = [lengths[i] for i in order]
    segs = [bursts(secs, traffic["speech"], s_bursts + i)
            for i, secs in enumerate(lengths)]
    pcms = talk_pcm(lengths, segs, s_pcm, device)
    talks = []
    for i, (secs, talk_segs, pcm) in enumerate(zip(lengths, segs, pcms)):
        path = Path(root) / f"talk{i:02d}.wav"
        write_wav(path, pcm)
        talks.append({"path": path, "secs": len(pcm) / SAMPLE_RATE,
                      "samples": len(pcm), "bursts": talk_segs})
    # written back now, in set-up, and not by the kernel during the window
    os.sync()
    return talks


def write_lists(root: Path, talks: list[dict], listed: int) -> tuple[str, str]:
    """A talks TSV of ``listed`` talks, the distinct files in turn, and the
    segments TSV of their bursts, as the data prep writes them (an index
    column first; ``total_frames`` and the spans in samples)."""
    rows = ["\tid\tpath\ttotal_frames"]
    segs = ["\ttalk_id\tstart\tend"]
    for k in range(listed):
        talk = talks[k % len(talks)]
        rows.append(f"{k}\tt{k}\t{talk['path']}\t{talk['samples']}")
        for s, e in talk["bursts"]:
            segs.append(f"{len(segs) - 1}\tt{k}\t{s}\t{e}")
    talk_list, seg_list = Path(root) / "talks.tsv", Path(root) / "segments.tsv"
    talk_list.write_text("\n".join(rows) + "\n")
    seg_list.write_text("\n".join(segs) + "\n")
    return str(talk_list), str(seg_list)
