"""Custom-segmentation dataset preparation: fbank80 zip + fairseq TSV
manifest.

Native replacement for the reference's ``prepare_custom_dataset``
(lib/eval_scripts/prepare_custom_dataset.py:89-153), which imports fairseq's
speech_to_text data utils.  Output contract is identical so any external
fairseq install consumes it directly:
  * ``fbank80.zip``: uncompressed .npy features per utterance;
  * ``{yaml_name}.tsv``: columns id/audio/n_frames/tgt_text/speaker/tgt_lang
    with audio = ``<zip_path>:<byte_offset>:<byte_length>`` (fairseq
    get_zip_manifest format).

The port's copy of ``wav2vecsegmenter_tpu/stpipe/manifest.py``, pyyaml and
pandas imported inside the functions that use them
(tests/test_torch_copies.py holds the two equal).
"""

from __future__ import annotations

import io
import zipfile
from itertools import groupby
from pathlib import Path

import numpy as np

from ..data.audio import read_wav_window, wav_info
from .fbank import fbank80

MANIFEST_COLUMNS = ["id", "audio", "n_frames", "tgt_text", "speaker", "tgt_lang"]
SR = 16_000


def iter_yaml_segments(path_to_yaml: Path, path_to_wavs: Path,
                       sort_by_offset: bool = True):
    """(wav_path, offset_samples, n_samples, speaker, utt_id) per segment
    (reference CustomDataset, prepare_custom_dataset.py:33-87)."""
    import yaml

    with open(path_to_yaml) as f:
        segments = yaml.safe_load(f)
    for seg in segments:
        seg["offset"] = float(seg["offset"])
    for wav_filename, group in groupby(segments, key=lambda x: x["wav"]):
        wav_path = path_to_wavs / wav_filename
        _, sample_rate, _ = wav_info(wav_path)
        seg_group = sorted(group, key=lambda x: x["offset"]) if sort_by_offset \
            else list(group)
        for i, segment in enumerate(seg_group):
            offset = int(float(segment["offset"]) * sample_rate)
            n_frames = int(float(segment["duration"]) * sample_rate)
            yield (wav_path, offset, n_frames, segment["speaker_id"],
                   f"{wav_path.stem}_{i}")


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def create_feature_zip(zip_path: Path, features: dict[str, np.ndarray]) -> dict:
    """Write features as stored (uncompressed) .npy zip entries; returns
    {utt_id: (byte_offset, byte_length, n_frames)} of the entry *content*."""
    manifest = {}
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_STORED) as zf:
        for utt_id, feat in features.items():
            zf.writestr(f"{utt_id}.npy", _npy_bytes(feat))
    # re-scan for content offsets (fairseq reads via byte ranges)
    with zipfile.ZipFile(zip_path) as zf:
        for info in zf.infolist():
            utt_id = Path(info.filename).stem
            offset = info.header_offset + 30 + len(info.filename) + \
                len(info.extra)
            manifest[utt_id] = (offset, info.file_size,
                                features[utt_id].shape[0])
    return manifest


def create_audio_zip(zip_path: Path, blobs: dict[str, tuple[bytes, int]]
                     ) -> dict:
    """Write pre-encoded audio files (``{utt_id: (bytes, n_samples)}``) as
    stored zip entries named ``{utt_id}.flac``; returns
    {utt_id: (byte_offset, byte_length, n_samples)} of the entry content
    (fairseq ``get_zip_manifest(is_audio=True)`` format — n_frames are
    waveform samples, not fbank frames)."""
    manifest = {}
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_STORED) as zf:
        for utt_id, (blob, _) in blobs.items():
            zf.writestr(f"{utt_id}.flac", blob)
    with zipfile.ZipFile(zip_path) as zf:
        for info in zf.infolist():
            utt_id = Path(info.filename).stem
            offset = info.header_offset + 30 + len(info.filename) + \
                len(info.extra)
            manifest[utt_id] = (offset, info.file_size, blobs[utt_id][1])
    return manifest


def prepare_custom_dataset(
    path_to_yaml: str | Path,
    path_to_wavs: str | Path,
    tgt_lang: str,
    use_audio_input: int = 0,
    sort_by_offset: bool = True,
) -> Path:
    """custom_segments.yaml -> fbank80.zip (or flac.zip when
    ``use_audio_input``) + TSV manifest next to the yaml.  Returns the TSV
    path.  Mirrors reference lib/eval_scripts/prepare_custom_dataset.py:
    89-153, including the waveform-input branch (:104-125) — flac entries
    are produced by the in-repo encoder (stpipe/flac.py) instead of
    soundfile."""
    use_audio_input = bool(use_audio_input)
    path_to_yaml = Path(path_to_yaml)
    path_to_wavs = Path(path_to_wavs)
    out_dir = path_to_yaml.parent
    zip_path = out_dir / ("flac.zip" if use_audio_input else "fbank80.zip")

    entries: dict = {}
    order: list[tuple[str, str]] = []  # (utt_id, speaker)
    for wav_path, offset, n_samples, speaker, utt_id in iter_yaml_segments(
        path_to_yaml, path_to_wavs, sort_by_offset
    ):
        waveform = read_wav_window(wav_path, offset, n_samples)
        if use_audio_input:
            from .flac import encode_flac

            entries[utt_id] = (encode_flac(waveform, SR), len(waveform))
        else:
            entries[utt_id] = fbank80(waveform)
        order.append((utt_id, speaker))

    if use_audio_input:
        zmanifest = create_audio_zip(zip_path, entries)
    else:
        zmanifest = create_feature_zip(zip_path, entries)

    import pandas as pd

    # fairseq filter_manifest_df semantics for eval splits: drop segments
    # shorter than 5 feature frames (same duration bound for audio input)
    min_n_frames = 5 * 160 if use_audio_input else 5

    rows = {c: [] for c in MANIFEST_COLUMNS}
    for utt_id, speaker in order:
        off, length, n_frames = zmanifest[utt_id]
        if n_frames < min_n_frames:
            continue
        rows["id"].append(utt_id)
        rows["audio"].append(f"{zip_path.as_posix()}:{off}:{length}")
        rows["n_frames"].append(n_frames)
        rows["tgt_text"].append("NA")
        rows["speaker"].append(speaker)
        rows["tgt_lang"].append(tgt_lang)
    df = pd.DataFrame.from_dict(rows)
    tsv_path = out_dir / f"{path_to_yaml.stem}.tsv"
    df.to_csv(tsv_path, sep="\t", index=False)
    return tsv_path


def _main() -> None:
    """Standalone CLI, same flags as the reference script
    (lib/eval_scripts/prepare_custom_dataset.py:155-193)."""
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--path_to_yaml", "-y", type=str, required=True)
    parser.add_argument("--path_to_wavs", "-w", type=str, required=True)
    parser.add_argument("--tgt_lang", "-l", type=str, default="")
    parser.add_argument("--use_audio_input", "-i", type=int, default=0)
    args = parser.parse_args()
    tsv = prepare_custom_dataset(
        args.path_to_yaml, args.path_to_wavs, args.tgt_lang,
        args.use_audio_input,
    )
    print(tsv)


if __name__ == "__main__":
    _main()
