"""Corpus preparation: MuST-C-style yaml + wav dir -> talks/segments TSVs.

In-repo replacement for the external SHAS ``prepare_dataset_for_segmentation``
the reference shells out to (runs/prep_mustc.sh:8-12,
lib/prepare_synthetic_data.py:379-388).  Output contract matches what the
reference dataset layer reads (lib/dataset.py:36-41):
  * ``{split}_talks.tsv``:    index, id, path, total_frames
  * ``{split}_segments.tsv``: index, talk_id, start, end   (input-space frames)

The port's copy of ``wav2vecsegmenter_tpu/data/prep.py``, pandas and pyyaml
imported inside :func:`prepare_dataset_for_segmentation`
(tests/test_torch_copies.py holds the two equal).
"""

from __future__ import annotations

from pathlib import Path

from ..constants import INPUT_SAMPLE_RATE
from .audio import wav_info


def prepare_dataset_for_segmentation(
    yaml_path: str | Path,
    wav_dir: str | Path,
    output_dir: str | Path,
    split: str | None = None,
    txt_path: str | Path | None = None,
) -> tuple[Path, Path]:
    """Build the talks/segments TSV pair for a corpus split.

    ``txt_path``: optional MuST-C transcript file (one line per yaml
    segment, e.g. ``train.en``); when given, segments.tsv gains a
    ``tgt_text`` column — the transcript source for the CTC task the
    reference planned but never wired (lib/dataset.py:45)."""
    import pandas as pd
    import yaml

    yaml_path = Path(yaml_path)
    wav_dir = Path(wav_dir)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    split = split or yaml_path.stem

    with open(yaml_path) as f:
        rows = yaml.safe_load(f)

    texts = None
    if txt_path is not None:
        texts = Path(txt_path).read_text().splitlines()
        assert len(texts) == len(rows), (
            f"{txt_path}: {len(texts)} lines vs {len(rows)} yaml segments")

    talks: dict[str, dict] = {}
    seg_rows = []
    for i, r in enumerate(rows):
        wav = r["wav"]
        talk_id = Path(wav).stem
        if talk_id not in talks:
            path = wav_dir / wav
            total_frames, sr, _ = wav_info(path)
            assert sr == INPUT_SAMPLE_RATE, f"{path}: sample rate {sr}"
            talks[talk_id] = {
                "id": talk_id,
                "path": str(path),
                "total_frames": int(total_frames),
            }
        start = int(round(float(r["offset"]) * INPUT_SAMPLE_RATE))
        end = start + int(round(float(r["duration"]) * INPUT_SAMPLE_RATE))
        end = min(end, talks[talk_id]["total_frames"])
        seg = {"talk_id": talk_id, "start": start, "end": end}
        if texts is not None:
            seg["tgt_text"] = texts[i].strip()
        seg_rows.append(seg)

    talks_df = pd.DataFrame(list(talks.values()))
    segments_df = pd.DataFrame(seg_rows)

    talks_tsv = output_dir / f"{split}_talks.tsv"
    segments_tsv = output_dir / f"{split}_segments.tsv"
    talks_df.to_csv(talks_tsv, sep="\t")
    segments_df.to_csv(segments_tsv, sep="\t")
    return talks_tsv, segments_tsv
