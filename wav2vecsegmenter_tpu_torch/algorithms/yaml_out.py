"""custom_segments.yaml output contract.

Row format matches reference lib/segment.py:595-618 exactly:
{duration, offset, rW: 0, uW: 0, speaker_id, wav}; durations/offsets are
seconds rounded to 6 decimals (Segment properties).

The port's copy of ``wav2vecsegmenter_tpu/algorithms/yaml_out.py``
(tests/test_torch_copies.py holds the two equal).
"""

from __future__ import annotations

from .segment import Segment


def update_yaml_content(
    yaml_content: list[dict], segments: list[Segment], wav_name: str
) -> list[dict]:
    """Append this wav's segments (reference lib/segment.py:595-618)."""
    for sgm in segments:
        yaml_content.append(
            {
                "duration": sgm.duration,
                "offset": sgm.offset,
                "rW": 0,
                "uW": 0,
                "speaker_id": "NA",
                "wav": wav_name,
            }
        )
    return yaml_content


def update_tree_yaml_content(
    yaml_content: list[dict],
    tree: list[Segment],
    wav_name: str,
    max_segment_length: float,
    min_segment_length: float,
) -> list[dict]:
    """Append tree nodes within the length window; speaker_id carries the
    node index (reference lib/segment.py:621-650)."""
    for i, sgm in enumerate(tree):
        if sgm.duration > max_segment_length or sgm.duration < min_segment_length:
            continue
        yaml_content.append(
            {
                "duration": sgm.duration,
                "offset": sgm.offset,
                "rW": 0,
                "uW": 0,
                "speaker_id": str(i),
                "wav": wav_name,
            }
        )
    return yaml_content
