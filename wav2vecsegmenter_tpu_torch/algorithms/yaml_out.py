"""custom_segments.yaml output contract.

Row format matches reference lib/segment.py:595-618 exactly:
{duration, offset, rW: 0, uW: 0, speaker_id, wav}; durations/offsets are
seconds rounded to 6 decimals (Segment properties).

The port's copy of ``update_yaml_content`` of
``wav2vecsegmenter_tpu/algorithms/yaml_out.py`` (tests/test_torch_copies.py
holds the two equal).
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
