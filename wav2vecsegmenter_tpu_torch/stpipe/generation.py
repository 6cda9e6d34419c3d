"""fairseq-generate output parsing.

Behavioral contract: reference lib/eval_scripts/format_generation_output.py
(:5-36) — collect D-<i> hypothesis lines, restore dataset order, write
``*_formatted.txt`` next to the input.

The port's copy of ``wav2vecsegmenter_tpu/stpipe/generation.py``
(tests/test_torch_copies.py holds the two equal).
"""

from __future__ import annotations

from pathlib import Path


def format_generation_output(path_to_generation_file) -> Path:
    path = Path(path_to_generation_file)
    raw, order = [], []
    with open(path, encoding="utf8") as f:
        for line in f.read().splitlines():
            if line[:2] == "D-":
                order.append(int(line.split(maxsplit=1)[0].split("D-")[-1]))
                parts = line.split(maxsplit=2)
                raw.append(parts[2] if len(parts) == 3 else "")
    raw = [gen for _, gen in sorted(zip(order, raw))]
    out = Path("_formatted.".join(str(path).rsplit(".", maxsplit=1)))
    with open(out, "w", encoding="utf8") as f:
        for line in raw:
            f.write(line + "\n")
    return out
