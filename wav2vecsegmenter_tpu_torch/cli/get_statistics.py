"""Per-sentence statistics: align hyp/ref with the mWER binary interface,
score per-sentence BLEU (+BERTScore when available), emit
``sentence_statistics.tsv``.

Behavioral contract: reference lib/analysis/get_statistics.py:18-76.

Usage: python -m wav2vecsegmenter_tpu_torch.cli.get_statistics <working_dir>
<lang>, where working_dir holds __translation, __mreference and
custom_segments.yaml.

Counterpart of ``wav2vecsegmenter_tpu/cli/get_statistics.py``: host work
only, the alignment through the port's own build of the mWER binary
(``stpipe.mwer``); pyyaml is imported inside :func:`main`.
"""

from __future__ import annotations

import csv
import subprocess
import sys
from pathlib import Path

from ..stpipe.mwer import _ensure_native_built
from ..stpipe.score import (
    get_parallel,
    score_sentence_bertscore,
    score_sentence_bleu,
)


def main(argv=None) -> Path:
    import yaml

    argv = argv if argv is not None else sys.argv[1:]
    working_dir = Path(argv[0])
    lang = argv[1]
    hyp = working_dir / "__translation"
    ref = working_dir / "__mreference"
    yaml_path = working_dir / "custom_segments.yaml"

    results_dir = working_dir / "statistics"
    results_dir.mkdir(parents=True, exist_ok=True)

    binary = _ensure_native_built()
    subprocess.run(
        [str(binary), "-mref", str(hyp), "-hypfile", str(ref),
         "-usecase", "1"],
        cwd=results_dir, check=True,
    )

    bleu = [
        str(s) for s in score_sentence_bleu(
            str(results_dir / "__segments"), str(hyp),
            str(results_dir / "scores.sentence.bleu"),
        )
    ]
    try:
        p, r, f1 = score_sentence_bertscore(
            str(results_dir / "__segments"), str(hyp),
            str(results_dir / "scores.sentence.bertscore"), lang,
        )
        p, r, f1 = ([str(x) for x in v] for v in (p, r, f1))
    except RuntimeError:
        n = len(bleu)
        p = r = f1 = ["NA"] * n

    with open(yaml_path) as f:
        segmentation = yaml.safe_load(f)
    durations = [str(seg["duration"]) for seg in segmentation]

    ref_l, hyp_l = get_parallel(results_dir / "__segments", hyp)

    cols = [
        ["Duration"] + durations,
        ["Hyp"] + hyp_l,
        ["Ref"] + ref_l,
        ["BLEU"] + bleu,
        ["BERTScore(P)"] + list(p),
        ["BERTScore(R)"] + list(r),
        ["BERTScore(F1)"] + list(f1),
    ]
    n_rows = max(len(c) for c in cols)
    cols = [c + [""] * (n_rows - len(c)) for c in cols]
    rows = list(zip(*cols))

    out = results_dir / "sentence_statistics.tsv"
    with open(out, "w", newline="", encoding="utf-8") as f:
        csv.writer(f, delimiter="\t").writerows(rows)
    return out


if __name__ == "__main__":
    main()
