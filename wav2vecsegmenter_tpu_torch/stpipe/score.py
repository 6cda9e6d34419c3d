"""Translation-quality scoring of mWER-aligned hypothesis vs reference.

Behavioral contract: reference lib/eval_scripts/score.py:30-114.  sacreBLEU
is a hard dependency; BERTScore/BLEURT are optional (gated by st_metrics and
import availability, matching conf/inference.yaml:26).

The port's copy of ``wav2vecsegmenter_tpu/stpipe/score.py``
(tests/test_torch_copies.py holds the two equal).
"""

from __future__ import annotations

from typing import List, Tuple


def get_parallel(path_to_ref_txt: str, path_to_hyp_txt: str
                 ) -> Tuple[List[str], List[str]]:
    with open(path_to_ref_txt, encoding="utf-8") as f:
        reference = f.read().splitlines()
    with open(path_to_hyp_txt, encoding="utf-8") as f:
        hypothesis = f.read().splitlines()
    assert len(reference) == len(hypothesis)
    return reference, hypothesis


def score_sacrebleu(path_to_ref_txt: str, path_to_hyp_txt: str):
    import sacrebleu

    reference, hypothesis = get_parallel(path_to_ref_txt, path_to_hyp_txt)
    bleu = sacrebleu.corpus_bleu(hypothesis, [reference])
    ter = sacrebleu.corpus_ter(hypothesis, [reference])
    print(bleu)
    print(ter)
    return bleu


def score_sentence_bleu(path_to_ref_txt: str, path_to_hyp_txt: str,
                        path_to_output: str | None = None) -> list[float]:
    """Per-sentence smoothed BLEU (reference score.py:43-66 uses nltk
    method2; sacrebleu's floor smoothing is the equivalent here)."""
    import sacrebleu

    reference, hypothesis = get_parallel(path_to_ref_txt, path_to_hyp_txt)
    scores = [
        sacrebleu.sentence_bleu(h, [r], smooth_method="floor").score / 100.0
        for r, h in zip(reference, hypothesis)
    ]
    if path_to_output:
        with open(path_to_output, "w") as f:
            f.write("\n".join(str(s) for s in scores))
    return scores


def score_sentence_bertscore(path_to_ref_txt: str, path_to_hyp_txt: str,
                             path_to_output: str | None, lang: str):
    """Per-sentence BERTScore P/R/F1 lists (reference score.py's
    score_sentence_bertscore used by lib/analysis/get_statistics.py:46-51)."""
    try:
        from bert_score import score as bertscore_score
    except ImportError as e:
        raise RuntimeError(
            "bert_score not installed; per-sentence BERTScore unavailable"
        ) from e
    reference, hypothesis = get_parallel(path_to_ref_txt, path_to_hyp_txt)
    p, r, f1 = bertscore_score(hypothesis, reference, lang=lang,
                               rescale_with_baseline=True, verbose=False)
    p, r, f1 = p.tolist(), r.tolist(), f1.tolist()
    if path_to_output:
        with open(path_to_output, "w") as f:
            for row in zip(p, r, f1):
                f.write("\t".join(str(x) for x in row) + "\n")
    return p, r, f1


def score_bertscore(path_to_ref_txt: str, path_to_hyp_txt: str, lang: str):
    try:
        from bert_score import score as bertscore_score
    except ImportError as e:
        raise RuntimeError(
            "bert_score not installed; drop 'bertscore' from st_metrics"
        ) from e
    reference, hypothesis = get_parallel(path_to_ref_txt, path_to_hyp_txt)
    p, r, f1 = bertscore_score(hypothesis, reference, lang=lang,
                               rescale_with_baseline=True, verbose=False)
    return float(p.mean()), float(r.mean()), float(f1.mean())


def score_bleurt(path_to_ref_txt: str, path_to_hyp_txt: str,
                 bleurt_path: str) -> float:
    try:
        from bleurt import score as bleurt_score
    except ImportError as e:
        raise RuntimeError(
            "bleurt not installed; drop 'bleurt' from st_metrics"
        ) from e
    import numpy as np

    reference, hypothesis = get_parallel(path_to_ref_txt, path_to_hyp_txt)
    scorer = bleurt_score.BleurtScorer(bleurt_path)
    return float(np.mean(scorer.score(references=reference,
                                      candidates=hypothesis)))
