"""Shared optional wandb integration.

The port's copy of ``wav2vecsegmenter_tpu/core/wandblog.py``
(tests/test_torch_copies.py holds the two equal).  The reference wandb-logs
on every entry point: training (train.py:224-232, step metrics :529-539),
batch inference (inference.py:171-186) and the ST pipeline's metric tables
(inference_st_pipe.py:162-213).  wandb is an optional dependency: where it
is not installed, ``log_wandb=true`` logs a warning and the run goes on
without it; with ``log_wandb`` false the helpers do nothing.
"""

from __future__ import annotations

import logging
from pathlib import Path

logger = logging.getLogger("wav2vecsegmenter_tpu_torch")


def init_wandb(config, results_path: str | Path, name: str | None = None):
    """Start a wandb run per the reference's init surface; returns the run
    or None (disabled / not installed)."""
    if not config.get("log_wandb"):
        return None
    try:
        import wandb
    except ImportError:
        logger.warning("log_wandb=True but wandb is not installed; disabled")
        return None
    from ..config import to_plain

    return wandb.init(
        project=config.get("project_name", "w2v_segment"),
        config=to_plain(config),
        name=name or config.get("exp_name"),
        notes=config.get("notes"),
        group=config.get("group"),
        tags=config.get("tags"),
        dir=str(results_path),
    )


def st_results_tables(run, wandb_name: str, results: dict, algorithm: str,
                      extra: dict | None = None) -> None:
    """Log ST metrics + one-row result tables, mirroring the reference's
    sweep-analysis artifacts (inference_st_pipe.py:162-213)."""
    if run is None:
        return
    import wandb

    wandb_dict: dict = dict(extra or {})
    bleu = results.get(f"eval_st_bleu_{algorithm}")
    if bleu is not None:
        wandb_dict["bleu"] = bleu
        wandb_dict["bleu_table"] = wandb.Table(
            data=[[wandb_name, f"BLEU = {bleu:.2f}", bleu]],
            columns=["name", "print", "score"],
        )
    p = results.get(f"eval_st_bertscore_p_{algorithm}")
    if p is not None:
        # r/f1 default to nan rather than crashing the post-eval logging on
        # a partial results dict (p alone present)
        r = results.get(f"eval_st_bertscore_r_{algorithm}", float("nan"))
        f1 = results.get(f"eval_st_bertscore_f1_{algorithm}", float("nan"))
        r = float("nan") if r is None else r
        f1 = float("nan") if f1 is None else f1
        s = f"BERTScore (P/R/F1) = {p:.4f}/{r:.4f}/{f1:.4f}"
        wandb_dict.update(bertscore_p=p, bertscore_r=r, bertscore_f1=f1)
        wandb_dict["bertscore_table"] = wandb.Table(
            data=[[wandb_name, s, p, r, f1]],
            columns=["name", "print", "p", "r", "f1"],
        )
    bleurt = results.get(f"eval_st_bleurt_{algorithm}")
    if bleurt is not None:
        wandb_dict["bleurt"] = bleurt
        wandb_dict["bleurt_table"] = wandb.Table(
            data=[[wandb_name, f"BLEURT (Average) = {bleurt:.4f}", bleurt]],
            columns=["name", "print", "score"],
        )
    n_seg = results.get(f"eval_st_n_segments_{algorithm}")
    if n_seg is not None:
        wandb_dict["n_segments"] = n_seg
    run.log(wandb_dict, step=0)
