"""End-to-end ST pipeline CLI: segment -> fairseq translate -> mWER align ->
BLEU/BERTScore/BLEURT.

Counterpart of ``wav2vecsegmenter_tpu/cli/inference_st_pipe.py``, with its
override surface (the repo's ``conf/inference.yaml``; reference
inference_st_pipe.py:53-214), ``-m`` sweeps and per-override run
directories included:

    python -m wav2vecsegmenter_tpu_torch.cli.inference_st_pipe \\
        outputs=/path/run ckpt=epoch-15_best_eval_f1 algorithm=dac \\
        infer_data=mustc_ende_tst-COMMON [key=value ...]
    python -m wav2vecsegmenter_tpu_torch.cli.inference_st_pipe -m ... \\
        algorithm.max_segment_length=10,12

Each job composes its run as ``cli/inference.py`` does (the training run's
config merged under the CLI's, the checkpoint, the wav dir), segments on the
card (``cli.segment.segment_rows``; ``+runtime.device=cpu`` asks for the
CPU), then hands the rows to ``stpipe.eval_st.eval_st`` with the ST-pipe
command style: the fairseq dataset, ``fairseq-generate`` (an external tool
on ``PATH``, picked by ``st_model_dir``'s name), the mWER realignment and
the scores, written to ``results_path`` or ``outputs/infer_outputs/
<override_dirname>``.  ``runtime.mesh`` and ``runtime.profile_dir`` act
as in ``cli/inference.py``; the host part runs on rank 0.
``log_wandb=true`` logs the scores and one-row result tables to a wandb run
named ``<exp_name>/<run dir name>`` (reference inference_st_pipe.py:
162-213, ``core.wandblog.st_results_tables``).  pyyaml is imported by the
host part only.
"""

from __future__ import annotations

from . import common
from .inference import resolve_ckpt_path, resolve_run, wavs_from_dir
from .segment import CONF_DIR, segment_rows


def main(argv: list[str] | None = None):
    """A single run returns the results dict; ``-m`` returns one dict per
    sweep job."""
    from ..core.runtime import is_rank0
    from ..core.wandblog import init_wandb, st_results_tables
    from ..stpipe.eval_st import eval_st

    multirun, jobs = common.cli_jobs(CONF_DIR, "inference", argv)
    launched, out = common.launch_if_mesh(__name__, argv,
                                          [c for c, _ in jobs])
    if launched:
        return out
    outputs = []
    for config, run_dir in jobs:
        config, results_path = resolve_run(config, run_dir)
        results_path.mkdir(parents=True, exist_ok=True)
        common.init_logging()
        rows = segment_rows(config, resolve_ckpt_path(config),
                            wavs_from_dir(config))
        if not is_rank0():
            outputs.append({})
            continue
        wandb_name = "/".join([str(config.get("exp_name", "st_pipe")),
                               results_path.name])
        run = init_wandb(config, results_path, name=wandb_name)
        results = eval_st(config, rows, results_path, config.algorithm.tag,
                          cmd_style="cli")
        common.logger.info("ST results: %s", results)
        if run is not None:
            st_results_tables(run, wandb_name, results, config.algorithm.tag,
                              extra={"n_segments": len(rows)})
            run.finish()
        outputs.append(results)
    return outputs if multirun else outputs[0]


if __name__ == "__main__":
    main()
