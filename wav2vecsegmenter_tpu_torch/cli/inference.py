"""Batch inference CLI: a checkpoint from a training run's outputs ->
custom_segments.yaml over a wav directory.

Counterpart of ``wav2vecsegmenter_tpu/cli/inference.py``, with its override
surface (the repo's ``conf/inference.yaml``; reference inference.py:156-193),
``-m`` sweeps and per-override run directories included:

    python -m wav2vecsegmenter_tpu_torch.cli.inference outputs=/path/run \\
        ckpt=epoch-15_best_eval_f1 algorithm=dac infer_data=... [key=value ...]
    python -m wav2vecsegmenter_tpu_torch.cli.inference -m ... \\
        algorithm.max_segment_length=10,12,14

The checkpoint is ``outputs/<exp_name>/ckpts/<ckpt>`` (``<ckpt>.pt`` too, the
name the port's trainer writes), and the training run's config,
``base_cfg/config.yaml`` (by default ``outputs/.hydra``), is merged under
the CLI's.  The port's train CLI writes that config to
``<exp_name>/.hydra``, as the JAX one does, so for a run trained in
``<dir>`` pass ``outputs=<dir> base_cfg=<dir>/<exp_name>/.hydra``.  Each
job writes to ``results_path``, or to ``outputs/infer_outputs/
<override_dirname>``.  The run is on the first CUDA device and raises
without one; ``+runtime.device=cpu`` asks for the CPU.
``runtime.precision``, ``runtime.quantize``, ``runtime.pack_across_talks``,
``runtime.mesh`` and ``runtime.profile_dir`` act as in the segment CLI.
``log_wandb=true`` logs each job's ``n_segments`` to a wandb run named
``<exp_name>/<run dir name>`` (reference inference.py:171-186; without the
wandb package a warning, and the run goes on: ``core.wandblog``).  pyyaml
is imported inside :func:`main` only.
"""

from __future__ import annotations

from pathlib import Path

from . import common
from .segment import CONF_DIR, segment_to_yaml


def resolve_ckpt_path(config) -> str:
    """``outputs/exp_name/ckpts/ckpt`` (reference inference.py:46-49), or
    that name with ``.pt``, or ``ckpt`` as a path of its own."""
    p = Path(config.outputs) / config.exp_name / "ckpts" / str(config.ckpt)
    for cand in (p, p.with_name(p.name + ".pt"), Path(str(config.ckpt))):
        if cand.is_file():
            return str(cand)
    raise FileNotFoundError(f"checkpoint not found: {p}")


def merge_base(config):
    """The training run's saved config merged under the CLI config
    (reference inference_st_pipe.py:55-57), when there is one."""
    from ..config import load_config, merge

    if config.get("base_cfg"):
        base = Path(config.base_cfg) / "config.yaml"
        if base.exists():
            config = merge(load_config(base), config)
    return config


def wavs_from_dir(config) -> list[Path]:
    """The wavs of ``infer_data.wav_dir``, sorted (reference
    train.py:62-63)."""
    return sorted(Path(config.infer_data.wav_dir).glob("*.wav"))


def resolve_run(config, run_dir):
    """(config, results directory) of one job: the base config merged in;
    ``results_path`` wins over the run directory."""
    config = merge_base(config)
    out_dir = Path(config.get("results_path") or run_dir
                   or Path(config.outputs) / "infer_outputs")
    return config, out_dir


def main(argv: list[str] | None = None):
    """A single run returns the yaml rows; ``-m`` returns one list per
    sweep job."""
    from ..core.runtime import is_rank0
    from ..core.wandblog import init_wandb

    multirun, jobs = common.cli_jobs(CONF_DIR, "inference", argv)
    launched, out = common.launch_if_mesh(__name__, argv,
                                          [c for c, _ in jobs])
    if launched:
        return out
    outputs = []
    for config, run_dir in jobs:
        config, out_dir = resolve_run(config, run_dir)
        run = init_wandb(config, out_dir, name="/".join(
            [str(config.get("exp_name", "infer")), out_dir.name])) \
            if is_rank0() else None
        rows = segment_to_yaml(config, resolve_ckpt_path(config),
                               wavs_from_dir(config), out_dir)
        if run is not None:
            run.log({"n_segments": len(rows)}, step=0)
            run.finish()
        outputs.append(rows)
    return outputs if multirun else outputs[0]


if __name__ == "__main__":
    main()
