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
``runtime.precision``, ``runtime.quantize`` and
``runtime.pack_across_talks`` act as in the segment CLI.  The options of the
JAX CLI that the port does not carry out (``common.UNPORTED["inference"]``:
the segment CLI's and wandb) raise when set away from their defaults,
before any job runs.  pyyaml is imported inside :func:`main` only.
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
    multirun, jobs = common.cli_jobs(CONF_DIR, "inference", argv)
    outputs = []
    for config, run_dir in jobs:
        config, out_dir = resolve_run(config, run_dir)
        outputs.append(segment_to_yaml(config, resolve_ckpt_path(config),
                                       wavs_from_dir(config), out_dir))
    return outputs if multirun else outputs[0]


if __name__ == "__main__":
    main()
