"""Training CLI of the SHAS tasks: the SFC head on a frozen backbone, or
LNA fine-tuning (``task.model.finetune_wav2vec=True``).

Counterpart of ``wav2vecsegmenter_tpu/cli/train.py``, with its override
surface (the repo's ``conf/train.yaml`` composed with ``key=value``
overrides):

    python -m wav2vecsegmenter_tpu_torch.cli.train exp_name=myrun \\
        batch_size=14 task=shas data=mustc_ende [key=value ...]
    python -m wav2vecsegmenter_tpu_torch.cli.train exp_name=myrun ... \\
        +resume=true    # continue from myrun/last_state

The run is on the first CUDA device and raises without one;
``+runtime.device=cpu`` asks for the CPU.  The composed config goes to
``<exp_name>/.hydra/config.yaml`` (the file the segment CLI's
``config_path`` and the inference CLI's ``base_cfg`` read), the run's
checkpoints, its run state and its final model under ``<exp_name>/``
(``train.loop``).  ``runtime.mesh`` (``data``, ``model``, ``fsdp``) trains
on a mesh: started outside a process group, the call runs again as one
rank a device (``core.runtime``; on the CPU ``+runtime.device=cpu
runtime.mesh.data=2`` runs two gloo ranks), and rank 0 writes the files.
``runtime.profile_steps`` and ``log_wandb`` act as in the JAX CLI
(``train.loop``).  pyyaml is imported inside :func:`main` only.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

CONF_DIR = Path(__file__).resolve().parents[2] / "conf"


def main(argv: list[str] | None = None) -> dict:
    import yaml

    from ..config import compose, to_plain
    from ..core.runtime import is_rank0, maybe_init_distributed
    from ..train.loop import train
    from .common import launch_if_mesh

    argv = sys.argv[1:] if argv is None else argv
    overrides = [a for a in argv if "=" in a and not a.startswith("--")]
    config = compose(CONF_DIR, "train", overrides)
    launched, out = launch_if_mesh(__name__, argv, [config])
    if launched:
        return out
    logging.basicConfig(level=logging.INFO,
                        format="[%(levelname)s %(asctime)s] %(message)s")
    import torch

    maybe_init_distributed(torch.device(
        (config.get("runtime") or {}).get("device", "cuda")).type)
    if is_rank0():
        hydra_dir = Path(config.exp_name) / ".hydra"
        hydra_dir.mkdir(parents=True, exist_ok=True)
        with open(hydra_dir / "config.yaml", "w") as f:
            yaml.safe_dump(to_plain(config), f, sort_keys=False)
    return train(config)


if __name__ == "__main__":
    main()
