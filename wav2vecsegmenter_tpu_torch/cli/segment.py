"""Standalone segmentation CLI: wav dir -> custom_segments.yaml.

Counterpart of ``wav2vecsegmenter_tpu/cli/segment.py``, with its override
surface (the repo's ``conf/segment.yaml`` composed with ``key=value``
overrides, the training run's config merged underneath):

    python -m wav2vecsegmenter_tpu_torch.cli.segment ckpt_path=/path/ckpt.pt \
        config_path=/path/config.yaml output_dir=/path/out [algorithm=dac] ...

The checkpoint is a reference ``.pt`` (either layout).  The run is on the
first CUDA device and raises without one; ``+runtime.device=cpu`` asks for
the CPU.  ``runtime.kernels`` is ``auto`` (hand kernels on CUDA) or
``eager``; ``runtime.compute_dtype`` applies on CUDA, the CPU runs float32.
Sweeps (``-m``) are not ported, and the runtime options of the JAX CLI
that the port does not carry out (``common.UNPORTED``) raise when set away
from their defaults.  pyyaml is imported inside :func:`main` only.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

from . import common

CONF_DIR = Path(__file__).resolve().parents[2] / "conf"


def _override_dirname(overrides: list[str], exclude_keys) -> str:
    """Hydra's ``${hydra.job.override_dirname}``: the overrides sorted by
    key and joined with ',', minus excluded keys and their dotted subkeys."""
    exclude = set(exclude_keys or ())
    items = []
    for ov in overrides:
        key, _, val = ov.partition("=")
        k = key.lstrip("+~")
        if k in exclude or any(k.startswith(e + ".") for e in exclude):
            continue
        items.append((k, f"{k}={val}"))
    return ",".join(s for _, s in sorted(items))


def _wavs_from_yaml(config) -> list[Path]:
    """The talks of the original segmentation yaml, in order."""
    import itertools

    import yaml

    wav_dir = Path(config.infer_data.wav_dir)
    with open(config.infer_data.orig_seg_yaml) as f:
        seg_yaml = yaml.safe_load(f)
    return [wav_dir / wav
            for wav, _ in itertools.groupby(seg_yaml, key=lambda x: x["wav"])]


def main(argv: list[str] | None = None) -> list[dict]:
    import yaml

    from ..checkpoints.convert import load_reference_checkpoint
    from ..config import compose, load_config, merge, resolve, to_plain
    from ..ops.backend import set_kernels

    argv = sys.argv[1:] if argv is None else argv
    if any(a in ("-m", "--multirun") for a in argv):
        raise NotImplementedError("sweeps (-m) are not ported")
    overrides = [a for a in argv if "=" in a and not a.startswith("--")]

    config = compose(CONF_DIR, "segment", overrides, resolve_interp=False)
    common.refuse_unported(config, "segment", CONF_DIR)
    exclude = config.select(
        "hydra.job.config.override_dirname.exclude_keys") or []
    config.update_path("hydra.job.override_dirname",
                       _override_dirname(overrides, exclude))
    config = resolve(config)
    run_dir = config.select("hydra.run.dir")
    if config.get("config_path"):
        config = merge(load_config(config.config_path), config)
    output_dir = Path(config.get("results_path") or run_dir
                      or config.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    logging.basicConfig(level=logging.INFO,
                        format="[%(levelname)s %(asctime)s] %(message)s")

    rt = config.get("runtime") or {}
    set_kernels(rt.get("kernels", "auto"))
    device, dtype = common.runtime_device_dtype(
        rt.get("device", "cuda"), rt.get("compute_dtype", "bfloat16"))
    model = common.build_model(to_plain(config.task.model), device)
    load_reference_checkpoint(
        config.ckpt_path, model,
        allow_random_wav2vec=bool(config.get("allow_random_wav2vec", False)))
    model.eval()

    yaml_content = common.segment_wavs(
        model, _wavs_from_yaml(config), to_plain(config.algorithm),
        int(config.batch_size), float(config.inference_segment_length),
        int(config.inference_times), device, dtype,
        remainder_ladder=bool(rt.get("infer_remainder_ladder", True)))

    common.logger.info("Number of segments: %d", len(yaml_content))
    out = output_dir / config.cust_seg_yaml
    with open(out, "w") as f:
        yaml.dump(yaml_content, f, default_flow_style=True)
    common.logger.info("Saved to [%s].", out)
    return yaml_content


if __name__ == "__main__":
    main()
