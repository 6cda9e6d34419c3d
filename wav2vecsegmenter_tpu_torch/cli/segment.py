"""Standalone segmentation CLI: wav dir -> custom_segments.yaml.

Counterpart of ``wav2vecsegmenter_tpu/cli/segment.py``, with its override
surface (the repo's ``conf/segment.yaml`` composed with ``key=value``
overrides, the training run's config merged underneath):

    python -m wav2vecsegmenter_tpu_torch.cli.segment ckpt_path=/path/ckpt.pt \
        config_path=/path/config.yaml output_dir=/path/out [algorithm=dac] ...
    python -m wav2vecsegmenter_tpu_torch.cli.segment -m ... \
        algorithm.max_segment_length=10,12

The checkpoint is a reference ``.pt`` (either layout).  The run is on the
first CUDA device and raises without one; ``+runtime.device=cpu`` asks for
the CPU.  ``runtime.kernels`` is ``auto`` (hand kernels on CUDA) or
``eager``; ``runtime.compute_dtype`` applies on CUDA, the CPU runs float32;
``runtime.precision`` picks an arm of the precision ladder (``bf16``,
``f32head``, ``f32res``, ``f32last<k>``, ``f32``); ``runtime.quantize=int8``
runs the encoder's products int8 (``ops.quant``);
``runtime.pack_across_talks=true`` packs consecutive talks' windows into
full batches (``infer.packing``).
A sweep (``-m``) runs one job per combination of the comma-separated
values, each in ``output_dir/<override_dirname>``.

``runtime.mesh`` (``data``, ``model``) runs the segmentation on a mesh
(``parallel.mesh``): started outside a process group, the call runs again
as one rank a device (``core.runtime``; on the CPU, ``+runtime.device=cpu
runtime.mesh.data=2`` runs two gloo ranks), each data rank runs its rows
of every batch, the batch size rounds up to a multiple of the data ranks,
and rank 0 writes the yaml.  ``+runtime.profile_dir=<dir>`` writes a
``torch.profiler`` trace of the first talk there; ``runtime.profile_steps``
is accepted and does nothing, as in the JAX CLI (ROADMAP C22).  pyyaml is
imported inside :func:`main` only.
"""

from __future__ import annotations

from pathlib import Path

from . import common

CONF_DIR = Path(__file__).resolve().parents[2] / "conf"


def segment_rows(config, ckpt_path, wav_paths: list[Path]) -> list[dict]:
    """Load the checkpoint into the task's model and segment ``wav_paths``
    on the runtime's device: the yaml rows.  Shared with
    ``cli/inference.py`` and ``cli/inference_st_pipe.py``."""
    from ..config import to_plain

    rt = config.get("runtime") or {}
    mesh = common.runtime_mesh(config)
    model, vocab, device, dtype = common.load_model(config, ckpt_path, mesh)
    return common.segment_wavs(
        model, wav_paths, to_plain(config.algorithm),
        int(config.batch_size), float(config.inference_segment_length),
        int(config.inference_times), device, dtype,
        remainder_ladder=bool(rt.get("infer_remainder_ladder", True)),
        precision=rt.get("precision"), quantize=rt.get("quantize"),
        pack_across_talks=bool(rt.get("pack_across_talks", False)),
        loss_tag=config.task.loss.tag, vocab=vocab, mesh=mesh,
        profile_dir=rt.get("profile_dir"))


def segment_to_yaml(config, ckpt_path, wav_paths: list[Path],
                    output_dir: Path) -> list[dict]:
    """:func:`segment_rows`, written to ``output_dir/<cust_seg_yaml>`` by
    rank 0 of a mesh; returns the yaml rows.  Shared with
    ``cli/inference.py``."""
    import yaml

    from ..core.runtime import is_rank0

    output_dir.mkdir(parents=True, exist_ok=True)
    common.init_logging()
    yaml_content = segment_rows(config, ckpt_path, wav_paths)
    common.logger.info("Number of segments: %d", len(yaml_content))
    if not is_rank0():
        return yaml_content
    out = output_dir / config.cust_seg_yaml
    with open(out, "w") as f:
        yaml.dump(yaml_content, f, default_flow_style=True)
    common.logger.info("Saved to [%s].", out)
    return yaml_content


def main(argv: list[str] | None = None):
    """A single run returns the yaml rows; ``-m`` returns one list per
    sweep job."""
    from ..config import load_config, merge

    multirun, jobs = common.cli_jobs(CONF_DIR, "segment", argv)
    launched, out = common.launch_if_mesh(__name__, argv,
                                          [c for c, _ in jobs])
    if launched:
        return out
    outputs = []
    for config, run_dir in jobs:
        if config.get("config_path"):
            config = merge(load_config(config.config_path), config)
        output_dir = Path(config.get("results_path") or run_dir
                          or config.output_dir)
        outputs.append(segment_to_yaml(config, config.ckpt_path,
                                       common.wavs_from_yaml(config),
                                       output_dir))
    return outputs if multirun else outputs[0]


if __name__ == "__main__":
    main()
