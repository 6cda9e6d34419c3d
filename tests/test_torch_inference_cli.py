"""The port's batch inference CLI (``cli/inference.py``) against the JAX
package's: a checkpoint from a training run's outputs
(``outputs/<exp>/ckpts/<ckpt>``, the run's config merged from
``base_cfg``), ``-m`` sweeps with one run directory a job, and
``custom_segments.yaml`` byte for byte equal to the JAX CLI's from the same
``.pt``.  The tiny model of tests/helpers, float32; the JAX engine on its
XLA path.  Also the path from the port's trainer: train, then segment from
its checkpoint.
"""

from pathlib import Path

import jax
import pytest
import torch
import yaml

from wav2vecsegmenter_tpu.checkpoints.torch_export import export_torch_checkpoint

from .helpers import make_speechlike_wav, tiny_shas
from .torch_tiny import tiny_builders  # noqa: F401

TALKS = ("talk1.wav", "talk2.wav")
CKPT = "epoch-0_best_eval_f1"


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Two talks (65 s, 41.2 s) and, in each of two outputs dirs (one for
    each CLI), a training run's layout: ``.hydra/config.yaml`` of exp
    ``e2e`` and the tiny model's full-layout ``.pt`` as
    ``e2e/ckpts/epoch-0_best_eval_f1.pt``."""
    from wav2vecsegmenter_tpu.config import compose, save_config

    ws = tmp_path_factory.mktemp("torch_inference")
    (ws / "wav").mkdir()
    make_speechlike_wav(ws / "wav" / TALKS[0], duration_secs=65.0, seed=0)
    make_speechlike_wav(ws / "wav" / TALKS[1], duration_secs=41.2, seed=1)
    orig = [{"duration": d, "offset": 0.0, "speaker_id": "NA", "wav": w}
            for d, w in zip((65.0, 41.2), TALKS)]
    with open(ws / "orig.yaml", "w") as f:
        yaml.dump(orig, f)
    jm = tiny_shas(finetune_wav2vec=True)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    train_cfg = compose(Path(__file__).parents[1] / "conf", "train")
    train_cfg["exp_name"] = "e2e"
    for side in ("jax", "port"):
        out = ws / side
        (out / "e2e" / "ckpts").mkdir(parents=True)
        export_torch_checkpoint(params, jm, out / "e2e" / "ckpts"
                                / f"{CKPT}.pt")
        save_config(train_cfg, out / ".hydra" / "config.yaml")
    return ws


def _args(ws, side, *extra) -> list[str]:
    return [f"outputs={ws / side}", f"infer_data.wav_dir={ws}/wav",
            f"infer_data.orig_seg_yaml={ws}/orig.yaml", "batch_size=3",
            "runtime.compute_dtype=float32", *extra]


JAX_RUNTIME = ("runtime.kernels=xla", "runtime.mesh.data=1")


def _find(root: Path, *parts) -> Path:
    """The one custom_segments.yaml under ``root`` whose run directory (a
    nested path: the override values hold paths) holds every part."""
    found = [p for p in root.rglob("custom_segments.yaml")
             if all(part in str(p.relative_to(root)) for part in parts)]
    assert len(found) == 1, found
    return found[0]


def _yamls(root: Path) -> dict:
    return {str(p.parent.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("custom_segments.yaml"))}


def test_sweep_yaml_equals_jax_cli(workspace, tiny_builders):
    """``-m algorithm.max_segment_length=10,12``: one job a value, in
    sweep order, each under outputs/infer_outputs/<override_dirname>, and
    each job's yaml byte-equal to the JAX CLI's."""
    from wav2vecsegmenter_tpu.cli.inference import main as jax_main
    from wav2vecsegmenter_tpu_torch.cli.inference import main as port_main

    ws = workspace
    sweep = ["-m", f"ckpt={CKPT}.pt", "algorithm=dac",
             "algorithm.max_segment_length=10,12"]
    rows_jax = jax_main(_args(ws, "jax", *sweep, *JAX_RUNTIME))
    rows_port = port_main(_args(ws, "port", *sweep, "+runtime.device=cpu"))
    assert isinstance(rows_port, list) and len(rows_port) == 2
    assert rows_port == rows_jax
    assert rows_port[0] != rows_port[1]  # the sweep changed the segments
    got = _yamls(ws / "port" / "infer_outputs")
    want = _yamls(ws / "jax" / "infer_outputs")
    assert sorted(got) == sorted(want) and len(got) == 2
    for run_dir in got:
        assert "algorithm.max_segment_length=1" in run_dir
        assert "outputs=" not in run_dir and "runtime" not in run_dir
        assert got[run_dir] == want[run_dir]
    for rows in rows_port:
        assert {r["wav"] for r in rows} == set(TALKS)


def test_single_run_takes_the_trainers_name(workspace, tiny_builders):
    """``ckpt=epoch-0_best_eval_f1`` finds the trainer's
    ``epoch-0_best_eval_f1.pt``; a single run writes to its run directory
    the yaml of the sweep's first job."""
    from wav2vecsegmenter_tpu_torch.cli.inference import main as port_main

    ws = workspace
    rows = port_main(_args(ws, "port", f"ckpt={CKPT}", "algorithm=dac",
                           "algorithm.max_segment_length=10",
                           "+runtime.device=cpu"))
    root = ws / "port" / "infer_outputs"
    found = _find(root, f"ckpt={CKPT},", "algorithm.max_segment_length=10")
    saved = found.read_bytes()
    assert yaml.safe_load(saved) == yaml.safe_load(yaml.dump(rows)) and rows
    # the JAX CLI's job of the same value in the sweep above, when it ran
    twin = ws / "jax" / "infer_outputs" / str(found.relative_to(root)).replace(
        f"ckpt={CKPT},", f"ckpt={CKPT}.pt,")
    if twin.exists():
        assert saved == twin.read_bytes()
    with pytest.raises(FileNotFoundError, match="no_such"):
        port_main(_args(ws, "port", "ckpt=no_such", "+runtime.device=cpu"))
    with pytest.raises(ValueError, match="multirun"):
        port_main(_args(ws, "port", f"ckpt={CKPT}",
                        "algorithm.max_segment_length=10,12"))


def test_inference_cli_runs_on_cuda_unless_asked_for_cpu(workspace,
                                                         tiny_builders,
                                                         monkeypatch):
    from wav2vecsegmenter_tpu_torch.cli.inference import main as port_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"\+runtime\.device=cpu"):
        port_main(_args(workspace, "port", f"ckpt={CKPT}",
                        f"+results_path={workspace}/no_gpu"))


def test_segment_cli_sweep(workspace, tiny_builders, tmp_path):
    """The segment CLI's ``-m``: one job a value under
    output_dir/<override_dirname>, each equal to the single run."""
    from wav2vecsegmenter_tpu_torch.cli.segment import main as port_main

    ws = workspace
    args = [f"ckpt_path={ws}/port/e2e/ckpts/{CKPT}.pt",
            f"config_path={ws}/port/.hydra/config.yaml",
            f"infer_data.wav_dir={ws}/wav",
            f"infer_data.orig_seg_yaml={ws}/orig.yaml", "batch_size=3",
            "runtime.compute_dtype=float32", "+runtime.device=cpu",
            f"output_dir={tmp_path}", "algorithm=pthr"]
    rows = port_main(["-m", *args, "algorithm.threshold=0.2,0.8"])
    assert len(rows) == 2 and rows[0] != rows[1]
    for thr, job in zip(("0.2", "0.8"), rows):
        saved = yaml.safe_load(open(_find(tmp_path,
                                          f"algorithm.threshold={thr},")))
        assert saved == yaml.safe_load(yaml.dump(job))
        assert port_main(args + [f"algorithm.threshold={thr}"]) == job


def test_train_then_segment_from_the_runs_checkpoint(tmp_path, monkeypatch):
    """The README's path on the CPU: the port's train CLI writes
    ``run/.hydra/config.yaml`` and ``run/ckpts/epoch-0.pt``; the inference
    CLI takes ``outputs=<dir> base_cfg=<dir>/run/.hydra ckpt=epoch-0``."""
    from wav2vecsegmenter_tpu_torch.cli import train as tcli
    from wav2vecsegmenter_tpu_torch.cli.inference import main as port_main

    monkeypatch.chdir(tmp_path)
    make_speechlike_wav(tmp_path / "t.wav", duration_secs=9.3, seed=4)
    (tmp_path / "talks.tsv").write_text(
        f"\tid\tpath\ttotal_frames\n0\tt\t{tmp_path / 't.wav'}\t148800\n")
    (tmp_path / "segments.tsv").write_text(
        "\ttalk_id\tstart\tend\n0\tt\t3200\t51200\n1\tt\t60000\t120000\n")
    (tmp_path / "w2v").mkdir()
    (tmp_path / "w2v" / "config.json").write_text(
        '{"hidden_size": 64, "num_hidden_layers": 2, '
        '"num_attention_heads": 1, "intermediate_size": 128}')
    tsv = {"talk_list": "talks.tsv", "segments_list": "segments.tsv"}
    split = [f"data.{s}.{k}={tmp_path / name}"
             for s in ("train", "eval") for k, name in tsv.items()]
    tcli.main(["exp_name=run", "batch_size=2", "segment_length=2",
               "max_epochs=1", "update_freq=1", "+runtime.device=cpu",
               f"task.model.wav2vec_model_name={tmp_path / 'w2v'}",
               "task.model.n_transformer_enc_heads=1", *split])
    assert (tmp_path / "run" / "ckpts" / "epoch-0.pt").is_file()
    rows = port_main([f"outputs={tmp_path}",
                      f"base_cfg={tmp_path / 'run' / '.hydra'}",
                      "ckpt=epoch-0", "algorithm=pthr",
                      f"infer_data.wav_dir={tmp_path}",
                      "+allow_random_wav2vec=true", "+runtime.device=cpu"])
    found = _find(tmp_path / "infer_outputs", "algorithm=pthr,ckpt=epoch-0,")
    assert yaml.safe_load(open(found)) == yaml.safe_load(yaml.dump(rows))
    assert rows and {r["wav"] for r in rows} == {"t.wav"}
