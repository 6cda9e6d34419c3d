"""The port's CLIs and trainer on CPU meshes of spawned gloo ranks: the
segment CLI's yaml on a data mesh byte-equal to its single run and to the
JAX CLI's mesh run (``batch_size`` 3 padded to 4), on a model axis too;
int8 on a data mesh equal to int8 alone, and refused under tensor
parallelism; the train CLI launching its own ranks under ``data=2``,
``model=2`` and ``fsdp``, its checkpoints whole (the keys and shapes of a
single-rank run's, the values within the mesh tests' bounds,
tests/test_torch_mesh.py), and a resume under a mesh equal to the
uninterrupted mesh run.
"""

import types

import numpy as np
import pytest
import torch

from wav2vecsegmenter_tpu_torch.cli import train as tcli
from wav2vecsegmenter_tpu_torch.infer.pipeline import WindowInference

from .helpers import make_speechlike_wav
from .torch_mesh import run_ranks
from .torch_tiny import (JAX_SIDE, cli_workspace,  # noqa: F401
                         threads_per_worker, tiny_builders)

TALKS = {"talkA.wav": 11.3, "talkB.wav": 6.2}
PARAM_RTOL, PARAM_ATOL = 5e-2, 1e-3   # tests/test_train.py's mesh bounds
RESUME_RTOL = 1e-6


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    return cli_workspace(tmp_path_factory.mktemp("torch_mesh_cli"), TALKS)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two talks (6.3 s, 4.1 s) with true segments, as
    tests/test_torch_resume.py's corpus, and a tiny backbone of 2 heads
    (the model axis splits them) in a local config.json."""
    import pandas as pd

    root = tmp_path_factory.mktemp("mesh_corpus")
    talks, segments = [], []
    for i, secs in enumerate((6.3, 4.1)):
        path = root / f"ted_{i}.wav"
        make_speechlike_wav(path, duration_secs=secs, seed=i)
        talks.append({"id": f"ted_{i}", "path": str(path),
                      "total_frames": int(secs * 16000)})
        for s0 in np.arange(0.2, secs - 1.0, 1.9):
            segments.append({"talk_id": f"ted_{i}", "start": int(s0 * 16000),
                             "end": int(min(s0 + 1.4, secs) * 16000)})
    pd.DataFrame(talks).to_csv(root / "talks.tsv", sep="\t")
    pd.DataFrame(segments).to_csv(root / "segments.tsv", sep="\t")
    (root / "w2v").mkdir()
    (root / "w2v" / "config.json").write_text(
        '{"hidden_size": 64, "num_hidden_layers": 2, '
        '"num_attention_heads": 2, "intermediate_size": 128}')
    return root


@pytest.fixture
def one_thread_ranks(monkeypatch):
    """Ranks that the CLI launches run their ops on one thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _segment_args(ws, out, *extra) -> list[str]:
    return [f"ckpt_path={ws}/ckpt.pt", f"config_path={ws}/train_config.yaml",
            f"output_dir={out}", f"+results_path={out}",
            f"infer_data.wav_dir={ws}/wav",
            f"infer_data.orig_seg_yaml={ws}/orig.yaml",
            "inference_segment_length=4", "batch_size=3", "algorithm=pthr",
            "runtime.compute_dtype=float32", *extra]


def _port_mesh(ws, tmp, name, n, *extra) -> bytes:
    """The port's segment CLI on ``n`` ranks: rank 0's yaml bytes."""
    out = tmp / name
    ranks = run_ranks({"scenario": "cli", "cli": "segment",
                       "argv": _segment_args(ws, out, "+runtime.device=cpu",
                                             *extra)}, n, tmp / f"{name}_r")
    assert ranks[0] == ranks[1]  # every rank segments the whole sweep
    return (out / "custom_segments.yaml").read_bytes()


def _port_single(ws, tmp, name, *extra) -> bytes:
    from wav2vecsegmenter_tpu_torch.cli.segment import main

    out = tmp / name
    main(_segment_args(ws, out, "+runtime.device=cpu", *extra))
    return (out / "custom_segments.yaml").read_bytes()


def test_segment_cli_data_mesh_yaml_equals_single_and_jax(
        workspace, tiny_builders, tmp_path):
    """``runtime.mesh.data=2``: each rank runs 2 of the 4 rows of every
    batch (3 padded to 4, and each remainder batch of the ladder a multiple
    of 2); the yaml is byte-equal to the port's single run and to the JAX
    CLI's run on a data mesh of 2 host devices."""
    from wav2vecsegmenter_tpu.cli.segment import main as jax_main

    jax_out = tmp_path / "jax"
    jax_main(_segment_args(workspace, jax_out, "runtime.mesh.data=2",
                           *JAX_SIDE))
    want = (jax_out / "custom_segments.yaml").read_bytes()
    assert _port_single(workspace, tmp_path, "single") == want
    assert _port_mesh(workspace, tmp_path, "mesh", 2,
                      "runtime.mesh.data=2") == want


def test_segment_cli_model_axis_yaml_equals_single(workspace, tiny_builders,
                                                   tmp_path):
    """``runtime.mesh.model=2``: the tiny backbone's 4 heads and FFN and the
    head's attention and FFN split over 2 ranks (K3, K5 and K4 on each
    rank's shard on a card); the yaml equals the single run's."""
    want = _port_single(workspace, tmp_path, "single")
    assert _port_mesh(workspace, tmp_path, "tp", 2,
                      "runtime.mesh.data=1", "runtime.mesh.model=2") == want


def test_int8_on_a_data_mesh_equals_int8_alone(workspace, tiny_builders,
                                               tmp_path):
    want = _port_single(workspace, tmp_path, "single",
                        "runtime.quantize=int8")
    assert _port_mesh(workspace, tmp_path, "mesh", 2, "runtime.mesh.data=2",
                      "runtime.quantize=int8") == want


def test_int8_refuses_tensor_parallelism():
    """As the JAX engine (tests/test_quant.py::
    test_engine_int8_rejects_tensor_parallel_and_unknown_mode)."""
    from .torch_mesh_worker import build

    model = build("shas", {}, {})
    mesh = types.SimpleNamespace(n_data=1, n_model=2)
    with pytest.raises(ValueError, match="tensor"):
        WindowInference(model, "cpu", quantize="int8", mesh=mesh)
    with pytest.raises(ValueError, match="unknown quantize"):
        WindowInference(model, "cpu", quantize="fp8")


def _train_overrides(root, batch_size: int, *extra) -> list[str]:
    talks, segments = root / "talks.tsv", root / "segments.tsv"
    return ["exp_name=run", f"batch_size={batch_size}", "segment_length=2",
            "print_every_steps=100", "learning_rate=1e-3",
            f"task.model.wav2vec_model_name={root / 'w2v'}",
            "task.model.n_transformer_enc_heads=2",
            f"data.train.talk_list={talks}",
            f"data.train.segments_list={segments}",
            f"data.eval.talk_list={talks}",
            f"data.eval.segments_list={segments}",
            "+runtime.device=cpu", *extra]


def _final(path) -> dict:
    return torch.load(path, map_location="cpu",
                      weights_only=True)["state_dict"]


# (name, the mesh's overrides, batch a data rank, LNA)
TRAIN_MESHES = [
    ("data", ["runtime.mesh.data=2"], 1, False),
    ("model", ["runtime.mesh.data=1", "runtime.mesh.model=2"], 2, True),
    ("fsdp", ["runtime.mesh.data=2", "+runtime.mesh.fsdp=true"], 1, True),
]


@pytest.mark.parametrize("name,mesh,batch,lna", TRAIN_MESHES,
                         ids=[m[0] for m in TRAIN_MESHES])
def test_train_cli_mesh_checkpoint_equals_single(corpus, tmp_path,
                                                 monkeypatch, one_thread_ranks,
                                                 name, mesh, batch, lna):
    """The train CLI, started outside a group, launches its ranks; its
    ``final.pt`` has the keys and shapes of a single-rank run on the same
    effective batch (2 rows), the values within the mesh bounds, and so
    do its rotated checkpoints and its run state."""
    monkeypatch.chdir(tmp_path)
    extra = ["max_epochs=1", "update_freq=1"]
    if lna:
        extra += ["task.model.finetune_wav2vec=true"]
    (tmp_path / "one").mkdir()
    (tmp_path / "mesh").mkdir()
    monkeypatch.chdir(tmp_path / "one")
    tcli.main(_train_overrides(corpus, 2, *extra))
    monkeypatch.chdir(tmp_path / "mesh")
    out = tcli.main(_train_overrides(corpus, batch, *extra, *mesh))
    assert "model" not in out and out["updates"] > 0
    for rel in ("run/ckpts/final.pt", "run/ckpts/epoch-0.pt"):
        want = _final(tmp_path / "one" / rel)
        got = _final(tmp_path / "mesh" / rel)
        assert list(got) == list(want)
        for key, w in want.items():
            assert got[key].shape == w.shape, key
            bound = PARAM_ATOL + PARAM_RTOL * w.abs()
            assert ((got[key] - w).abs() <= bound).all(), key
    state = torch.load(tmp_path / "mesh" / "run" / "last_state" / "state.pt",
                       weights_only=True)
    ref = torch.load(tmp_path / "one" / "run" / "last_state" / "state.pt",
                     weights_only=True)
    assert {k: v.shape for k, v in state["params"].items()} == \
        {k: v.shape for k, v in ref["params"].items()}
    assert [a.shape for a in state["optimizer"]["acc"]] == \
        [a.shape for a in ref["optimizer"]["acc"]]


def test_resume_under_a_mesh_equals_uninterrupted(corpus, tmp_path):
    """LNA of the tiny SHAS on a (1, 2) mesh: two epochs in one run
    against one epoch, a crash in the second's first micro-step and a
    resume, which splits the whole run state again: the same losses,
    gradient norms and final parameters."""
    extra = ["max_epochs=2", "keep_last_ckpts=1",
             "task.model.finetune_wav2vec=true", "runtime.mesh.data=1",
             "runtime.mesh.model=2"]
    job = {"scenario": "train_loop",
           "overrides": _train_overrides(corpus, 2, *extra)}
    whole = run_ranks({**job, "work": str(tmp_path / "whole")}, 2,
                      tmp_path / "w")[0]
    first = whole["steps_per_epoch"][0]
    cut = run_ranks({**job, "work": str(tmp_path / "cut"),
                     "crash_at": first + 1}, 2, tmp_path / "c")
    assert all(r == {"crashed": True} for r in cut)
    resumed = run_ranks({**job, "work": str(tmp_path / "cut"),
                         "overrides": job["overrides"] + ["+resume=true"]},
                        2, tmp_path / "r")[0]
    assert resumed["start_epoch"] == 1
    for key in ("loss", "grad_norm"):
        got = np.asarray(resumed["history"][key])
        want = np.asarray(whole["history"][key][first:])
        np.testing.assert_allclose(got, want, rtol=RESUME_RTOL)
    for key, value in whole["params"].items():
        torch.testing.assert_close(resumed["params"][key], value,
                                   rtol=RESUME_RTOL, atol=1e-7)
