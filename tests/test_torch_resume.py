"""The port trainer's lifecycle on the CPU (float32, a tiny backbone from a
local config.json): the training loader from ``task.train_generator``
(``task=shas_fix`` trains on the JAX loop's fixed grid; an unknown target
raises), checkpoint rotation and the best checkpoint across a resume (as
tests/test_resume_bookkeeping.py holds the JAX loop's), and a resumed run
that continues exactly where an uninterrupted one goes, frozen and LNA.
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

from wav2vecsegmenter_tpu_torch.checkpoints.convert import (
    load_reference_checkpoint)
from wav2vecsegmenter_tpu_torch.checkpoints.io import (load_run_state,
                                                       save_run_state)
from wav2vecsegmenter_tpu_torch.cli import train as tcli
from wav2vecsegmenter_tpu_torch.config import compose
from wav2vecsegmenter_tpu_torch.models.shas import SHAS
from wav2vecsegmenter_tpu_torch.train import loop as tloop

from .helpers import make_speechlike_wav, tiny_shas
from .torch_tiny import threads_per_worker  # noqa: F401

RESUME_RTOL = 1e-6  # a resumed run replays the same float32 operations


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three talks (13.3 s, 9.1 s, 5.2 s) with true segments (pandas TSVs,
    as the JAX data prep writes them) and a tiny backbone's config.json."""
    root = tmp_path_factory.mktemp("resume_corpus")
    talks, segments = [], []
    for i, secs in enumerate((13.3, 9.1, 5.2)):
        path = root / f"ted_{i}.wav"
        make_speechlike_wav(path, duration_secs=secs, seed=i)
        talks.append({"id": f"ted_{i}", "path": str(path),
                      "total_frames": int(secs * 16000)})
        for s0 in np.arange(0.2, secs - 1.0, 2.7):
            segments.append({"talk_id": f"ted_{i}", "start": int(s0 * 16000),
                             "end": int(min(s0 + 2.1, secs) * 16000)})
    pd.DataFrame(talks).to_csv(root / "talks.tsv", sep="\t")
    pd.DataFrame(segments).to_csv(root / "segments.tsv", sep="\t")
    (root / "w2v").mkdir()
    (root / "w2v" / "config.json").write_text(
        '{"hidden_size": 64, "num_hidden_layers": 2, '
        '"num_attention_heads": 1, "intermediate_size": 128}')
    return root


def _overrides(root, *extra) -> list[str]:
    talks, segments = root / "talks.tsv", root / "segments.tsv"
    return ["exp_name=run", "batch_size=2", "segment_length=2",
            "update_freq=2", "print_every_steps=100", "learning_rate=1e-3",
            f"task.model.wav2vec_model_name={root / 'w2v'}",
            "task.model.n_transformer_enc_heads=1",
            f"data.train.talk_list={talks}",
            f"data.train.segments_list={segments}",
            f"data.eval.talk_list={talks}",
            f"data.eval.segments_list={segments}",
            "+runtime.device=cpu", *extra]


def _train(root, work, *extra, on_step=None) -> dict:
    config = compose(tcli.CONF_DIR, "train", _overrides(root, *extra))
    return tloop.train(config, work_dir=work, on_step=on_step)


class _Crash(Exception):
    pass


def _crash_at(n: int):
    """on_step that stops the run at its n-th micro-step (1-based)."""
    seen = []

    def on_step(metrics):
        seen.append(1)
        if len(seen) == n:
            raise _Crash
    return on_step


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


@pytest.mark.parametrize("lna", [False, True], ids=["frozen", "lna"])
def test_resumed_run_equals_uninterrupted(corpus, tmp_path, lna):
    """Three epochs in one run against one epoch, a crash in the second's
    first micro-step, and a resume: the same micro-steps' losses and
    grad_norms, the same schedule and the same final parameters."""
    extra = ["max_epochs=3", "keep_last_ckpts=1"]
    if lna:
        extra += ["task.model.finetune_wav2vec=true",
                  "task.model.wav2vec_ft_layers=1"]
    whole = _train(corpus, tmp_path / "whole", *extra)
    first = whole["steps_per_epoch"][0]
    assert len(whole["steps_per_epoch"]) == 3 and first % 2  # a flush
    with pytest.raises(_Crash):
        _train(corpus, tmp_path / "cut", *extra, on_step=_crash_at(first + 1))
    state = load_run_state(tmp_path / "cut" / "run" / "last_state")
    assert state["epoch"] == 1 and state["global_step"] == first
    resumed = _train(corpus, tmp_path / "cut", *extra, "+resume=true")

    assert resumed["start_epoch"] == 1
    assert resumed["total_steps"] == whole["total_steps"]
    assert resumed["steps_per_epoch"] == whole["steps_per_epoch"][1:]
    assert resumed["updates"] == whole["updates"]
    for key in ("loss", "grad_norm"):
        got, want = resumed["history"][key], whole["history"][key][first:]
        assert len(got) == len(want) > 0
        assert _rel(got, want) <= RESUME_RTOL, key
    trained = 0
    for (name, p), (_, q) in zip(resumed["model"].named_parameters(),
                                 whole["model"].named_parameters()):
        assert _rel(p.detach(), q.detach()) <= RESUME_RTOL, name
        trained += p.requires_grad
    assert trained > 0 and (not lna or trained > 20)
    assert resumed["eval"] == whole["eval"]


def test_rotation_and_best_continue_across_resume(corpus, tmp_path):
    """keep_last_ckpts=2 and a pinned best that cannot be beaten: the
    pre-crash checkpoint rotates out after the resume, the best record and
    its file survive, and no second best file appears."""
    work = tmp_path / "w"
    ckpts = work / "run" / "ckpts"
    state_dir = work / "run" / "last_state"
    one = _train(corpus, work, "max_epochs=1", "keep_last_ckpts=2")
    state = load_run_state(state_dir)
    assert state["epoch"] == 1 and state["global_step"] > 0
    assert state["ckpt_list"] == ["epoch-0.pt"]
    assert one["checkpoints"]["ckpt_list"] == ["epoch-0.pt"]
    assert (ckpts / "epoch-0.pt").is_file()
    assert (ckpts / "final.pt").is_file()
    # pin an unbeatable pre-crash best (a best file with its name)
    state["best_score"] = 2.0
    best_name = state["best_checkpoint"] or "epoch-0_best_eval_f1.pt"
    if state["best_checkpoint"] is None:
        (ckpts / best_name).write_bytes((ckpts / "epoch-0.pt").read_bytes())
    state["best_checkpoint"] = best_name
    save_run_state(state_dir, state)

    out = _train(corpus, work, "max_epochs=4", "keep_last_ckpts=2",
                 "+resume=true")
    state2 = load_run_state(state_dir)
    assert state2["epoch"] == 4
    assert state2["global_step"] == state["global_step"] + sum(
        out["steps_per_epoch"])
    assert state2["ckpt_list"] == ["epoch-2.pt", "epoch-3.pt"]
    assert not (ckpts / "epoch-0.pt").exists()
    assert state2["best_score"] == 2.0
    assert state2["best_checkpoint"] == best_name
    assert sorted(p.name for p in ckpts.glob("*_best_*")) == [best_name]
    assert sorted(p.name for p in ckpts.iterdir()) == sorted(
        ["epoch-2.pt", "epoch-3.pt", best_name, "final.pt"])
    assert not list(state_dir.glob("*.tmp"))


def test_step_checkpoints_and_best(corpus, tmp_path):
    """save_every_steps: an eval, then epoch-{n}_step-{s}.pt; every
    checkpoint loads through load_reference_checkpoint; the best file is
    the first of the highest score, named after its checkpoint."""
    out = _train(corpus, tmp_path, "max_epochs=2", "save_every_steps=2",
                 "keep_last_ckpts=100")
    steps = out["steps_per_epoch"]
    want, step = [], 0
    for epoch, n in enumerate(steps):
        for _ in range(n):
            step += 1
            if step % 2 == 0:
                want.append(f"epoch-{epoch}_step-{step}")
        want.append(f"epoch-{epoch}")
    assert [name for name, _ in out["evals"]] == want
    assert out["checkpoints"]["ckpt_list"] == [f"{n}.pt" for n in want]
    scores = [r["eval_f1"] for _, r in out["evals"]]
    best = out["checkpoints"]["best_checkpoint"]
    if max(scores) > 0:
        assert best == f"{want[scores.index(max(scores))]}_best_eval_f1.pt"
        assert out["checkpoints"]["best_score"] == max(scores)
    else:
        assert best is None
    ckpts = tmp_path / "run" / "ckpts"
    model = SHAS(wav2vec_model_name=str(corpus / "w2v"),
                 n_transformer_enc_heads=1)
    load_reference_checkpoint(ckpts / f"{want[-1]}.pt", model,
                              allow_random_wav2vec=True)
    for key, value in out["model"].seg_model.state_dict().items():
        assert torch.equal(model.seg_model.state_dict()[key], value), key


def test_optimizer_and_generator_state_round_trip(corpus, tmp_path):
    """The run state holds the AdamW moments, the counts and the
    accumulation bitwise, and the generator's state."""
    from wav2vecsegmenter_tpu_torch.train.step import AccumulatingAdamW

    params = [torch.nn.Parameter(torch.randn(5, 3)),
              torch.nn.Parameter(torch.randn(4))]
    opt = AccumulatingAdamW(params, 1e-2, 10, 3)
    for _ in range(4):  # one update and a partial accumulation
        opt.update([torch.randn_like(p) for p in params])
    g = torch.Generator().manual_seed(3)
    torch.rand(7, generator=g)
    save_run_state(tmp_path, {"optimizer": opt.state_dict(),
                              "generator": g.get_state()})
    back = load_run_state(tmp_path)
    twin = [torch.nn.Parameter(p.detach().clone()) for p in params]
    opt2 = AccumulatingAdamW(twin, 1e-2, 10, 3)
    opt2.load_state_dict(back["optimizer"])
    g2 = torch.Generator().manual_seed(0)
    g2.set_state(back["generator"])
    assert (opt2.updates, opt2.mini_step) == (opt.updates, opt.mini_step)
    grads = [torch.randn_like(p) for p in params]
    for o in (opt, opt2):
        for _ in range(2):
            o.update(grads)
    for p, q in zip(params, twin):
        assert torch.equal(p, q)
    assert torch.equal(torch.rand(5, generator=g),
                       torch.rand(5, generator=g2))


def test_shas_fix_trains_on_the_jax_loops_grid(corpus, tmp_path,
                                               monkeypatch):
    """task=shas_fix: one epoch's batches, in order, equal the ones the
    JAX loop feeds its train step (device-normalized batches there too)."""
    from wav2vecsegmenter_tpu.config import compose as jcompose
    from wav2vecsegmenter_tpu.config import registry
    from wav2vecsegmenter_tpu.train import loop as jloop

    import tests.helpers as helpers

    monkeypatch.setitem(registry._ALIASES, "lib.models.SHAS",
                        "tests.helpers:_tiny_builder")
    monkeypatch.setattr(helpers, "_tiny_builder",
                        lambda **kwargs: tiny_shas(), raising=False)
    jax_batches, port_batches = [], []
    real_to_device = jloop._batch_to_device

    def record(batch, mesh):
        jax_batches.append(batch)
        return real_to_device(batch, mesh)

    monkeypatch.setattr(jloop, "_batch_to_device", record)
    real_step = tloop.make_train_step

    def recording_step(*args, **kwargs):
        step = real_step(*args, **kwargs)

        def wrapped(batch, pos_weight=None):
            port_batches.append(batch)
            return step(batch, pos_weight)
        return wrapped

    monkeypatch.setattr(tloop, "make_train_step", recording_step)
    common = ["task=shas_fix", "max_epochs=1", "save_ckpts=false"]
    jax_overrides = [o for o in _overrides(corpus, *common)
                     if o != "+runtime.device=cpu"]
    jconfig = jcompose(tcli.CONF_DIR, "train", jax_overrides + [
        "runtime.kernels=xla", "runtime.compute_dtype=float32",
        "runtime.mesh.data=1", "+runtime.device_normalize=true"])
    jloop.train(jconfig, work_dir=tmp_path / "jax")
    out = _train(corpus, tmp_path / "port", *common)
    assert out["steps_per_epoch"] == [len(jax_batches)]
    assert len(port_batches) == len(jax_batches) > 2
    for g, w in zip(port_batches, jax_batches):
        for field in dataclasses.fields(g):
            a, b = getattr(g, field.name), getattr(w, field.name)
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=field.name)
            else:
                assert a == b, field.name


def test_train_generator_from_the_task(corpus):
    """The generator follows task.train_generator: its class, an explicit
    seed, and a refusal of any other target."""
    config = compose(tcli.CONF_DIR, "train", _overrides(
        corpus, "task=shas_fix"))
    gen = tloop.train_generator(config, 2, seed=0)
    assert type(gen).__name__ == "FixedDataloaderGenerator"
    assert not gen.pin_memory

    def grid(*extra, seed=0):
        cfg = compose(tcli.CONF_DIR, "train", _overrides(corpus, *extra))
        g = tloop.train_generator(cfg, 2, seed=seed)
        assert type(g).__name__ == "RandomDataloaderGenerator"
        g.generate()
        return [r[2] for r in g.dataset.rows]

    assert grid(seed=5) == grid("+task.train_generator.seed=5", seed=0)
    assert grid(seed=5) != grid(seed=6)
    config = compose(tcli.CONF_DIR, "train", _overrides(
        corpus, "task.train_generator._target_=lib.dataset.Elsewhere"))
    with pytest.raises(NotImplementedError, match="lib.dataset.Elsewhere"):
        tloop.train_generator(config, 2, seed=0)
