"""The port trainer's in-training ST evaluation (``perform_st_evaluation``)
on the CPU, float32, on the tiny backbone of tests/test_torch_resume.py:
the results carry the ST keys of both st configs (``st_eval``: pDAC,
``st_eval_online``: pTHR) after every evaluation, the run trains exactly as
one without it, and the ST rows equal the JAX ``segment_wavs``'s on the
weights of the checkpoint the port saved.
"""

import numpy as np
import pytest
import torch
import yaml

from wav2vecsegmenter_tpu_torch.train import loop as tloop

from .test_torch_resume import RESUME_RTOL, _rel, _train, corpus  # noqa: F401
from .test_torch_stpipe import fake_fairseq, st_corpus
from .torch_tiny import threads_per_worker  # noqa: F401

TALKS = {"ted_0.wav": 13.3, "ted_1.wav": 9.1}


def _st_overrides(root) -> list[str]:
    data = st_corpus(root, TALKS)
    out = ["perform_st_evaluation=true"]
    for key in ("st_eval", "st_eval_online"):
        out += [f"{key}.infer_data.{k}={v}" for k, v in data.items()]
        out += [f"{key}.st_model_dir={root}/stmodel", f"{key}.st_ckpt=c.pt",
                f"{key}.fairseq_root={root}", f"{key}.st_metrics=[bleu]",
                f"{key}.algorithm.max_segment_length=4"]
    return out


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """One epoch with an evaluation every 3 micro-steps and at its end,
    without and with the ST evaluation (a fake fairseq-generate on PATH):
    (the two runs' outputs, the work dir of the second, its overrides)."""
    root = tmp_path_factory.mktemp("st_train")
    with pytest.MonkeyPatch.context() as mp:
        fake_fairseq(root / "bin", mp)
        st = _st_overrides(root / "st_data")
        extra = ["max_epochs=1", "save_every_steps=3", "keep_last_ckpts=100"]
        plain = _train(corpus, root / "plain", *extra)
        with_st = _train(corpus, root / "st", *extra, *st)
    return plain, with_st, root / "st", st


def test_st_eval_trains_as_without_it(runs):
    """Each evaluation carries eval_st_n_segments_{dac,pthr} and
    eval_st_bleu_{dac,pthr}, and its files under eval_st/<name>/<algo>;
    the losses, grad norms and final parameters equal those of the same
    run without the ST evaluation, and so does the dropout generator."""
    plain, st, work, _ = runs
    assert [n for n, _ in st["evals"]] == [n for n, _ in plain["evals"]]
    assert len(st["evals"]) >= 2
    keys = {f"eval_st_{m}_{a}" for m in ("n_segments", "bleu")
            for a in ("dac", "pthr")}
    for (name, got), (_, want) in zip(st["evals"], plain["evals"]):
        assert set(got) == set(want) | keys, name
        assert {k: got[k] for k in want} == want, name
        assert got["eval_st_n_segments_dac"] >= len(TALKS)
        for algo in ("dac", "pthr"):
            assert (work / "run" / "eval_st" / name / algo
                    / "score.sacrebleu").is_file()
    for key in ("loss", "grad_norm"):
        got, want = st["history"][key], plain["history"][key]
        assert len(got) == len(want) > 0
        assert _rel(got, want) <= RESUME_RTOL, key
    for (name, p), (_, q) in zip(st["model"].named_parameters(),
                                 plain["model"].named_parameters()):
        assert _rel(p.detach(), q.detach()) <= RESUME_RTOL, name
    assert torch.equal(st["generator"].get_state(),
                       plain["generator"].get_state())


def test_st_rows_equal_jax_on_the_saved_checkpoint(corpus, runs):
    """The last evaluation's ST rows (its custom_segments.yaml, both
    algorithms) equal the JAX segment_wavs's at the st configs' batch 1 on
    the weights of the checkpoint the port saved with that evaluation (the
    head it holds, the backbone's seeded weights), which the JAX package
    reads from the port's full state_dict; a wav dir that is missing is
    skipped."""
    from wav2vecsegmenter_tpu.checkpoints.torch_convert import (
        convert_reference_checkpoint, load_torch_state_dict)
    from wav2vecsegmenter_tpu.cli.common import segment_wavs as jax_segment
    from wav2vecsegmenter_tpu.cli.common import wavs_from_dir
    from wav2vecsegmenter_tpu.config import Config as JConfig
    from wav2vecsegmenter_tpu.config import compose as jcompose
    from wav2vecsegmenter_tpu.config import merge as jmerge
    from wav2vecsegmenter_tpu.models.shas import SHAS as JaxSHAS
    from wav2vecsegmenter_tpu_torch.checkpoints.convert import (
        load_reference_checkpoint)
    from wav2vecsegmenter_tpu_torch.cli import train as tcli
    from wav2vecsegmenter_tpu_torch.cli.common import build_model
    from wav2vecsegmenter_tpu_torch.models.wav2vec2 import init_from_numpy

    from .test_torch_resume import _overrides

    _, out, tmp_path, st = runs
    name = out["evals"][-1][0]
    assert name == "epoch-0"

    # the checkpoint's weights: a fresh model with the backbone's seeded
    # weights and the saved head, as a full state_dict
    task = out["model"]
    fresh, _ = build_model({"model": {
        "wav2vec_model_name": str(corpus / "w2v"),
        "n_transformer_enc_heads": 1}}, torch.device("cpu"))
    init_from_numpy(fresh, 0)
    load_reference_checkpoint(tmp_path / "run" / "ckpts" / f"{name}.pt",
                              fresh, allow_random_wav2vec=True)
    for key, value in task.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], value), key
    torch.save({"state_dict": fresh.state_dict()}, tmp_path / "full.pt")
    jm = JaxSHAS(wav2vec_model_name=str(corpus / "w2v"),
                 n_transformer_enc_heads=1, init_dropout=0.0,
                 finetune_wav2vec=True)
    params = convert_reference_checkpoint(
        load_torch_state_dict(tmp_path / "full.pt"), jm)

    jconfig = jcompose(tcli.CONF_DIR, "train", [
        o for o in _overrides(corpus, *st) if o != "+runtime.device=cpu"])
    for key, algo in (("st_eval", "dac"), ("st_eval_online", "pthr")):
        seg_cfg = jmerge(JConfig({"task": jconfig.task}), jconfig[key])
        rows = jax_segment(seg_cfg, jm, params, None,
                           wavs_from_dir(jconfig[key]), np.float32)
        got = (tmp_path / "run" / "eval_st" / name / algo
               / "custom_segments.yaml").read_text()
        assert got == yaml.dump(rows, default_flow_style=True)
        assert len(rows) >= len(TALKS)

    # a missing wav dir: that key is skipped, the other runs
    from wav2vecsegmenter_tpu_torch.config import compose

    cfg = compose(tcli.CONF_DIR, "train", _overrides(
        corpus, *st, f"st_eval.infer_data.wav_dir={tmp_path}/none"))
    engine = tloop.WindowInference(fresh, torch.device("cpu"), torch.float32)
    fresh.train()
    segs = tloop.st_eval_segments(cfg, fresh, engine)
    assert list(segs) == ["st_eval_online"] and fresh.training
    assert segs["st_eval_online"][0] == "pthr"


def test_st_eval_segments_leave_the_trainer_as_it_was(corpus, tmp_path):
    """The device part alone: eval mode and no grad inside, the model's
    mode restored, nothing drawn from the global generator, each key's
    rows those of segment_wavs at its st config's settings."""
    from wav2vecsegmenter_tpu_torch.cli import train as tcli
    from wav2vecsegmenter_tpu_torch.cli.common import build_model, segment_wavs
    from wav2vecsegmenter_tpu_torch.config import compose, to_plain
    from wav2vecsegmenter_tpu_torch.models.wav2vec2 import init_from_numpy

    from .test_torch_resume import _overrides

    cfg = compose(tcli.CONF_DIR, "train", _overrides(
        corpus, *_st_overrides(tmp_path)))
    model, _ = build_model({"model": {
        "wav2vec_model_name": str(corpus / "w2v"),
        "n_transformer_enc_heads": 1}}, torch.device("cpu"))
    init_from_numpy(model, 3)
    engine = tloop.WindowInference(model, torch.device("cpu"), torch.float32)
    modes = []
    real = engine.run_batch

    def run_batch(batch, need_logits=False):
        modes.append((model.training, torch.is_grad_enabled()))
        return real(batch, need_logits)

    engine.run_batch = run_batch
    model.train()
    state = torch.random.get_rng_state()
    segs = tloop.st_eval_segments(cfg, model, engine)
    assert torch.equal(state, torch.random.get_rng_state())
    assert model.training and modes and set(modes) == {(False, False)}
    assert list(segs) == ["st_eval", "st_eval_online"]
    model.eval()
    for key, (algorithm, rows) in segs.items():
        st_cfg = cfg[key]
        assert algorithm == st_cfg.algorithm.tag
        assert rows == segment_wavs(
            model, sorted((tmp_path / "wav").glob("*.wav")),
            to_plain(st_cfg.algorithm), 1, 20.0, 1, torch.device("cpu"),
            torch.float32) and rows
