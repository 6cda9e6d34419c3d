"""The port's frozen-backbone trainer (wav2vecsegmenter_tpu_torch.train and
its data, model and eval pieces) against the JAX package.

Shared weights go JAX ``init`` -> numpy -> the port at the tiny config of
``tests/helpers`` (2 layers, dropout 0, SpecAugment off for parity); the
JAX train step runs its Pallas kernels in interpret mode.  Random masks
cannot match the JAX bits, so dropout and SpecAugment are held to their
properties and to the JAX sampler's distribution.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wav2vecsegmenter_tpu.data import datasets as jds
from wav2vecsegmenter_tpu.data import loader as jloader
from wav2vecsegmenter_tpu.models import wav2vec2 as jw2v
from wav2vecsegmenter_tpu.models.shas import SHAS as JaxSHAS
from wav2vecsegmenter_tpu.ops.backend import set_backend
from wav2vecsegmenter_tpu.train import step as jstep
from wav2vecsegmenter_tpu.train.loss import BCEWithLogitsLoss as JBCE
from wav2vecsegmenter_tpu.train.loss import FocalLoss as JFocal
from wav2vecsegmenter_tpu.train.loss import moving_average_jax
from wav2vecsegmenter_tpu_torch.checkpoints.convert import (
    load_reference_checkpoint, state_dict_from_jax_params)
from wav2vecsegmenter_tpu_torch.cli import train as tcli
from wav2vecsegmenter_tpu_torch.data import datasets as tds
from wav2vecsegmenter_tpu_torch.data import loader as tloader
from wav2vecsegmenter_tpu_torch.data.collate import collate, out_len_for
from wav2vecsegmenter_tpu_torch.eval.metrics import _scores
from wav2vecsegmenter_tpu_torch.models import wav2vec2 as tw2v
from wav2vecsegmenter_tpu_torch.models.shas import SHAS
from wav2vecsegmenter_tpu_torch.train import loss as tloss
from wav2vecsegmenter_tpu_torch.train import step as tstep

from .helpers import TINY_W2V, make_speechlike_wav
from .torch_tiny import threads_per_worker  # noqa: F401

CFG = dataclasses.replace(TINY_W2V, apply_spec_augment=False)
LR, TOTAL_STEPS, POS_WEIGHT = 1e-3, 10, 0.3
LOSS_RTOL = 1e-5    # float32 forward, different summation orders
GNORM_RTOL = 1e-4   # the norm after an update: parameters differ by <2e-5
PARAM_ATOL = 2e-5   # head parameters after the steps (float32)
KEY_BIAS = "seg_model.transformer.layers.0.self_attn.in_proj_bias"


def _models():
    jm = JaxSHAS(wav2vec_keep_layers=2, n_transformer_enc_layers=1,
                 n_transformer_enc_heads=4, init_dropout=0.0)
    jm.w2v_cfg, jm.d_model, jm.keep_layers = CFG, CFG.hidden_size, 2
    tm = SHAS(wav2vec_keep_layers=2, n_transformer_enc_layers=1,
              n_transformer_enc_heads=4, init_dropout=0.0,
              w2v_cfg=tw2v.Wav2Vec2Config(**dataclasses.asdict(CFG)))
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tm.load_state_dict(state_dict_from_jax_params(params, tm), strict=True)
    return jm, tm, params


def _batches(n: int):
    """n device-normalize batches of 3 rows: two speech windows with
    targets and a padding row."""
    rng = np.random.RandomState(1)
    out = []
    for _ in range(n):
        examples = []
        for length in (16000, 11000):
            n_out = out_len_for(length)
            target = np.zeros(n_out, np.float32)
            start = rng.randint(0, n_out // 2)
            target[start:start + n_out // 3] = 1.0
            examples.append(((rng.randn(length) * 0.1).astype(np.float32),
                             target, 0, n_out))
        out.append(collate(examples, 3, 16000, out_len_for(16000),
                           device_normalize=True))
    return out


def _jax_batch(b) -> dict:
    return {"audio": b.audio, "in_lengths": b.in_lengths, "target": b.target,
            "out_mask": b.out_mask, "included": b.included,
            "norm_length": np.int32(b.norm_length),
            "pos_weight": np.float32(POS_WEIGHT)}


@pytest.mark.parametrize("n_steps,update_freq,ma", [(1, 1, 0), (3, 2, 5)])
def test_train_steps_match_jax(n_steps, update_freq, ma):
    """Micro-steps (and, with update_freq=2, the epoch-end flush of the
    third) against make_train_step / make_accum_flush / make_optimizer:
    loss, grad_norm, every head parameter after the steps; the frozen
    backbone does not move."""
    jm, tm, params = _models()
    batches = _batches(n_steps)
    set_backend("pallas")
    try:
        with pltpu.force_tpu_interpret_mode():
            opt = jstep.make_optimizer(LR, TOTAL_STEPS, update_freq,
                                       jm.trainable_mask(params))
            state = jstep.init_train_state(
                jm, opt, jax.random.PRNGKey(1),
                jax.tree.map(jnp.asarray, params))
            step = jstep.make_train_step(jm, JBCE(None), "bce", ma, opt,
                                         device_normalize=True,
                                         dynamic_pos_weight=True)
            flush = jstep.make_accum_flush(opt)
            want = []
            for i, b in enumerate(batches):
                state, m = step(state, _jax_batch(b), jax.random.PRNGKey(i))
                want.append((float(m["loss"]), float(m["grad_norm"])))
            if flush is not None:
                state = flush(state)
            jparams = jax.device_get(state.params)
    finally:
        set_backend("auto")

    backbone = {k: v.clone() for k, v in
                tm.wav2vec_model.state_dict().items()}
    head = {k: v.clone() for k, v in tm.seg_model.state_dict().items()}
    opt = tstep.AccumulatingAdamW(tm.trainable_parameters(), LR,
                                  TOTAL_STEPS, update_freq)
    step = tstep.make_train_step(tm, tloss.BCEWithLogitsLoss(None), ma, opt)
    got = []
    for b in batches:
        m = step(b, POS_WEIGHT)
        got.append((float(m["loss"]), float(m["grad_norm"])))
    # the epoch-end flush applies the third micro-step, then nothing
    assert opt.flush() == (n_steps % update_freq > 0)
    assert not opt.flush()
    assert opt.updates == -(-n_steps // update_freq)

    for (gl, gn), (wl, wn) in zip(got, want):
        np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(gn, wn, rtol=GNORM_RTOL)
    ref = state_dict_from_jax_params(jparams, tm)
    for key, value in tm.state_dict().items():
        if not key.startswith("seg_model."):
            continue
        moved = (value - head[key[len("seg_model."):]]).abs().max()
        assert moved > 10 * PARAM_ATOL, key
        diff = (value - ref[key]).abs()
        if key == KEY_BIAS:
            # the key bias's gradient is 0 in exact arithmetic (softmax is
            # shift-invariant): Adam turns either side's roundoff into steps
            # of up to lr, so its part is bounded by 2 lr an update
            h = tm.w2v_cfg.hidden_size
            assert diff[h:2 * h].max() <= 2 * LR * opt.updates, key
            diff = torch.cat([diff[:h], diff[2 * h:]])
        assert diff.max() <= PARAM_ATOL, (key, diff.max().item())
    for key, value in tm.wav2vec_model.state_dict().items():
        assert torch.equal(value, backbone[key]), key


def test_losses_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(4, 60).astype(np.float32) * 3
    z = (rng.rand(4, 60) > 0.6).astype(np.float32)
    xt, zt = torch.from_numpy(x), torch.from_numpy(z)
    for pw in (None, 0.7):
        np.testing.assert_allclose(
            tloss.BCEWithLogitsLoss(pw)(xt, zt).numpy(),
            np.asarray(JBCE(pw)(jnp.asarray(x), jnp.asarray(z))),
            rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(
            tloss.BCEWithLogitsLoss(pw)(xt, zt),
            torch.nn.functional.binary_cross_entropy_with_logits(
                xt, zt, reduction="none",
                pos_weight=None if pw is None else torch.tensor(pw)))
    np.testing.assert_allclose(
        tloss.FocalLoss(0.9, 2.0)(xt, zt).numpy(),
        np.asarray(JFocal(0.9, 2.0)(jnp.asarray(x), jnp.asarray(z))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tloss.moving_average(zt, 5).numpy(),
                               np.asarray(moving_average_jax(z, 5)),
                               rtol=1e-6)
    loss_fn, tag, ma = tloss.build_loss(
        {"_target_": "torch.nn.BCEWithLogitsLoss", "tag": "bce",
         "pos_weight": None, "ma_window": None, "reduction": "none"}, 0.8)
    assert tag == "bce" and ma == 0.0
    assert abs(loss_fn.pos_weight - 0.2) < 1e-12
    # the multi-class losses build (tests/test_torch_ssl.py holds them);
    # a target the port does not carry out raises
    loss_fn, tag, _ = tloss.build_loss(
        {"_target_": "torch.nn.CrossEntropyLoss", "tag": "ce"})
    assert tag == "ce" and loss_fn.ignore_index == -100
    with pytest.raises(NotImplementedError):
        tloss.build_loss({"_target_": "lib.loss.Other", "tag": "bce"})


def test_dropout_mask_properties():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200, 500)
    y = tw2v.dropout(x, 0.1, g)
    kept = y != 0
    # 1e5 Bernoulli(0.9) draws: the kept share lies within 5 sigma (0.005)
    assert abs(kept.float().mean().item() - 0.9) < 0.005
    assert torch.all(y[kept] == 1 / 0.9)
    assert tw2v.dropout(x, 0.0, g) is x and tw2v.dropout(x, 0.1, None) is x
    y2 = tw2v.dropout(x, 0.1, torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)
    assert tw2v.dropout(x.bfloat16(), 0.1, g).dtype == torch.bfloat16


def _runs(row: np.ndarray) -> list[tuple[int, int]]:
    edges = np.diff(np.concatenate([[0], row.astype(int), [0]]))
    return list(zip(np.where(edges == 1)[0], np.where(edges == -1)[0]))


@pytest.mark.parametrize("prob", [0.05, 0.0])
def test_time_mask_properties_and_fraction_match_jax(prob):
    """SpecAugment spans lie inside each row's valid length, come in runs
    of at least mask_time_length, at least one span (min_masks) where one
    fits, and mask the same share of frames as the JAX sampler over many
    draws."""
    t, length, draws = 120, 10, 400
    lengths = np.array([120, 83, 40, 12, 9, 0])
    g = torch.Generator().manual_seed(0)
    fl = torch.from_numpy(lengths)
    masks = np.stack([tw2v.sample_time_mask(g, len(lengths), t, prob, length,
                                            fl, 2).numpy()
                      for _ in range(draws)])
    for m in masks:
        for row, n in zip(m, lengths):
            assert not row[n:].any()
            runs = _runs(row)
            assert all(e - s >= length for s, e in runs)
            assert bool(runs) == (n >= length)
    keys = jax.random.split(jax.random.PRNGKey(0), draws)
    jmasks = np.asarray(jax.vmap(lambda k: jw2v.sample_time_mask(
        k, len(lengths), t, prob, length, jnp.asarray(lengths), 2))(keys))
    frac = masks.mean(axis=(0, 2))
    jfrac = jmasks.mean(axis=(0, 2))
    # per-row shares over 400 draws: standard errors below 0.004
    np.testing.assert_allclose(frac, jfrac, atol=0.02)
    assert frac[-1] == 0 and frac[-2] == 0


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three talks (13.3 s, 9.1 s, 5.2 s) with true segments, written as
    the JAX package's data prep writes them (pandas TSVs)."""
    root = tmp_path_factory.mktemp("corpus")
    talks, segments = [], []
    for i, secs in enumerate((13.3, 9.1, 5.2)):
        path = root / f"ted_{i}.wav"
        make_speechlike_wav(path, duration_secs=secs, seed=i)
        n = int(secs * 16000)
        talks.append({"id": f"ted_{i}", "path": str(path), "total_frames": n})
        for s0 in np.arange(0.2, secs - 1.0, 2.7):
            segments.append({"talk_id": f"ted_{i}", "start": int(s0 * 16000),
                             "end": int(min(s0 + 2.1, secs) * 16000)})
    pd.DataFrame(talks).to_csv(root / "talks.tsv", sep="\t")
    pd.DataFrame(segments).to_csv(root / "segments.tsv", sep="\t")
    return str(root / "talks.tsv"), str(root / "segments.tsv")


def _assert_same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got.rows, want.rows):
        assert (g[0], g[1], g[2], g[3]) == (w[0], w[1], w[2], w[3])
        assert g[4] == [tuple(map(int, s)) for s in w[4]]
    for i in range(len(want)):
        for a, b in zip(got[i], want[i]):
            np.testing.assert_array_equal(a, b)


def test_datasets_match_jax(corpus):
    talks, segments = corpus
    for seed in (0, 5):
        got = tds.RandomSegmentationDataset(talks, segments, 4, seed)
        want = jds.RandomSegmentationDataset(talks, segments, 4, seed)
        _assert_same_rows(got, want)
        assert (got.n_pos, got.n_all) == (want.n_pos, want.n_all)
        assert got.pos_class_percentage == want.pos_class_percentage
    got = tds.FixedSegmentationDataset(talks, segments, 4, 2)
    want = jds.FixedSegmentationDataset(talks, segments, 4, 2)
    assert got.corpus.talk_ids() == want.corpus.talk_ids()
    for talk in want.corpus.talk_ids():
        for it in range(2):
            got.generate_fixed_segments(talk, it)
            want.generate_fixed_segments(talk, it)
            assert got.duration_outframes == want.duration_outframes
            _assert_same_rows(got, want)
    got.generate_fixed_segments_all_talks(1)
    want.generate_fixed_segments_all_talks(1)
    _assert_same_rows(got, want)
    labels = np.array([0, 1, 1, 1, 0, 0] * 700 + [1] * 900, np.uint8)
    spans = tds.window_targets(labels)
    assert spans == jds.window_targets(labels)
    np.testing.assert_array_equal(tds.construct_target(spans, len(labels)),
                                  jds.construct_target(spans, len(labels)))


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for field in dataclasses.fields(g):
            a, b = getattr(g, field.name), getattr(w, field.name)
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=field.name)
            else:
                assert a == b, field.name


def test_loaders_match_jax(corpus):
    talks, segments = corpus
    got = tloader.RandomDataloaderGenerator(talks, segments, 4, 3, seed=7)
    want = jloader.RandomDataloaderGenerator(talks, segments, 4, 3,
                                             num_workers=2, seed=7,
                                             device_normalize=True)
    for epoch in range(3):
        if epoch == 2:
            got.skip_epoch_seeds(1)
            want.skip_epoch_seeds(1)
        g, w = got.generate(), want.generate()
        assert len(g) == len(w)
        _assert_same_batches(list(g), list(w))
        assert (got.dataset.pos_class_percentage
                == want.dataset.pos_class_percentage)
    got = tloader.FixedDataloaderGenerator(talks, segments, 4, 3)
    want = jloader.FixedDataloaderGenerator(talks, segments, 4, 3,
                                            num_workers=2,
                                            device_normalize=True)
    assert got.get_talk_ids() == want.get_talk_ids()
    for talk in want.get_talk_ids():
        _assert_same_batches(list(got.generate(talk, 0)),
                             list(want.generate(talk, 0)))


def test_scores_match_sklearn():
    from sklearn.metrics import f1_score, precision_score, recall_score

    rng = np.random.RandomState(0)
    t, p = rng.rand(500) > 0.4, rng.rand(500) > 0.5
    got = _scores(t, p)
    assert got["accuracy"] == pytest.approx(f1_score(t, p, average="micro"))
    assert got["f1"] == pytest.approx(f1_score(t, p))
    assert got["precision"] == pytest.approx(precision_score(t, p))
    assert got["recall"] == pytest.approx(recall_score(t, p))
    none = np.zeros(10, bool)
    assert _scores(none, none) == {"accuracy": 1.0, "f1": 0.0,
                                   "precision": 0.0, "recall": 0.0}


def _cli_args(tmp_path, corpus) -> list[str]:
    """A tiny xls-r-like backbone from a local config.json (2 layers of
    width 64) on the written corpus."""
    talks, segments = corpus
    w2v = tmp_path / "w2v"
    w2v.mkdir()
    (w2v / "config.json").write_text(
        '{"hidden_size": 64, "num_hidden_layers": 2, '
        '"num_attention_heads": 1, "intermediate_size": 128}')
    return ["exp_name=run", "batch_size=2", "segment_length=2",
            "max_epochs=2", "update_freq=2", "print_every_steps=1",
            f"task.model.wav2vec_model_name={w2v}",
            "task.model.n_transformer_enc_heads=1",
            f"data.train.talk_list={talks}",
            f"data.train.segments_list={segments}",
            f"data.eval.talk_list={talks}",
            f"data.eval.segments_list={segments}"]


def test_train_cli_end_to_end_on_cpu(tmp_path, corpus, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = _cli_args(tmp_path, corpus)
    out = tcli.main(args + ["+runtime.device=cpu"])
    hist, steps = out["history"], out["steps_per_epoch"]
    assert len(hist["loss"]) == sum(steps) and len(steps) == 2
    assert any(n % 2 for n in steps)  # an epoch ends mid-accumulation
    assert out["updates"] == sum(-(-n // 2) for n in steps)
    assert np.isfinite(hist["loss"]).all()
    assert np.isfinite(hist["grad_norm"]).all()
    assert set(out["eval"]) == {"eval_loss", "eval_accuracy", "eval_f1",
                                "eval_precision", "eval_recall"}
    assert np.isfinite(list(out["eval"].values())).all()
    assert (tmp_path / "run" / ".hydra" / "config.yaml").is_file()
    model = SHAS(wav2vec_model_name=str(tmp_path / "w2v"),
                 n_transformer_enc_heads=1)
    load_reference_checkpoint(out["checkpoint"], model,
                              allow_random_wav2vec=True)
    saved = torch.load(out["checkpoint"], weights_only=True)["state_dict"]
    assert set(saved) == set(model.seg_model.state_dict())


def test_train_cli_refuses_without_gpu(tmp_path, corpus, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = _cli_args(tmp_path, corpus)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(args)
