"""The multi-class heads in the port against the JAX package: SHASWithSSL
(``task=shas_ssl`` / ``shas_ctc``), its checkpoint layouts, the ``ssl``,
``ce`` and ``ctc`` train steps, the engine's precision and int8 arms on
it, and the model builder's ``_target_`` dispatch.

Shared weights go JAX ``init`` -> numpy -> ``state_dict_from_jax_params``
at the tiny geometry of ``tests/helpers`` (2 layers of width 64, a V=36
head, a CTC head of 32); the JAX side runs its XLA path in float32.
``tests/test_torch_dac_logits.py`` holds the logits stitch and the CLIs.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vecsegmenter_tpu.checkpoints import io as jio
from wav2vecsegmenter_tpu.checkpoints.torch_convert import (
    convert_reference_checkpoint)
from wav2vecsegmenter_tpu.data import collate as jcollate
from wav2vecsegmenter_tpu.data import vocab as jvocab
from wav2vecsegmenter_tpu.infer import pipeline as jpipe
from wav2vecsegmenter_tpu.models.shas import SHAS as JaxSHAS
from wav2vecsegmenter_tpu.train import loss as jloss
from wav2vecsegmenter_tpu.train import step as jstep
from wav2vecsegmenter_tpu_torch.checkpoints.convert import (
    load_reference_checkpoint, state_dict_from_jax_params)
from wav2vecsegmenter_tpu_torch.cli import common as tcommon
from wav2vecsegmenter_tpu_torch.config import compose, to_plain
from wav2vecsegmenter_tpu_torch.data import vocab as tvocab
from wav2vecsegmenter_tpu_torch.data.collate import collate, out_len_for
from wav2vecsegmenter_tpu_torch.infer import pipeline as tpipe
from wav2vecsegmenter_tpu_torch.models import wav2vec2 as tw2v
from wav2vecsegmenter_tpu_torch.models.autoreg import AutoRegSegmenter
from wav2vecsegmenter_tpu_torch.models.shas import SHAS, SHASWithSSL
from wav2vecsegmenter_tpu_torch.train import loss as tloss
from wav2vecsegmenter_tpu_torch.train import step as tstep

from .helpers import TINY_W2V
from .test_torch_lna import _is_key_bias
from .test_torch_train import LOSS_RTOL, LR, PARAM_ATOL, TOTAL_STEPS
from .torch_tiny import (jax_tiny_ssl, threads_per_worker,  # noqa: F401
                         port_tiny_ssl, ssl_params)

BOUND = 2e-4  # float32 forward parity, tests/test_torch_model.py's
CONF = Path(__file__).resolve().parents[1] / "conf"
CFG = dataclasses.replace(TINY_W2V, apply_spec_augment=False)


def _pair(cfg=CFG, seed=0, **kwargs):
    jm = jax_tiny_ssl(cfg, **kwargs)
    params = ssl_params(jm, seed)
    tm = port_tiny_ssl(cfg, **kwargs)
    tm.load_state_dict(state_dict_from_jax_params(params, tm), strict=True)
    return jm, params, tm


def _inputs():
    rng = np.random.RandomState(7)
    lengths = np.array([32000, 20000, 0], np.int32)  # full, part, padding
    audio = rng.randn(3, 32000).astype(np.float32)
    audio[np.arange(32000)[None, :] >= lengths[:, None]] = 0.0
    t_out = out_len_for(32000)
    out_mask = np.arange(t_out)[None, :] < np.array([t_out, 62, 0])[:, None]
    return audio, lengths, out_mask


@pytest.mark.parametrize("keep_layers,finetune",
                         [(None, False), (None, True), (1, False)])
def test_ssl_forward_matches_jax(keep_layers, finetune):
    """Both outputs of SHASWithSSL against the JAX apply: the CTC logits
    on each row's valid conv frames (the final encoder LayerNorm and
    lm_head), the 36-way frame logits on out_mask."""
    jm, params, tm = _pair(wav2vec_keep_layers=keep_layers,
                           finetune_wav2vec=finetune)
    assert len(tm.backbone.encoder.layers) == (keep_layers or 2)
    audio, lengths, out_mask = _inputs()
    jc, jf = jm.apply(jax.tree.map(jnp.asarray, params), audio, lengths,
                      out_mask)
    with torch.no_grad():
        tc, tf = tm(torch.from_numpy(audio), torch.from_numpy(lengths),
                    torch.from_numpy(out_mask))
    assert tc.shape == jc.shape and tc.shape[-1] == 32
    assert tf.shape == jf.shape == out_mask.shape + (36,)
    fl = tw2v.frame_lengths(torch.from_numpy(lengths), tm.w2v_cfg).numpy()
    valid = np.arange(tc.shape[1])[None, :] < fl[:, None]
    np.testing.assert_allclose(tc.numpy()[valid], np.asarray(jc)[valid],
                               atol=BOUND, rtol=0)
    np.testing.assert_allclose(tf.numpy()[out_mask], np.asarray(jf)[out_mask],
                               atol=BOUND, rtol=0)


def test_ssl_layouts_carry_the_jax_params(tmp_path, monkeypatch):
    """The port's SSL state_dict, read by the JAX
    convert_reference_checkpoint, gives back the JAX params exactly; a
    head-only file loads its backbone, final LayerNorm and lm_head from a
    local ForCTC snapshot as the JAX loader does, and without one under
    allow_random_wav2vec only (SpecAugment on: the JAX tree then has the
    masked_spec_embed leaf the port's state_dict always carries)."""
    jm, params, tm = _pair(TINY_W2V)
    back = jax.device_get(convert_reference_checkpoint(tm.state_dict(), jm))
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(flat_back[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))

    head = tmp_path / "head.pt"
    torch.save({"state_dict": tm.seg_model.state_dict()}, head)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    fresh = port_tiny_ssl(TINY_W2V)
    with pytest.raises(FileNotFoundError):
        load_reference_checkpoint(head, fresh)
    load_reference_checkpoint(head, fresh, allow_random_wav2vec=True)
    for key, value in tm.seg_model.state_dict().items():
        assert torch.equal(fresh.seg_model.state_dict()[key], value), key
    assert torch.isfinite(fresh.wav2vec_model.model.lm_head.weight).all()

    snap = tmp_path / "lv60"  # a ForCTC snapshot: HF's key layout
    snap.mkdir()
    torch.save(tm.wav2vec_model.model.state_dict(),
               snap / "pytorch_model.bin")
    jm.wav2vec_model_name = str(snap)
    fresh = port_tiny_ssl(TINY_W2V, wav2vec_model_name=str(snap))
    load_reference_checkpoint(head, fresh)
    for key, value in tm.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], value), key
    jloaded = jax.device_get(jio.load_model_checkpoint(jm, head))
    for key, value in state_dict_from_jax_params(jloaded, tm).items():
        np.testing.assert_array_equal(value.numpy(),
                                      fresh.state_dict()[key].numpy(),
                                      err_msg=key)


# ---------------------------------------------------------------- training

# the ssl step mixes CTC logits [B, T_conv] into targets [B, T_out], which
# the JAX package (and so the port) needs equal: true of the 20 s and 22 s
# buckets, and of this one (505 frames both)
AUDIO_LEN = 161600


def _frame_batch(pad: float, transcripts=None, vocab=None):
    """A device-normalize batch of 4 rows in the AUDIO_LEN bucket: windows
    of 161600, 11000 and 3000 samples with targets, and a padding row;
    with ``transcripts`` (one per window) their CTC tokens."""
    rng = np.random.RandomState(1)
    examples = []
    for length in (AUDIO_LEN, 11000, 3000):
        n_out = out_len_for(length)
        target = np.zeros(n_out, np.float32)
        start = rng.randint(0, n_out // 2)
        target[start:start + n_out // 3] = 1.0
        examples.append(((rng.randn(length) * 0.1).astype(np.float32),
                         target, 0, n_out))
    args = (examples, 4, AUDIO_LEN, out_len_for(AUDIO_LEN), pad)
    kw = dict(device_normalize=True, transcripts=transcripts)
    return (collate(*args, **kw, ctc_vocab=vocab),
            jcollate.collate(*args, **kw, ctc_vocab=vocab and
                             jvocab.UppercasedCharVocabulary()))


def _jax_batch(b) -> dict:
    out = {"audio": b.audio, "in_lengths": b.in_lengths, "target": b.target,
           "out_mask": b.out_mask, "included": b.included,
           "norm_length": np.int32(b.norm_length)}
    if b.tokens is not None:
        out["tokens"] = b.tokens
    return out


def _jax_step(jm, params, tag, vocab, batch):
    loss_fn, _, _ = jloss.build_loss(
        {"_target_": {"ctc": "torch.nn.CTCLoss"}.get(
            tag, "torch.nn.CrossEntropyLoss"), "tag": tag}, None, vocab)
    opt = jstep.make_optimizer(LR, TOTAL_STEPS, 1, jm.trainable_mask(params))
    state = jstep.init_train_state(jm, opt, jax.random.PRNGKey(1),
                                   jax.tree.map(jnp.asarray, params))
    step = jstep.make_train_step(jm, loss_fn, tag, 0, opt, vocab=vocab,
                                 device_normalize=True)
    state, m = step(state, _jax_batch(batch), jax.random.PRNGKey(0))
    return (float(m["loss"]), float(m["grad_norm"]),
            jax.device_get(state.params))


def _ce_pair():
    jm = JaxSHAS(wav2vec_keep_layers=2, n_transformer_enc_layers=1,
                 n_transformer_enc_heads=4, init_dropout=0.0, vocab_size=4)
    jm.w2v_cfg, jm.d_model, jm.keep_layers = CFG, CFG.hidden_size, 2
    tm = SHAS(wav2vec_keep_layers=2, n_transformer_enc_layers=1,
              n_transformer_enc_heads=4, init_dropout=0.0, vocab_size=4,
              w2v_cfg=tw2v.Wav2Vec2Config(**dataclasses.asdict(CFG)))
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tm.load_state_dict(state_dict_from_jax_params(params, tm), strict=True)
    return jm, params, tm


# ctc: an encoded transcript, an empty one, and one longer than its row's
# 9 conv frames (truncated to them by collate; no repeated letters, so the
# truncated labels stay feasible)
TRANSCRIPTS = ["HELLO WORLD", "", "ABCDEFGHIJKLMNOPQRST"]


@pytest.mark.parametrize("tag", ["ssl", "ce", "ctc"])
def test_multiclass_steps_match_jax(tag):
    """One micro-step of each multi-class loss against the JAX
    make_train_step: ssl (frozen backbone, CTC pseudo-labels), ce (SHAS
    with BaseVocabulary's 4-way head), ctc (the backbone fine-tuned on
    transcripts): the loss, and every parameter after AdamW's update, the
    frozen ones unchanged.  Where a gradient is 0 in exact arithmetic (the
    key biases: softmax is shift-invariant) Adam turns either side's
    roundoff into a step of up to lr."""
    if tag == "ce":
        vocab, jv = tvocab.BaseVocabulary(), jvocab.BaseVocabulary()
        jm, params, tm = _ce_pair()
    else:
        vocab = tvocab.UppercasedCharVocabulary()
        jv = jvocab.UppercasedCharVocabulary()
        jm, params, tm = _pair(finetune_wav2vec=tag == "ctc")
    batch, jbatch = _frame_batch(
        vocab.pad_token_id, TRANSCRIPTS if tag == "ctc" else None,
        vocab if tag == "ctc" else None)
    if tag == "ctc":
        np.testing.assert_array_equal(batch.tokens, jbatch.tokens)
        assert (batch.tokens[2] != vocab.pad_token_id).sum() == 9
        assert (batch.tokens[1] == vocab.pad_token_id).all()
    want_loss, want_norm, jparams = _jax_step(jm, params, tag, jv, jbatch)

    initial = {k: v.clone() for k, v in tm.state_dict().items()}
    trained = tm.set_requires_grad()
    loss_fn, _, _ = tloss.build_loss(
        {"_target_": {"ctc": "torch.nn.CTCLoss"}.get(
            tag, "torch.nn.CrossEntropyLoss"), "tag": tag}, None, vocab)
    opt = tstep.AccumulatingAdamW(trained, LR, TOTAL_STEPS, 1)
    step = tstep.make_train_step(tm, loss_fn, 0, opt, loss_tag=tag,
                                 vocab=vocab)
    m = step(batch)
    assert m["logits"].shape[-1] == (4 if tag == "ce" else 36)
    np.testing.assert_allclose(float(m["loss"]), want_loss, rtol=LOSS_RTOL)
    if tag == "ssl":
        # the JAX norm also counts the frozen final LayerNorm's gradient
        # (optax.global_norm over every leaf); the port's, the trained set
        assert 0 < float(m["grad_norm"]) <= want_norm
    else:
        np.testing.assert_allclose(float(m["grad_norm"]), want_norm,
                                   rtol=1e-4)
    names = {n for n, p in tm.named_parameters() if p.requires_grad}
    assert names == {n for n, p in tm.named_parameters()
                     if tm._trains(n)}
    ref = state_dict_from_jax_params(jparams, tm)
    h = CFG.hidden_size
    for key, value in tm.state_dict().items():
        if key not in names:
            assert torch.equal(value, initial[key]), key
            if not key.endswith("masked_spec_embed"):
                assert torch.equal(ref[key], initial[key]), key
            continue
        diff = (value - ref[key]).abs()
        if _is_key_bias(key):
            part = slice(h, 2 * h) if "in_proj_bias" in key else slice(None)
            assert (diff[part] <= 2 * LR).all(), key
            diff[part] = 0
        assert diff.max() <= PARAM_ATOL, (key, diff.max().item())


def test_ctc_step_grad_norm_matches_float64():
    """The ctc micro-step of test_multiclass_steps_match_jax against the
    same step on a float64 copy of the model (the loss in float64, as the
    port's CTC runs): grad_norm within 1e-6, relative.  The exact value
    is 432.06729; the JAX package's float32 optax CTC gives 432.05826
    (2.1e-5 off), the port's 432.06730."""
    vocab = tvocab.UppercasedCharVocabulary()
    batch, _ = _frame_batch(vocab.pad_token_id, TRANSCRIPTS, vocab)
    loss_fn, _, _ = tloss.build_loss(
        {"_target_": "torch.nn.CTCLoss", "tag": "ctc"}, None, vocab)
    norms = []
    for dt in (torch.float32, torch.float64):
        tm = _pair(finetune_wav2vec=True)[2].to(dt)
        opt = tstep.AccumulatingAdamW(tm.set_requires_grad(), LR,
                                      TOTAL_STEPS, 1)
        step = tstep.make_train_step(tm, loss_fn, 0, opt, dt,
                                     loss_tag="ctc", vocab=vocab)
        norms.append(float(step(batch)["grad_norm"]))
    np.testing.assert_allclose(norms[0], norms[1], rtol=1e-6)


def test_ctc_with_a_frozen_backbone_raises(tmp_path):
    """The JAX loop's ValueError: the CTC loss reaches no trained
    parameter when the backbone is frozen."""
    from wav2vecsegmenter_tpu_torch.train.loop import train

    cfg = compose(CONF, "train", ["task=shas_ctc",
                                  "task.model.finetune_wav2vec=false",
                                  "+runtime.device=cpu"])
    with pytest.raises(ValueError, match="finetune_wav2vec"):
        train(cfg, tmp_path)


# ------------------------------------------------- the engine on SHASWithSSL

def _examples():
    rng = np.random.RandomState(3)
    wavs = [rng.randn(n).astype(np.float32) * 0.1 for n in (16000, 11000)]
    return [(w, None, 0, int(len(w) * 49.95 / 16000)) for w in wavs]


@pytest.mark.parametrize("arm", ["f32head", "f32res", "f32last1"])
def test_precision_arms_refused_on_ssl_as_jax_fails(arm):
    """The JAX SHASWithSSL.apply takes no precision knobs, so the JAX
    engine fails on the ladder's middle arms; the port's engine refuses
    them by name."""
    jm, params, tm = _pair()
    with pytest.raises(TypeError):
        jpipe.WindowInference(jm, params, loss_tag="ssl",
                              precision=arm).run_batch(
            jcollate.collate(_examples(), 2, 16000, 50))
    with pytest.raises(ValueError, match=f"runtime.precision={arm}"):
        tpipe.WindowInference(tm, "cpu", torch.float32, arm,
                              loss_tag="ssl")


@pytest.mark.parametrize("arm,quantize", [("bf16", None), ("f32", None),
                                          (None, "int8")])
def test_runnable_arms_match_jax_on_ssl(arm, quantize):
    """bf16 (the compute dtype, float32 here), f32 and int8 run on
    SHASWithSSL in both engines: p(<B>) = softmax(frame logits)[..., 0].
    Float arms agree to the model bound; int8 within the JAX int8 engine's
    own distance to its float path (the two float paths' ~1e-6 noise
    flips a few roundings)."""
    jm, params, tm = _pair()
    jbatch = jcollate.collate(_examples(), 2, 16000, 50)
    want, _ = jpipe.WindowInference(jm, params, loss_tag="ssl",
                                    precision=arm,
                                    quantize=quantize).run_batch(jbatch)
    engine = tpipe.WindowInference(tm, "cpu", torch.float32, arm, quantize,
                                   loss_tag="ssl")
    batch = collate(_examples(), 2, 16000, 50)
    handle = engine.run_batch(batch, need_logits=True)
    got = handle.numpy()
    logits = handle.logits()
    assert logits.shape == batch.out_mask.shape + (36,)
    assert (logits[~batch.out_mask] == 0).all()
    np.testing.assert_allclose(
        got, torch.softmax(torch.from_numpy(logits), -1)[..., 0].numpy()
        * batch.out_mask, atol=1e-6)
    bound = BOUND
    if quantize:
        ref, _ = jpipe.WindowInference(jm, params,
                                       loss_tag="ssl").run_batch(jbatch)
        bound = max(BOUND, float(np.abs(np.asarray(want)
                                        - np.asarray(ref)).max()))
    np.testing.assert_allclose(got, np.asarray(want), atol=bound, rtol=0)


# ------------------------------------------------------- build_model (C11)

@pytest.mark.parametrize("task,cls,layers,vocab_size", [
    ("shas", SHAS, 15, 1),
    ("shas_ssl", SHASWithSSL, 24, 36),
    ("shas_ctc", SHASWithSSL, 15, 36),
    ("shas_focal", SHAS, 15, 1),
    ("arseg", AutoRegSegmenter, 15, 4),
])
def test_build_model_follows_target(task, cls, layers, vocab_size):
    """Each task's ``_target_`` builds its class, the vocabulary's size
    wired into the head (on the meta device: shapes only); an SSL model
    keeps its final encoder LayerNorm and a 32-way CTC head."""
    cfg = compose(CONF, "train", [f"task={task}"])
    model, vocab = tcommon.build_model(to_plain(cfg.task), "meta")
    assert type(model) is cls
    assert len(model.backbone.encoder.layers) == layers
    assert model.seg_model.output_layer.out_features == vocab_size
    assert (vocab is None) == (vocab_size == 1)
    if cls is SHASWithSSL:
        assert vocab.vocab_size == 36 and vocab.pad_token_id == 2
        assert model.wav2vec_model.model.lm_head.out_features == 32
        assert model.backbone.encoder.layer_norm.weight.shape == (1024,)
    if cls is AutoRegSegmenter:
        assert vocab.sep_token_id == 3
        assert len(model.seg_model.encoder.layers) == 1
        assert len(model.seg_model.decoder.layers) == 4
        assert model.seg_model.embedding.weight.shape == (4, 1024)
        assert model.seg_model.decoder.layers[0].linear1.out_features == 2048


def test_build_model_refuses_unported_targets():
    with pytest.raises(NotImplementedError, match="lib.models.Other"):
        tcommon.build_model({"_target_": "lib.models.Other"}, "meta")
    model, vocab = tcommon.build_model(
        {"model": {"wav2vec_keep_layers": 1},
         "vocab": {"_target_": "lib.datautils.BaseVocabulary"}}, "meta")
    assert type(model) is SHAS and vocab.vocab_size == 4
    assert model.seg_model.output_layer.out_features == 4


# ------------------------------------------- transcripts, loaders, trainer

@pytest.fixture(scope="module")
def text_corpus(tmp_path_factory):
    """Two talks (23.1 s, 14.2 s) whose segments.tsv carries tgt_text (one
    segment without a text), written as the JAX data prep writes them."""
    import pandas as pd

    from .helpers import make_speechlike_wav

    root = tmp_path_factory.mktemp("text_corpus")
    talks, segments = [], []
    words = "the quick brown fox jumps over a lazy dog".split()
    for i, secs in enumerate((23.1, 14.2)):
        path = root / f"ted_{i}.wav"
        make_speechlike_wav(path, duration_secs=secs, seed=i)
        talks.append({"id": f"ted_{i}", "path": str(path),
                      "total_frames": int(secs * 16000)})
        for j, s0 in enumerate(np.arange(0.3, secs - 1.0, 2.9)):
            text = " ".join(words[(i + j) % 5:(i + j) % 5 + 3])
            segments.append({"talk_id": f"ted_{i}", "start": int(s0 * 16000),
                             "end": int(min(s0 + 2.3, secs) * 16000),
                             "tgt_text": None if j == 2 else text})
    pd.DataFrame(talks).to_csv(root / "talks.tsv", sep="\t")
    pd.DataFrame(segments).to_csv(root / "segments.tsv", sep="\t")
    return str(root / "talks.tsv"), str(root / "segments.tsv")


def test_ctc_loaders_match_jax(text_corpus):
    """The windows' transcripts (texts of the segments a window fully
    holds) and the batches of both generators with a vocabulary and
    ``ctc``: tokens, and targets padded with <PAD>."""
    from wav2vecsegmenter_tpu.data import datasets as jds
    from wav2vecsegmenter_tpu.data import loader as jloader
    from wav2vecsegmenter_tpu_torch.data import datasets as tds
    from wav2vecsegmenter_tpu_torch.data import loader as tloader

    from .test_torch_train import _assert_same_batches

    talks, segments = text_corpus
    got = tds.RandomSegmentationDataset(talks, segments, 4, 3)
    want = jds.RandomSegmentationDataset(talks, segments, 4, 3)
    assert got.transcripts == want.transcripts
    assert any(got.transcripts) and "" in got.transcripts
    tv, jv = tvocab.UppercasedCharVocabulary(), \
        jvocab.UppercasedCharVocabulary()
    got = tloader.RandomDataloaderGenerator(talks, segments, 4, 3, seed=7,
                                            vocab=tv, ctc=True)
    want = jloader.RandomDataloaderGenerator(talks, segments, 4, 3,
                                             num_workers=2, seed=7,
                                             device_normalize=True,
                                             vocab=jv, ctc=True)
    batches = list(got.generate())
    _assert_same_batches(batches, list(want.generate()))
    assert all(b.tokens is not None for b in batches)
    assert (batches[0].target == tv.pad_token_id).any()
    got = tloader.FixedDataloaderGenerator(talks, segments, 4, 3, vocab=tv,
                                           ctc=True)
    want = jloader.FixedDataloaderGenerator(talks, segments, 4, 3,
                                            num_workers=2, vocab=jv,
                                            device_normalize=True, ctc=True)
    for talk in want.get_talk_ids():
        _assert_same_batches(list(got.generate(talk, 0)),
                             list(want.generate(talk, 0)))


@pytest.mark.parametrize("task", ["shas_ssl", "shas_ctc"])
def test_trainer_runs_the_ssl_tasks(tmp_path, text_corpus, monkeypatch,
                                    task):
    """The port's trainer on ``task=shas_ssl`` (head only, pseudo-labels)
    and ``task=shas_ctc`` (the backbone fine-tuned on transcripts) at the
    tiny geometry, 10.1 s windows (whose buckets keep T_conv == T_out):
    finite losses, the multi-class eval metrics (no eval loss, as in the
    JAX loop: only the bce engine computes one), and the checkpoint layout
    (head only / the full model) loading back."""
    from wav2vecsegmenter_tpu_torch.train.loop import train

    for target in ("lib.models.SHASWithSSL", "lib.models.SHASWithCTC"):
        monkeypatch.setitem(
            tcommon.MODELS, target,
            lambda device=None, **kw: port_tiny_ssl(
                CFG, device=device, vocab_size=kw["vocab_size"],
                finetune_wav2vec=kw["finetune_wav2vec"]))
    talks, segments = text_corpus
    cfg = compose(CONF, "train", [
        f"task={task}", "exp_name=run", "batch_size=2",
        "segment_length=10.1", "max_epochs=1", "update_freq=1",
        "print_every_steps=1", "+runtime.device=cpu",
        f"data.train.talk_list={talks}",
        f"data.train.segments_list={segments}",
        f"data.eval.talk_list={talks}",
        f"data.eval.segments_list={segments}"])
    out = train(cfg, tmp_path)
    assert np.isfinite(out["history"]["loss"]).all()
    assert out["updates"] == out["steps_per_epoch"][0] >= 2
    assert set(out["eval"]) == {"eval_accuracy", "eval_f1",
                                "eval_precision", "eval_recall"}
    model = out["model"]
    saved = torch.load(out["checkpoint"], weights_only=True)["state_dict"]
    assert set(saved) == set((model if task == "shas_ctc" else
                              model.seg_model).state_dict())
    back = port_tiny_ssl(CFG, finetune_wav2vec=task == "shas_ctc")
    load_reference_checkpoint(out["checkpoint"], back,
                              allow_random_wav2vec=True)
    for key, value in model.seg_model.state_dict().items():
        assert torch.equal(back.seg_model.state_dict()[key], value), key
