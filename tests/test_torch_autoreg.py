"""The autoregressive segmenter (``task=arseg``) in the port against the JAX
package: the differentiable cross-attention (C16), the teacher-forced
forward, the KV-cached greedy decode, the engine's arms on it, one train
micro-step, the batches and the trainer.

Shared weights go JAX ``init`` (the head's LayerNorms drawn away from 1 and
0) -> numpy -> ``state_dict_from_jax_params`` at the tiny geometry of
``tests/torch_tiny`` (2 backbone layers of width 64, a 1-layer encoder and
a 2-layer decoder of 4 heads, V=4); the JAX side runs its XLA path in
float32.  ``tests/test_torch_autoreg_cli.py`` holds the CLIs.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vecsegmenter_tpu.data import collate as jcollate
from wav2vecsegmenter_tpu.data import vocab as jvocab
from wav2vecsegmenter_tpu.infer import pipeline as jpipe
from wav2vecsegmenter_tpu.models import autoreg as jautoreg
from wav2vecsegmenter_tpu.ops import attention as jattn
from wav2vecsegmenter_tpu.train import loss as jloss
from wav2vecsegmenter_tpu.train import step as jstep
from wav2vecsegmenter_tpu_torch.checkpoints.convert import (
    load_reference_checkpoint, state_dict_from_jax_params)
from wav2vecsegmenter_tpu_torch.cli import common as tcommon
from wav2vecsegmenter_tpu_torch.config import compose
from wav2vecsegmenter_tpu_torch.data import collate as tcollate
from wav2vecsegmenter_tpu_torch.data import vocab as tvocab
from wav2vecsegmenter_tpu_torch.infer import pipeline as tpipe
from wav2vecsegmenter_tpu_torch.models import autoreg as tautoreg
from wav2vecsegmenter_tpu_torch.ops import attention as tattn
from wav2vecsegmenter_tpu_torch.train import loss as tloss
from wav2vecsegmenter_tpu_torch.train import step as tstep

from .helpers import TINY_W2V
from .test_torch_ops import kernels_forced  # noqa: F401
from .test_torch_train import LR, TOTAL_STEPS, corpus  # noqa: F401
from .torch_tiny import (autoreg_pair, jax_tiny_autoreg,  # noqa: F401
                         threads_per_worker, port_tiny_autoreg)

BOUND = 2e-4        # float32 forward, decode and train-step parity
GRAD_F32 = 1e-5     # float32 attention gradients
CONF = Path(__file__).resolve().parents[1] / "conf"
CFG = dataclasses.replace(TINY_W2V, apply_spec_augment=False)
VOCAB = tvocab.BaseVocabulary()
AUDIO_LEN = 32000


# ------------------------------------------------------------ C16: ops

def _attn_inputs(tq, tk, seed=0):
    rng = np.random.RandomState(seed + 10 * tq + tk)
    b, h, d = 4, 2, 16
    q, do = (rng.randn(b, tq, h, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, tk, h, d).astype(np.float32) for _ in range(2))
    # ragged keys: all, about half, one, none (a batch-padding row)
    lengths = np.array([tk, tk // 2, 1, 0])
    mask = np.arange(tk)[None, :] < lengths[:, None]
    return q, k, v, do, mask, d ** -0.5


@pytest.mark.parametrize("via", ["attention_bthd", "attention_cross"])
@pytest.mark.parametrize("tq,tk", [(10, 7), (5, 9), (8, 8)])
def test_cross_attention_grads_match_jax(tq, tk, via):
    """C16: attention_bthd under grad (q, k and v of their own lengths) and
    the cross-attention Function on a packed K/V against jax.vjp of the JAX
    attention_xla, queries longer than, shorter than and as long as the
    keys, with a ragged key mask and a row whose keys are all masked."""
    q, k, v, do, mask, scale = _attn_inputs(tq, tk)

    def f(a, bb, c):
        t = lambda x: x.transpose(0, 2, 1, 3)  # noqa: E731
        return t(jattn.attention_xla(t(a), t(bb), t(c), jnp.asarray(mask),
                                     scale))

    want, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(do))
    tq_, tk_, tv_ = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tmask = torch.from_numpy(mask)
    if via == "attention_bthd":
        out = tattn.attention_bthd(tq_, tk_, tv_, tmask, scale)
        got = torch.autograd.grad(out, (tq_, tk_, tv_), torch.from_numpy(do))
    else:
        kv = torch.stack((tk_, tv_), dim=2).detach().requires_grad_()
        out = tattn.attention_cross(tq_, kv, tmask, scale)
        dq, dkv = torch.autograd.grad(out, (tq_, kv), torch.from_numpy(do))
        got = (dq, *dkv.unbind(2))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=GRAD_F32, rtol=0)
    for name, g, w in zip("qkv", got, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_F32,
                                   rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("tq,tk", [(10, 7), (5, 9)])
def test_cross_attention_kernel_branch(kernels_forced, tq, tk):  # noqa: F811
    """The bf16 kernel branch of the cross-attention Function (launches
    stood in for by the plain versions): one forward launch that writes
    [B, H, Tq, 2] statistics, handed with the output to one backward
    launch, whose dq and packed dkv are the plain backward's."""
    q, k, v, do, mask, scale = (
        torch.from_numpy(a).bfloat16() if isinstance(a, np.ndarray)
        and a.dtype == np.float32 else a for a in _attn_inputs(tq, tk))
    tmask = torch.from_numpy(mask)
    q.requires_grad_()
    kv = torch.stack((k, v), dim=2).requires_grad_()
    out = tattn.attention_cross(q, kv, tmask, scale)
    dq, dkv = torch.autograd.grad(out, (q, kv), do)
    assert kernels_forced["attention_bthd"] == 1
    assert kernels_forced["attention_bwd"] == 1
    o, stats = kernels_forced["attention_bwd_inputs"]
    assert torch.equal(o, out)
    assert stats.shape == (4, 2, tq, 2) and stats.dtype == torch.float32
    torch.testing.assert_close(stats, tattn.attention_stats_plain(
        q.detach(), k, tmask, scale))
    want = tattn.attention_bwd_plain(q.detach(), k, v, tmask, do, scale)
    for g, w in zip((dq, *dkv.unbind(2)), want):
        assert torch.equal(g, w)


# ------------------------------------------------------------ the model

def _examples(seed=0):
    """Two windows (2 s and 1.25 s) with 0/1 frame targets."""
    rng = np.random.RandomState(seed)
    out = []
    for n in (AUDIO_LEN, 20000):
        t = int(tcollate.out_len_for(n))
        target = np.zeros(t, np.float32)
        start = rng.randint(0, t // 2)
        target[start:start + t // 3] = 1.0
        out.append(((rng.randn(n) * 0.1).astype(np.float32), target, 0, t))
    return out


def _batch(seed=0):
    """The port's and the JAX collate_autoreg of :func:`_examples` at 3 rows
    (the third an empty padding row)."""
    args = (_examples(seed), 3, AUDIO_LEN, tcollate.out_len_for(AUDIO_LEN),
            VOCAB.pad_token_id, VOCAB.sep_token_id)
    return tcollate.collate_autoreg(*args), jcollate.collate_autoreg(*args)


@pytest.fixture(scope="module")
def pair():
    return autoreg_pair(CFG)


def _port_copy(pair, **kwargs):
    """A fresh port model on the pair's weights."""
    jm, params, _ = pair
    tm = port_tiny_autoreg(CFG, **kwargs)
    tm.load_state_dict(state_dict_from_jax_params(params, tm), strict=True)
    return tm


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def test_forward_matches_jax(pair):
    """The teacher-forced logits against the JAX apply on one collated
    batch (an empty padding row included: its decoder keys are all masked,
    so every query averages uniformly, -1e30 and no NaN)."""
    jm, params, tm = pair
    b, jb = _batch()
    want = np.asarray(jm.apply(jax.tree.map(jnp.asarray, params), jb.audio,
                               jb.in_lengths, jb.in_target, jb.src_mask,
                               jb.tgt_mask))
    with torch.no_grad():
        got = tm(*_t(b.audio, b.in_lengths, b.in_target, b.tgt_mask))
    assert got.shape == want.shape == (3, b.in_target.shape[1], 4)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=BOUND, rtol=0)


def test_greedy_decode_matches_jax(pair):
    """Tokens equal to the JAX greedy_decode's, probs and logits within
    BOUND (no pair of frame logits within 10 BOUND, so no tie decides a
    token); the decode equals the port's own teacher-forced forward fed
    the decoded tokens."""
    jm, params, tm = pair
    b, _ = _batch()
    t_out = tcollate.out_len_for(AUDIO_LEN)
    jp, jl, jt = map(np.asarray, jm.greedy_decode(
        jax.tree.map(jnp.asarray, params), b.audio, b.in_lengths, t_out))
    gap = np.abs(jl[..., 1] - jl[..., 0])
    assert gap.min() > 10 * BOUND
    audio, lengths = _t(b.audio, b.in_lengths)
    with torch.no_grad():
        probs, logits, tokens = tm.greedy_decode(audio, lengths, t_out)
    assert probs.shape == (3, t_out) and logits.shape == (3, t_out, 4)
    np.testing.assert_array_equal(tokens.numpy(), jt)
    assert set(np.unique(jt)) <= {VOCAB.boundary_token_id,
                                  VOCAB.nonboundary_token_id}
    assert 0 < (jt == VOCAB.nonboundary_token_id).mean() < 1
    np.testing.assert_allclose(probs.numpy(), jp, atol=BOUND, rtol=0)
    np.testing.assert_allclose(logits.numpy(), jl, atol=BOUND, rtol=0)

    sep = torch.full((3, 1), VOCAB.sep_token_id, dtype=torch.long)
    target_in = torch.cat([sep, tokens[:, :-1]], dim=1)
    with torch.no_grad():
        forced = tm(audio, lengths, target_in,
                    torch.ones((3, t_out), dtype=torch.bool))
    np.testing.assert_allclose(forced.numpy(), logits.numpy(), atol=BOUND,
                               rtol=0)


def test_checkpoint_layouts(tmp_path, monkeypatch):
    """The port's arseg ``.pt`` in both layouts: the full model loads as it
    is; the head alone takes its backbone from a local snapshot, and
    without one only under allow_random_wav2vec."""
    from wav2vecsegmenter_tpu_torch.models.wav2vec2 import init_from_numpy

    tm = port_tiny_autoreg(TINY_W2V)
    init_from_numpy(tm, seed=3)
    full = tmp_path / "full.pt"
    torch.save({"state_dict": tm.state_dict()}, full)
    back = port_tiny_autoreg(TINY_W2V, finetune_wav2vec=True)
    load_reference_checkpoint(full, back)
    for key, value in tm.state_dict().items():
        assert torch.equal(back.state_dict()[key], value), key
    head = tmp_path / "head.pt"
    torch.save({"state_dict": tm.seg_model.state_dict()}, head)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    fresh = port_tiny_autoreg(TINY_W2V)
    with pytest.raises(FileNotFoundError):
        load_reference_checkpoint(head, fresh)
    load_reference_checkpoint(head, fresh, allow_random_wav2vec=True)
    for key, value in tm.seg_model.state_dict().items():
        assert torch.equal(fresh.seg_model.state_dict()[key], value), key
    snap = tmp_path / "w2v"
    snap.mkdir()
    torch.save(tm.backbone.state_dict(), snap / "pytorch_model.bin")
    fresh = port_tiny_autoreg(TINY_W2V, wav2vec_model_name=str(snap))
    load_reference_checkpoint(head, fresh)
    for key, value in tm.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], value), key


# ------------------------------------------------------------- the engine

def _window_examples():
    rng = np.random.RandomState(3)
    wavs = [rng.randn(n).astype(np.float32) * 0.1 for n in (16000, 11000)]
    return [(w, None, 0, int(len(w) * 49.95 / 16000)) for w in wavs]


@pytest.mark.parametrize("arm", ["f32head", "f32res", "f32last1"])
def test_precision_arms_refused(pair, arm):
    """C17: the JAX engine passes the ladder's knobs to apply only and runs
    the decode at the arm's compute dtype, ignoring them; the port's engine
    refuses them by name."""
    _, _, tm = pair
    with pytest.raises(ValueError, match=f"runtime.precision={arm}"):
        tpipe.WindowInference(tm, "cpu", torch.float32, arm, loss_tag="ce")


@pytest.mark.parametrize("arm,quantize", [("bf16", None), ("f32", None),
                                          (None, "int8")])
def test_engine_decodes_as_jax(pair, arm, quantize):
    """The engine dispatches an arseg batch (device-normalized int16, as
    the offline reader gives it) to greedy_decode in both packages:
    p(in-segment) and, on out_mask, the [B, T, 4] logits (zero off it).
    Float arms within BOUND; int8 within the JAX int8 engine's own
    distance to its float path."""
    jm, params, tm = pair
    args = (_window_examples(), 2, 16000, 50)
    jbatch = jcollate.collate(*args, device_normalize=True)
    want, want_logits = jpipe.WindowInference(
        jm, params, loss_tag="ce", precision=arm,
        quantize=quantize).run_batch(jbatch)
    batch = tcollate.collate(*args, device_normalize=True)
    engine = tpipe.WindowInference(tm, "cpu", torch.float32, arm, quantize,
                                   loss_tag="ce")
    handle = engine.run_batch(batch, need_logits=True)
    got, logits = handle.numpy(), handle.logits()
    assert logits.shape == batch.out_mask.shape + (4,)
    assert (logits[~batch.out_mask] == 0).all()
    assert (got[~batch.out_mask] == 0).all()
    pair_ = torch.from_numpy(logits[..., :2])
    np.testing.assert_allclose(
        got, torch.softmax(pair_, -1)[..., 1].numpy() * batch.out_mask,
        atol=1e-6)
    bound = BOUND
    if quantize:
        ref, _ = jpipe.WindowInference(jm, params,
                                       loss_tag="ce").run_batch(jbatch)
        bound = max(BOUND, float(np.abs(np.asarray(want)
                                        - np.asarray(ref)).max()))
    np.testing.assert_allclose(got, np.asarray(want), atol=bound, rtol=0)
    np.testing.assert_allclose(logits, np.asarray(want_logits),
                               atol=bound * 10 if quantize else BOUND, rtol=0)


# ----------------------------------------------------------------- training

def _jax_step(jm, params, batch):
    loss_fn, _, _ = jloss.build_loss(
        {"_target_": "torch.nn.CrossEntropyLoss", "tag": "ce"}, None,
        jvocab.BaseVocabulary())
    opt = jstep.make_optimizer(LR, TOTAL_STEPS, 1, jm.trainable_mask(params))
    state = jstep.init_train_state(jm, opt, jax.random.PRNGKey(1),
                                   jax.tree.map(jnp.asarray, params))
    step = jstep.make_train_step(jm, loss_fn, "ce", 0, opt,
                                 vocab=jvocab.BaseVocabulary(),
                                 autoregression=True)
    fields = ("audio", "in_lengths", "in_target", "out_target", "src_mask",
              "tgt_mask")
    state, m = step(state, {f: getattr(batch, f) for f in fields},
                    jax.random.PRNGKey(0))
    return (float(m["loss"]), float(m["grad_norm"]),
            jax.device_get(state.params))


def _port_step(tm, batch, generator=None):
    trained = tm.set_requires_grad()
    loss_fn, _, _ = tloss.build_loss(
        {"_target_": "torch.nn.CrossEntropyLoss", "tag": "ce"}, None, VOCAB)
    opt = tstep.AccumulatingAdamW(trained, LR, TOTAL_STEPS, 1)
    step = tstep.make_train_step(tm, loss_fn, 0, opt, loss_tag="ce",
                                 vocab=VOCAB, generator=generator,
                                 autoregression=True)
    return step(batch)


def test_train_step_matches_jax(pair, monkeypatch):
    """One arseg micro-step against the JAX make_train_step(...,
    autoregression=True), dropout off on both sides (the JAX
    _LAYER_DROPOUT patched to 0, init_dropout 0, no SpecAugment): the
    loss (summed over every position), grad_norm and every parameter
    after AdamW's update, the frozen backbone unchanged.  Where a gradient
    is 0 in exact arithmetic (the attention key biases: softmax is
    shift-invariant) Adam turns either side's roundoff into a step of up
    to lr."""
    monkeypatch.setattr(jautoreg, "_LAYER_DROPOUT", 0.0)
    monkeypatch.setattr(tautoreg, "LAYER_DROPOUT", 0.0)
    jm, params, _ = pair
    tm = _port_copy(pair).train()
    b, jb = _batch()
    want_loss, want_norm, jparams = _jax_step(jm, params, jb)
    initial = {k: v.clone() for k, v in tm.state_dict().items()}
    m = _port_step(tm, b)
    assert m["logits"].shape == (3, b.in_target.shape[1], 4)
    np.testing.assert_allclose(float(m["loss"]), want_loss, rtol=BOUND)
    np.testing.assert_allclose(float(m["grad_norm"]), want_norm, rtol=BOUND)
    ref = state_dict_from_jax_params(jparams, tm)
    h = CFG.hidden_size
    for key, value in tm.state_dict().items():
        if not key.startswith("seg_model."):
            assert torch.equal(value, initial[key]), key
            continue
        assert not torch.equal(value, initial[key]) or key.endswith(
            "embedding.weight"), key
        diff = (value - ref[key]).abs()
        if key.endswith("in_proj_bias"):
            assert (diff[h:2 * h] <= 2 * LR).all(), key
            diff[h:2 * h] = 0
        assert diff.max() <= BOUND, (key, diff.max().item())


def test_train_step_dropout_fires(pair):
    """With the task's dropout (init_dropout and 0.1 in every sublayer) the
    micro-step's loss is finite and its logits differ from the
    deterministic forward's and between generators (the JAX
    test_autoreg_training_dropout_fires)."""
    b, _ = _batch()
    tm = _port_copy(pair, init_dropout=0.1)
    with torch.no_grad():
        det = tm(*_t(b.audio, b.in_lengths, b.in_target, b.tgt_mask))
    runs = [_port_step(tm.train(), b, torch.Generator().manual_seed(seed))
            for seed in (1, 2)]
    assert all(np.isfinite(float(m["loss"])) for m in runs)
    real = torch.from_numpy(b.tgt_mask)  # the real positions
    first, second = (m["logits"][real] for m in runs)
    assert (first - det[real]).abs().max() > 1e-3
    assert (second - first).abs().max() > 1e-3


def test_loaders_match_jax(corpus):  # noqa: F811
    """Both generators with ``autoregression`` yield the JAX generators'
    AutoRegBatches, batch for batch (host-normalized, SEP-wrapped with the
    vocabulary's <SEP>, padded with its <PAD>)."""
    from wav2vecsegmenter_tpu.data import loader as jloader
    from wav2vecsegmenter_tpu_torch.data import loader as tloader

    from .test_torch_train import _assert_same_batches

    talks, segments = corpus
    jv = jvocab.BaseVocabulary()
    got = tloader.RandomDataloaderGenerator(talks, segments, 4, 3, seed=7,
                                            vocab=VOCAB, autoregression=True)
    want = jloader.RandomDataloaderGenerator(talks, segments, 4, 3,
                                             num_workers=2, seed=7, vocab=jv,
                                             autoregression=True,
                                             device_normalize=True)
    batches = list(got.generate())
    assert all(isinstance(x, tcollate.AutoRegBatch) for x in batches)
    assert all(x.audio.dtype == np.float32 for x in batches)
    assert (batches[0].in_target[:, 0] == VOCAB.sep_token_id).all()
    _assert_same_batches(batches, list(want.generate()))
    got = tloader.FixedDataloaderGenerator(talks, segments, 4, 3, vocab=VOCAB,
                                           autoregression=True)
    want = jloader.FixedDataloaderGenerator(talks, segments, 4, 3,
                                            num_workers=2, vocab=jv,
                                            autoregression=True)
    for talk in want.get_talk_ids():
        _assert_same_batches(list(got.generate(talk, 0)),
                             list(want.generate(talk, 0)))


def test_trainer_matches_jax_loop_until_its_first_eval(
        pair, corpus, tmp_path, monkeypatch):  # noqa: F811
    """The trainer on ``task=arseg`` from the same weights as the JAX loop
    (no dropout, no SpecAugment, the same seeded epoch): every micro-step's
    loss equal to the JAX loop's; then both stop at the epoch's
    evaluation, the JAX loop with an AttributeError (its engine reads
    fields an AutoRegBatch lacks) and the port with a NotImplementedError
    naming ROADMAP C15."""
    from wav2vecsegmenter_tpu.config import compose as jcompose
    from wav2vecsegmenter_tpu.config import registry
    from wav2vecsegmenter_tpu.train import loop as jloop
    from wav2vecsegmenter_tpu_torch.train import loop as tloop

    import tests.helpers as helpers

    monkeypatch.setattr(jautoreg, "_LAYER_DROPOUT", 0.0)
    monkeypatch.setattr(tautoreg, "LAYER_DROPOUT", 0.0)
    jm = jax_tiny_autoreg(CFG)
    params = pair[1]
    monkeypatch.setattr(jm, "init", lambda rng: jax.tree.map(jnp.asarray,
                                                             params))
    monkeypatch.setitem(registry._ALIASES, "lib.models.AutoRegSegmenter",
                        "tests.helpers:_tiny_builder")
    monkeypatch.setattr(helpers, "_tiny_builder", lambda **kw: jm,
                        raising=False)
    ckpt = tmp_path / "init.pt"
    made = port_tiny_autoreg(CFG)
    torch.save({"state_dict": state_dict_from_jax_params(params, made)}, ckpt)
    monkeypatch.setitem(tcommon.MODELS, "lib.models.AutoRegSegmenter",
                        lambda device=None, **kw: port_tiny_autoreg(
                            CFG, device=device))

    jax_losses = []
    real_step = jloop.make_train_step

    def recording_step(*args, **kwargs):
        step = real_step(*args, **kwargs)

        def wrapped(state, batch, rng, *rest):
            state, m = step(state, batch, rng, *rest)
            jax_losses.append(float(m["loss"]))
            return state, m
        return wrapped

    monkeypatch.setattr(jloop, "make_train_step", recording_step)
    talks, segments = corpus
    common = ["task=arseg", "exp_name=run", "batch_size=2",
              "segment_length=4", "max_epochs=1", "update_freq=2",
              "print_every_steps=1", "save_ckpts=false",
              "task.model.init_dropout=0", "+task.train_generator.seed=5",
              f"data.train.talk_list={talks}",
              f"data.train.segments_list={segments}",
              f"data.eval.talk_list={talks}",
              f"data.eval.segments_list={segments}"]
    jconfig = jcompose(CONF, "train", common + [
        "runtime.kernels=xla", "runtime.compute_dtype=float32",
        "runtime.mesh.data=1"])
    with pytest.raises(AttributeError):
        jloop.train(jconfig, work_dir=tmp_path / "jax")
    port_losses = []
    config = compose(CONF, "train", common + [
        "+runtime.device=cpu", f"+finetune_from_model={ckpt}"])
    with pytest.raises(NotImplementedError, match="C15"):
        tloop.train(config, tmp_path / "port",
                    on_step=lambda m: port_losses.append(float(m["loss"])))
    assert len(port_losses) == len(jax_losses) > 2
    np.testing.assert_allclose(port_losses, jax_losses, rtol=BOUND)
