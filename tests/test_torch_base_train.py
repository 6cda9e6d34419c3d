"""Training the base-model geometry (``facebook/wav2vec2-base``: the
group-norm conv stack without conv bias, the post-LN encoder) in the port
against the JAX package.

The backbones are the base geometry at the tiny widths of
``tests/test_torch_base.py``: hidden 96 with one head of 96 (the SFC
head's, the arseg encoder's and its decoder's cross-attention at D=96,
which reaches K10's D=96 branch) and hidden 64 with two heads of 32; the
conv stack is ``tests/helpers``' 32-channel one, so that a 10 s bucket
stays cheap on the CPU.  Shared weights go JAX ``init`` -> numpy -> the
port; dropout is off and SpecAugment too, for parity.  The JAX side runs
its Pallas kernels in interpret mode for the SHAS steps (as
``tests/test_torch_lna.py``) and its XLA path elsewhere (as the SSL and
arseg tests do).  The train CLI runs on a backbone named by a local
``config.json`` (the preset's 512 conv channels, short windows).

Tolerances: float32 attention gradients 1e-5 (absolute); a step's loss
LOSS_RTOL (1e-5) and grad_norm GNORM_RTOL (1e-4), relative; every
parameter after AdamW within PARAM_ATOL (2e-5), except where a gradient
is 0 in exact arithmetic (the attention key biases) or within NEAR_ZERO
of its parameter's largest, where Adam turns either side's roundoff into
a step of up to lr; the ctc step's grad_norm within F64_RTOL (1e-6) of
its float64 value (the JAX package's within JAX_CTC_RTOL, 2e-4); the
arseg step, forward and decode within BOUND (2e-4, the port's float32
model tolerance), tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu

from wav2vecsegmenter_tpu.checkpoints.torch_convert import (
    convert_reference_checkpoint, load_torch_state_dict)
from wav2vecsegmenter_tpu.data import vocab as jvocab
from wav2vecsegmenter_tpu.models import autoreg as jautoreg
from wav2vecsegmenter_tpu.models.shas import SHAS as JaxSHAS
from wav2vecsegmenter_tpu.ops import attention as jattn
from wav2vecsegmenter_tpu.ops.backend import set_backend
from wav2vecsegmenter_tpu.train import step as jstep
from wav2vecsegmenter_tpu.train.loss import BCEWithLogitsLoss as JBCE
from wav2vecsegmenter_tpu_torch.checkpoints.convert import (
    load_reference_checkpoint, state_dict_from_jax_params)
from wav2vecsegmenter_tpu_torch.cli import common as tcommon
from wav2vecsegmenter_tpu_torch.cli import train as tcli
from wav2vecsegmenter_tpu_torch.config import compose, to_plain
from wav2vecsegmenter_tpu_torch.data import collate as tcollate
from wav2vecsegmenter_tpu_torch.data import vocab as tvocab
from wav2vecsegmenter_tpu_torch.models import autoreg as tautoreg
from wav2vecsegmenter_tpu_torch.models import wav2vec2 as tw2v
from wav2vecsegmenter_tpu_torch.models.shas import SHAS
from wav2vecsegmenter_tpu_torch.ops import attention as tattn
from wav2vecsegmenter_tpu_torch.train import loss as tloss
from wav2vecsegmenter_tpu_torch.train import step as tstep

from . import test_torch_autoreg as tar
from . import test_torch_ssl as tssl
from .helpers import TINY_W2V, make_speechlike_wav
from .test_torch_base import write_base_config
from .test_torch_lna import _is_key_bias, _jax_trainable_names
from .test_torch_lna_parts import _assert_same_logits
from .test_torch_ops import kernels_forced  # noqa: F401
from .test_torch_ssl import text_corpus  # noqa: F401
from .test_torch_train import (GNORM_RTOL, LOSS_RTOL, LR, PARAM_ATOL,
                               POS_WEIGHT, TOTAL_STEPS, _batches, _jax_batch,
                               corpus)  # noqa: F401
from .torch_tiny import (autoreg_params, jax_tiny_autoreg,  # noqa: F401
                         jax_tiny_ssl, port_tiny_autoreg, port_tiny_ssl,
                         ssl_params, threads_per_worker)

# the kernel wrapper's own backward launch (the gate before the library),
# kept before kernels_forced stands it in
_LAUNCH_BWD = tattn._launch_bwd
GRAD_F32 = 1e-5   # float32 attention gradients: summation order only
BOUND = 2e-4      # the port's float32 model tolerance
BASE = dataclasses.replace(
    TINY_W2V, feat_extract_norm="group", do_stable_layer_norm=False,
    conv_bias=False, apply_spec_augment=False, adapter_dim=16)
BASE96 = dataclasses.replace(BASE, hidden_size=96, num_heads=1, ffn_dim=192)
BASE64 = dataclasses.replace(BASE, num_heads=2)
# LNA's freezing splits (tests/test_torch_lna.py's): (a) every layer
# trained, FFNs frozen; (b) layer 0 frozen, layer 1's FFN and its adapter
# trained (on a post-LN layer the adapter is not applied: it moves by
# weight decay alone, as the JAX leaf does); (c) the group-norm conv stack
# and the feature projection trained, layer 0 frozen
CASES = {
    "a": dict(wav2vec_ft_layers=2),
    "b": dict(wav2vec_ft_layers=1, finetune_w2v_ffn=True, ffn_adapter=True),
    "c": dict(wav2vec_ft_layers=1, finetune_w2v_feat_enc=True),
}
PRE_LN = "wav2vec_model.model.encoder.layer_norm."
# Adam's first step is lr * g / (|g| + eps), about lr * sign(g): where a
# gradient element is within NEAR_ZERO of its parameter's largest (the two
# sides' float32 gradients agree to ~1e-6 of it, 3e-5 in the conv stack's
# layer 0; the element is a sum that cancels), either side's roundoff can
# flip its sign and so turn into a step of up to lr.  Such elements (not
# 0 exactly) are at most NEAR_ZERO_SHARE of the trained ones.
NEAR_ZERO, NEAR_ZERO_SHARE = 1e-5, 1e-2


# ------------------------------------------------------------- K10, D=96

@pytest.mark.parametrize("tq", [None, 30])
def test_k10_at_head_dim_96_matches_jax_vjp(kernels_forced, tq):  # noqa: F811
    """The attention backward at head dim 96 through the kernel branch of
    its Functions (the launches stood in for by the plain versions, as on
    the card the kernel takes their place), self-attention on the packed
    QKV and cross-attention (30 queries over 50 keys) on a packed K/V,
    against jax.vjp of the JAX attention_xla, ragged keys and a row whose
    keys are all masked: within GRAD_F32.  The wrapper's gate takes D=96
    on to the library and refuses a head dim it has no kernel for."""
    rng = np.random.RandomState(96 + (tq or 0))
    b, tk, h, d = 4, 50, 2, 96
    tq_ = tq or tk
    q, do = (rng.randn(b, tq_, h, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, tk, h, d).astype(np.float32) for _ in range(2))
    mask = np.arange(tk)[None, :] < np.array([tk, tk // 2, 1, 0])[:, None]
    scale = d ** -0.5

    def f(a, bb, c):
        t = lambda x: x.transpose(0, 2, 1, 3)  # noqa: E731
        return t(jattn.attention_xla(t(a), t(bb), t(c), jnp.asarray(mask),
                                     scale))

    want, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(do))
    tmask, tdo = torch.from_numpy(mask), torch.from_numpy(do)
    if tq is None:
        qkv = torch.from_numpy(np.stack([q, k, v], axis=2)).requires_grad_()
        out = tattn.attention_qkv(qkv, tmask, scale)
        got = torch.autograd.grad(out, qkv, tdo)[0].unbind(2)
    else:
        tq_t = torch.from_numpy(q).requires_grad_()
        kv = torch.from_numpy(np.stack([k, v], axis=2)).requires_grad_()
        out = tattn.attention_cross(tq_t, kv, tmask, scale)
        dq, dkv = torch.autograd.grad(out, (tq_t, kv), tdo)
        got = (dq, *dkv.unbind(2))
    assert kernels_forced["attention_bthd"] == 1
    assert kernels_forced["attention_bwd"] == 1
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=GRAD_F32, rtol=0)
    for name, g, w in zip("qkv", got, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_F32,
                                   rtol=0, err_msg=f"d{name}")

    args = [torch.from_numpy(a) for a in (q, k, v)]
    o = tattn.attention_bthd_plain(*args, tmask, scale)
    stats = tattn.attention_stats_plain(*args[:2], tmask, scale)
    with pytest.raises(LookupError):  # past the gate: the library is asked
        _LAUNCH_BWD(*args, tmask, tdo, scale, o, stats, None)
    with pytest.raises(ValueError, match="head dims 64, 96 or 128"):
        _LAUNCH_BWD(*(a[..., :80] for a in args), tmask, tdo[..., :80],
                    scale, None, None, None)


# ------------------------------------------------------------ LNA steps

def _models(cfg=BASE96, finetune=True, heads=1, **kw):
    """(JAX spec, port module, JAX params) on shared weights; the JAX
    init's unapplied encoder_pre_ln drawn away from 1 and 0, so that its
    decay shows."""
    common = dict(wav2vec_keep_layers=2, n_transformer_enc_layers=1,
                  n_transformer_enc_heads=heads, init_dropout=0.0,
                  finetune_wav2vec=finetune, **kw)
    jm = JaxSHAS(**common)
    jcfg = dataclasses.replace(cfg, ffn_adapter=jm.use_adapter)
    jm.w2v_cfg, jm.d_model, jm.keep_layers = jcfg, jcfg.hidden_size, 2
    tm = SHAS(**common,
              w2v_cfg=tw2v.Wav2Vec2Config(**dataclasses.asdict(jcfg)))
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(3)
    h = jcfg.hidden_size
    params["wav2vec"]["encoder_pre_ln"] = {
        "scale": (1 + 0.2 * rng.randn(h)).astype(np.float32),
        "bias": (0.1 * rng.randn(h)).astype(np.float32)}
    tm.load_state_dict(state_dict_from_jax_params(params, tm), strict=True)
    return jm, tm, params


def _assert_params_match(tm, ref, initial, grads, decay_only,
                         near_zero=NEAR_ZERO):
    """Every parameter after the step against the JAX one (``ref``):
    frozen ones bitwise unchanged on both sides; trained ones (the keys of
    ``grads``, the port's gradients) within PARAM_ATOL, the key biases and
    the ``near_zero`` elements within 2 lr; those the loss does not reach
    (``decay_only``) moved by AdamW's weight decay alone, to 1e-6."""
    h = tm.w2v_cfg.hidden_size
    names = set(grads)
    near = sum(int(((g.abs() <= near_zero * g.abs().max()) & (g != 0)).sum())
               for key, g in grads.items() if not key.startswith(decay_only))
    assert near <= NEAR_ZERO_SHARE * sum(g.numel() for g in grads.values())
    for key, value in tm.state_dict().items():
        if key not in names:
            assert torch.equal(value, initial[key]), key
            assert torch.equal(ref[key], initial[key]), key
            continue
        diff = (value - ref[key]).abs()
        if key.startswith(decay_only):
            want = initial[key] * (1 - LR * 0.01)
            torch.testing.assert_close(value, want, rtol=1e-6, atol=0)
            assert not torch.equal(value, initial[key]), key
        elif _is_key_bias(key):
            part = slice(h, 2 * h) if "in_proj_bias" in key else slice(None)
            assert (diff[part] <= 2 * LR).all(), key
            diff[part] = 0
        g = grads[key].abs()
        cancelled = g <= near_zero * g.max()
        assert (diff[cancelled] <= 2 * LR).all(), key
        diff[cancelled] = 0
        assert diff.max() <= PARAM_ATOL, (key, diff.max().item())


@pytest.mark.parametrize("case,hidden", [("a", 96), ("b", 96), ("c", 96),
                                         ("a", 64)])
def test_lna_step_on_a_post_ln_backbone_matches_jax(case, hidden):
    """One LNA micro-step on the base geometry (hidden 96, the head at
    D=96; hidden 64, two heads of 32) against the JAX make_train_step with
    its trainable mask, its Pallas kernels in interpret mode: loss,
    grad_norm and every parameter after AdamW, the unapplied
    encoder.layer_norm (and, in split b, the adapter) moved by weight
    decay alone on both sides."""
    jm, tm, params = (_models(**CASES[case]) if hidden == 96 else
                      _models(BASE64, heads=2, **CASES[case]))
    batch = _batches(1)[0]
    set_backend("pallas")
    try:
        with pltpu.force_tpu_interpret_mode():
            opt = jstep.make_optimizer(LR, TOTAL_STEPS, 1,
                                       jm.trainable_mask(params))
            state = jstep.init_train_state(
                jm, opt, jax.random.PRNGKey(1),
                jax.tree.map(jnp.asarray, params))
            step = jstep.make_train_step(jm, JBCE(None), "bce", 0, opt,
                                         device_normalize=True,
                                         dynamic_pos_weight=True)
            state, m = step(state, _jax_batch(batch), jax.random.PRNGKey(0))
            want = (float(m["loss"]), float(m["grad_norm"]))
            jparams = jax.device_get(state.params)
    finally:
        set_backend("auto")

    initial = {k: v.clone() for k, v in tm.state_dict().items()}
    trained = tm.set_requires_grad()
    names = [n for n, p in tm.named_parameters() if p.requires_grad]
    opt = tstep.AccumulatingAdamW(trained, LR, TOTAL_STEPS, 1)
    step = tstep.make_train_step(tm, tloss.BCEWithLogitsLoss(None), 0, opt)
    got = step(batch, POS_WEIGHT)
    np.testing.assert_allclose(float(got["loss"]), want[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got["grad_norm"]), want[1],
                               rtol=GNORM_RTOL)
    assert PRE_LN + "weight" in names
    assert (".feature_extractor.conv_layers.0.layer_norm.weight" in
            " ".join(names)) == (case == "c")
    decay_only = (PRE_LN, "wav2vec_model.model.encoder.layers.1.ffn_adapter.")
    assert any(".ffn_adapter." in n for n in names) == (case == "b")
    _assert_params_match(tm, state_dict_from_jax_params(jparams, tm),
                         initial, dict(zip(names, got["grads"])), decay_only)


@pytest.mark.parametrize("case", [*CASES, "frozen_backbone"])
def test_trainable_set_on_a_post_ln_backbone_matches_jax_mask(case):
    """trainable_parameters() is the set of leaves where the JAX
    trainable_mask is 1, name for name, on the base geometry: LNA's
    three splits (encoder_pre_ln, the port's encoder.layer_norm, trains
    under every one of them) and the frozen backbone (the head only)."""
    if case == "frozen_backbone":
        jm, tm, params = _models(finetune=False, ffn_adapter=True)
    else:
        jm, tm, params = _models(**CASES[case])
    ids = {id(p) for p in tm.trainable_parameters()}
    got = {n for n, p in tm.named_parameters() if id(p) in ids}
    assert got == _jax_trainable_names(jm, tm, params)
    assert (PRE_LN + "bias" in got) == (case != "frozen_backbone")


# ---------------------------------------------------------- ssl and ctc

def _ssl_pair(finetune: bool):
    """The SSL model pair on the base geometry (hidden 96, the head at
    D=96) with final_ln and encoder_pre_ln drawn apart."""
    kw = dict(n_transformer_enc_heads=1, finetune_wav2vec=finetune)
    jm = jax_tiny_ssl(BASE96, **kw)
    params = ssl_params(jm, seed=0)
    rng = np.random.RandomState(4)
    params["wav2vec"]["encoder_pre_ln"] = {
        "scale": (1 - 0.3 * rng.rand(96)).astype(np.float32),
        "bias": (0.2 * rng.randn(96)).astype(np.float32)}
    tm = port_tiny_ssl(BASE96, **kw)
    tm.load_state_dict(state_dict_from_jax_params(params, tm), strict=True)
    return jm, params, tm


# the ctc step's gradient norm against its float64 value: the port's
# (float32 model, float64 CTC) and the JAX package's (float32 optax CTC)
F64_RTOL, JAX_CTC_RTOL = 1e-6, 2e-4


def _f64_step(batch, loss_fn, vocab, tag) -> tuple[float, dict]:
    """The ctc micro-step on a float64 copy of the pair's port model (the
    loss in float64, as the port's is) -> (gradient norm, the parameters
    after AdamW as float32)."""
    m64 = _ssl_pair(finetune=True)[2].double()
    opt = tstep.AccumulatingAdamW(m64.set_requires_grad(), LR, TOTAL_STEPS, 1)
    step = tstep.make_train_step(m64, loss_fn, 0, opt, torch.float64,
                                 loss_tag=tag, vocab=vocab)
    norm = float(step(batch)["grad_norm"])
    return norm, {k: v.float() for k, v in m64.state_dict().items()}


@pytest.mark.parametrize("tag", ["ssl", "ctc"])
def test_ssl_steps_on_a_post_ln_backbone_match_jax(tag):
    """One micro-step of task=shas_ssl (frozen backbone, pseudo-labels) and
    of task=shas_ctc (the backbone fine-tuned on transcripts) on the base
    geometry, final_ln (applied: the port's final_layer_norm) and
    encoder_pre_ln (not applied: the port's wav2vec2.encoder.layer_norm)
    of different values, against the JAX make_train_step: the loss; under
    ssl grad_norm (the port's over its trained set, at most the JAX norm
    over every leaf) and every parameter after AdamW; under ctc grad_norm
    against the float64 step's, which the JAX one meets within its
    float32 CTC's error, and every parameter against the float64 step's.
    Under ctc the pre-layers LayerNorm moves by weight decay alone, the
    final one by its gradient."""
    vocab = tvocab.UppercasedCharVocabulary()
    jm, params, tm = _ssl_pair(finetune=tag == "ctc")
    ctc = "wav2vec_model.model."
    assert not torch.equal(tm.state_dict()[f"{ctc}final_layer_norm.weight"],
                           tm.state_dict()[f"{ctc}wav2vec2.encoder.layer_norm"
                                           ".weight"])
    batch, jbatch = tssl._frame_batch(
        vocab.pad_token_id, tssl.TRANSCRIPTS if tag == "ctc" else None,
        vocab if tag == "ctc" else None)
    want_loss, want_norm, jparams = tssl._jax_step(
        jm, params, tag, jvocab.UppercasedCharVocabulary(), jbatch)
    initial = {k: v.clone() for k, v in tm.state_dict().items()}
    trained = tm.set_requires_grad()
    names = [n for n, p in tm.named_parameters() if p.requires_grad]
    loss_fn, _, _ = tloss.build_loss(
        {"_target_": {"ctc": "torch.nn.CTCLoss"}.get(
            tag, "torch.nn.CrossEntropyLoss"), "tag": tag}, None, vocab)
    opt = tstep.AccumulatingAdamW(trained, LR, TOTAL_STEPS, 1)
    step = tstep.make_train_step(tm, loss_fn, 0, opt, loss_tag=tag,
                                 vocab=vocab)
    m = step(batch)
    np.testing.assert_allclose(float(m["loss"]), want_loss, rtol=LOSS_RTOL)
    if tag == "ssl":
        assert 0 < float(m["grad_norm"]) <= want_norm
    else:
        # the ctc gradient: both packages against the step's float64 value
        # (the port's model and loss in float64); the JAX package's float32
        # optax CTC is 1.3e-4 from it here, the port's float64 CTC within
        # F64_RTOL; the parameters are held against the float64 step's
        exact, exact_sd = _f64_step(batch, loss_fn, vocab, tag)
        np.testing.assert_allclose(float(m["grad_norm"]), exact,
                                   rtol=F64_RTOL)
        np.testing.assert_allclose(want_norm, exact, rtol=JAX_CTC_RTOL)
        assert f"{ctc}final_layer_norm.weight" in names
    # under ctc the JAX gradients carry their CTC's float32 error (1.3e-4
    # of the norm), which flips the signs of small elements and so moves
    # Adam's first step by up to 2 lr: the parameters are held against
    # the float64 step there
    ref = (state_dict_from_jax_params(jparams, tm) if tag == "ssl"
           else exact_sd)
    _assert_params_match(tm, ref, initial, dict(zip(names, m["grads"])),
                         f"{ctc}wav2vec2.encoder.layer_norm.")


def test_ssl_file_with_one_final_key_fills_both_layer_norms(tmp_path):
    """A reference SSL file on a post-LN backbone has the one ForCTC key
    ``wav2vec2.encoder.layer_norm``: the port fills its final LayerNorm
    from it, as the JAX loader fills final_ln and encoder_pre_ln, and
    both then compute the same outputs."""
    jm, params, tm = _ssl_pair(finetune=True)
    sd = tm.state_dict()
    ref = {k: v for k, v in sd.items()
           if not k.startswith("wav2vec_model.model.final_layer_norm.")}
    torch.save({"state_dict": ref}, tmp_path / "ref.pt")
    fresh = port_tiny_ssl(BASE96, n_transformer_enc_heads=1,
                          finetune_wav2vec=True)
    load_reference_checkpoint(tmp_path / "ref.pt", fresh)
    ln = "wav2vec_model.model.wav2vec2.encoder.layer_norm.weight"
    assert torch.equal(
        fresh.state_dict()["wav2vec_model.model.final_layer_norm.weight"],
        sd[ln])
    back = jax.device_get(convert_reference_checkpoint(ref, jm))
    np.testing.assert_array_equal(back["final_ln"]["scale"], sd[ln].numpy())
    np.testing.assert_array_equal(
        back["wav2vec"]["encoder_pre_ln"]["scale"], sd[ln].numpy())
    audio, lengths, out_mask = tssl._inputs()
    jc, jf = jm.apply(jax.tree.map(jnp.asarray, back), audio, lengths,
                      out_mask)
    with torch.no_grad():
        tc, tf = fresh.eval()(torch.from_numpy(audio),
                              torch.from_numpy(lengths),
                              torch.from_numpy(out_mask))
    fl = tw2v.frame_lengths(torch.from_numpy(lengths), fresh.w2v_cfg).numpy()
    valid = np.arange(tc.shape[1])[None, :] < fl[:, None]
    np.testing.assert_allclose(tc.numpy()[valid], np.asarray(jc)[valid],
                               atol=BOUND, rtol=0)
    np.testing.assert_allclose(tf.numpy()[out_mask],
                               np.asarray(jf)[out_mask], atol=BOUND, rtol=0)


# ----------------------------------------------------------------- arseg

AR_HEADS = dict(n_transformer_enc_heads=1, n_transformer_dec_heads=1)


@pytest.fixture(scope="module")
def ar_pair():
    """The arseg pair on the base geometry: the encoder's self-attention
    and the decoder's cross-attention at 1 head of 96."""
    jm = jax_tiny_autoreg(BASE96, **AR_HEADS)
    params = autoreg_params(jm, seed=0)
    tm = port_tiny_autoreg(BASE96, **AR_HEADS)
    tm.load_state_dict(state_dict_from_jax_params(params, tm), strict=True)
    return jm, params, tm.eval()


def test_arseg_forward_and_decode_on_a_post_ln_backbone_match_jax(ar_pair):
    """The teacher-forced logits and the greedy decode against the JAX
    apply and greedy_decode: logits and probabilities within BOUND, the
    tokens equal."""
    jm, params, tm = ar_pair
    b, jb = tar._batch()
    jp = jax.tree.map(jnp.asarray, params)
    want = np.asarray(jm.apply(jp, jb.audio, jb.in_lengths, jb.in_target,
                               jb.src_mask, jb.tgt_mask))
    with torch.no_grad():
        got = tm(*tar._t(b.audio, b.in_lengths, b.in_target, b.tgt_mask))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=BOUND, rtol=0)
    t_out = tcollate.out_len_for(tar.AUDIO_LEN)
    wp, wl, wt = map(np.asarray, jm.greedy_decode(jp, b.audio, b.in_lengths,
                                                  t_out))
    with torch.no_grad():
        probs, logits, tokens = tm.greedy_decode(
            *tar._t(b.audio, b.in_lengths), t_out)
    np.testing.assert_array_equal(tokens.numpy(), wt)
    np.testing.assert_allclose(probs.numpy(), wp, atol=BOUND, rtol=0)
    np.testing.assert_allclose(logits.numpy(), wl, atol=BOUND, rtol=0)


def test_arseg_step_on_a_post_ln_backbone_matches_jax(ar_pair, monkeypatch):
    """One arseg micro-step (frozen backbone, dropout off on both sides)
    against the JAX make_train_step(..., autoregression=True): loss,
    grad_norm and every head parameter after AdamW within BOUND, the
    backbone unchanged."""
    monkeypatch.setattr(jautoreg, "_LAYER_DROPOUT", 0.0)
    monkeypatch.setattr(tautoreg, "LAYER_DROPOUT", 0.0)
    jm, params, _ = ar_pair
    tm = port_tiny_autoreg(BASE96, **AR_HEADS)
    tm.load_state_dict(state_dict_from_jax_params(params, tm), strict=True)
    b, jb = tar._batch()
    want_loss, want_norm, jparams = tar._jax_step(jm, params, jb)
    initial = {k: v.clone() for k, v in tm.state_dict().items()}
    m = tar._port_step(tm.train(), b)
    np.testing.assert_allclose(float(m["loss"]), want_loss, rtol=BOUND)
    np.testing.assert_allclose(float(m["grad_norm"]), want_norm, rtol=BOUND)
    ref = state_dict_from_jax_params(jparams, tm)
    for key, value in tm.state_dict().items():
        if not key.startswith("seg_model."):
            assert torch.equal(value, initial[key]), key
            continue
        diff = (value - ref[key]).abs()
        if key.endswith("in_proj_bias"):
            diff[96:192] = 0  # the key biases: 0 in exact arithmetic
        assert diff.max() <= BOUND, (key, diff.max().item())


# ------------------------------------------------------- building, CLIs

@pytest.fixture(scope="module")
def base_dir(tmp_path_factory):
    """A local HF model dir of the base geometry (hidden 96, one head)."""
    return write_base_config(tmp_path_factory.mktemp("base") / "w2v96", 96, 1)


@pytest.mark.parametrize("task", ["shas", "shas_ssl", "shas_ctc", "arseg"])
def test_every_task_builds_on_a_base_backbone(base_dir, task):
    """Each task's model, built as the CLIs build it, on a base backbone
    named by its config dir: the group-norm stack, the held pre-layers
    encoder.layer_norm and, for the SSL tasks, the final LayerNorm of its
    own."""
    node = to_plain(compose(tcli.CONF_DIR, "train", [f"task={task}"]).task)
    node["model"]["wav2vec_model_name"] = str(base_dir)
    model, _ = tcommon.build_model(node, "meta")
    assert not model.w2v_cfg.do_stable_layer_norm
    assert model.w2v_cfg.feat_extract_norm == "group"
    keys = set(model.state_dict())
    ssl = task in ("shas_ssl", "shas_ctc")
    w2v = "wav2vec_model.model." + ("wav2vec2." if ssl else "")
    assert f"{w2v}encoder.layer_norm.weight" in keys
    assert ("wav2vec_model.model.final_layer_norm.weight" in keys) == ssl
    assert f"{w2v}feature_extractor.conv_layers.0.layer_norm.weight" in keys


def test_train_cli_lna_on_a_base_backbone_writes_a_checkpoint_jax_reads(
        tmp_path, corpus, monkeypatch):  # noqa: F811
    """The train CLI on the CPU with LNA (conf/task/shas.yaml: adapters)
    on a base backbone named by its config.json: finite losses; final.pt
    holds the full state_dict, whose trained pre-layers encoder.layer_norm
    moved by decay; the JAX package reads it (torch_convert) and computes
    the same float32 logits; the port's and the JAX segment CLIs segment
    a talk with it into the same custom_segments.yaml."""
    from wav2vecsegmenter_tpu.cli.segment import main as jax_main
    from wav2vecsegmenter_tpu.config import compose as jcompose
    from wav2vecsegmenter_tpu.config import save_config
    from wav2vecsegmenter_tpu_torch.cli.segment import main as port_main

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    model_dir = write_base_config(tmp_path / "w2v", 96, 1)
    talks, segments = corpus
    out = tcli.main([
        "exp_name=run", "batch_size=2", "segment_length=2", "max_epochs=1",
        "update_freq=2", "print_every_steps=1",
        f"task.model.wav2vec_model_name={model_dir}",
        "task.model.n_transformer_enc_heads=1",
        "task.model.finetune_wav2vec=true", "task.model.wav2vec_ft_layers=1",
        f"data.train.talk_list={talks}",
        f"data.train.segments_list={segments}",
        f"data.eval.talk_list={talks}",
        f"data.eval.segments_list={segments}", "+runtime.device=cpu"])
    assert np.isfinite(out["history"]["loss"]).all()
    assert np.isfinite(out["history"]["grad_norm"]).all()
    model = out["model"].eval()
    saved = torch.load(out["checkpoint"], weights_only=True)["state_dict"]
    assert set(saved) == set(model.state_dict())
    fresh, _ = tcommon.build_model(
        {**yaml.safe_load(open("run/.hydra/config.yaml"))["task"]["model"]})
    tw2v.init_from_numpy(fresh, seed=0)
    assert not torch.equal(saved[PRE_LN + "weight"],
                           fresh.state_dict()[PRE_LN + "weight"])
    back, _ = tcommon.build_model(
        {**yaml.safe_load(open("run/.hydra/config.yaml"))["task"]["model"]})
    load_reference_checkpoint(out["checkpoint"], back)

    jm = JaxSHAS(wav2vec_model_name=str(model_dir), finetune_wav2vec=True,
                 wav2vec_ft_layers=1, ffn_adapter=True,
                 n_transformer_enc_heads=1, init_dropout=0.0)
    jparams = convert_reference_checkpoint(
        load_torch_state_dict(out["checkpoint"]), jm)
    np.testing.assert_array_equal(
        np.asarray(jparams["wav2vec"]["encoder_pre_ln"]["scale"]),
        saved[PRE_LN + "weight"].numpy())
    _assert_same_logits(jm, jparams, back.eval())

    (tmp_path / "wav").mkdir()
    make_speechlike_wav(tmp_path / "wav" / "talk.wav", duration_secs=5.3,
                        seed=21)
    with open(tmp_path / "orig.yaml", "w") as f:
        yaml.dump([{"duration": 5.3, "offset": 0.0, "speaker_id": "NA",
                    "wav": "talk.wav"}], f)
    save_config(jcompose(tcli.CONF_DIR, "train", [
        f"task.model.wav2vec_model_name={model_dir}",
        "task.model.n_transformer_enc_heads=1",
        "task.model.finetune_wav2vec=true",
        "task.model.wav2vec_ft_layers=1"]), tmp_path / "train_config.yaml")
    common = [f"ckpt_path={out['checkpoint']}",
              f"config_path={tmp_path}/train_config.yaml",
              f"infer_data.wav_dir={tmp_path}/wav",
              f"infer_data.orig_seg_yaml={tmp_path}/orig.yaml",
              "inference_segment_length=4", "batch_size=2",
              "runtime.compute_dtype=float32"]
    rows_port = port_main(common + [f"output_dir={tmp_path}/port",
                                    f"+results_path={tmp_path}/port",
                                    "+runtime.device=cpu"])
    rows_jax = jax_main(common + [f"output_dir={tmp_path}/jax",
                                  f"+results_path={tmp_path}/jax",
                                  "runtime.kernels=xla", "runtime.mesh.data=1"])
    assert rows_port == rows_jax and rows_port
    assert ((tmp_path / "port" / "custom_segments.yaml").read_bytes()
            == (tmp_path / "jax" / "custom_segments.yaml").read_bytes())


@pytest.mark.parametrize("task", ["shas_ssl", "shas_ctc", "arseg"])
def test_trainer_runs_the_other_tasks_on_a_base_backbone(
        tmp_path, text_corpus, monkeypatch, task):  # noqa: F811
    """The train CLI on the CPU on task=shas_ssl, shas_ctc and arseg with a
    base backbone (hidden 96, D=96 in the heads): finite losses and
    gradients; shas_ssl and shas_ctc run their epoch and write their
    checkpoint, arseg stops at its first evaluation as on every backbone
    (ROADMAP C15)."""
    if task == "arseg":
        monkeypatch.setitem(tcommon.MODELS, "lib.models.AutoRegSegmenter",
                            lambda device=None, **kw: port_tiny_autoreg(
                                BASE96, device=device, **AR_HEADS))
    else:
        for target in ("lib.models.SHASWithSSL", "lib.models.SHASWithCTC"):
            monkeypatch.setitem(
                tcommon.MODELS, target,
                lambda device=None, **kw: port_tiny_ssl(
                    BASE96, device=device, n_transformer_enc_heads=1,
                    vocab_size=kw["vocab_size"],
                    finetune_wav2vec=kw["finetune_wav2vec"]))
    monkeypatch.chdir(tmp_path)
    talks, segments = text_corpus
    args = [f"task={task}", "exp_name=run", "batch_size=2",
            "segment_length=10.1", "max_epochs=1", "update_freq=1",
            "print_every_steps=1", "+runtime.device=cpu",
            f"data.train.talk_list={talks}",
            f"data.train.segments_list={segments}",
            f"data.eval.talk_list={talks}",
            f"data.eval.segments_list={segments}"]
    if task == "arseg":
        steps = []
        from wav2vecsegmenter_tpu_torch.train import loop as tloop

        config = compose(tcli.CONF_DIR, "train", args)
        with pytest.raises(NotImplementedError, match="C15"):
            tloop.train(config, tmp_path, on_step=steps.append)
        assert steps and all(np.isfinite(float(m["loss"])) for m in steps)
        return
    out = tcli.main(args)
    assert np.isfinite(out["history"]["loss"]).all()
    assert np.isfinite(out["history"]["grad_norm"]).all()
    assert out["updates"] == out["steps_per_epoch"][0] >= 2
    saved = torch.load(out["checkpoint"], weights_only=True)["state_dict"]
    model = out["model"]
    assert set(saved) == set((model if task == "shas_ctc" else
                              model.seg_model).state_dict())

