"""LNA fine-tuning in the port (``finetune_wav2vec=True``) against the JAX
package: the train step with the freezing splits and FFN adapters, and the
trainable set.  ``tests/test_torch_lna_parts.py`` holds the autograd
Functions, the checkpoints and the CLIs (a second file, so that the two
halves run on two workers).

Shared weights go JAX ``init`` -> numpy -> the port at ``tests/helpers``'
tiny config (2 layers, dropout 0, SpecAugment off for parity, adapters of
width 16); the JAX side runs its Pallas kernels in interpret mode, as
``tests/test_torch_train.py`` does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wav2vecsegmenter_tpu.models.shas import SHAS as JaxSHAS
from wav2vecsegmenter_tpu.ops.backend import set_backend
from wav2vecsegmenter_tpu.train import step as jstep
from wav2vecsegmenter_tpu.train.loss import BCEWithLogitsLoss as JBCE
from wav2vecsegmenter_tpu_torch.checkpoints.convert import (
    state_dict_from_jax_params)
from wav2vecsegmenter_tpu_torch.infer.pipeline import normalize_int16
from wav2vecsegmenter_tpu_torch.models import wav2vec2 as tw2v
from wav2vecsegmenter_tpu_torch.models.shas import SHAS
from wav2vecsegmenter_tpu_torch.train import loss as tloss
from wav2vecsegmenter_tpu_torch.train import step as tstep

from .helpers import TINY_W2V
from .test_torch_train import (GNORM_RTOL, KEY_BIAS, LOSS_RTOL, LR,
                               PARAM_ATOL, POS_WEIGHT, TOTAL_STEPS, _batches,
                               _jax_batch)
from .torch_tiny import threads_per_worker  # noqa: F401

CFG = dataclasses.replace(TINY_W2V, apply_spec_augment=False, adapter_dim=16)
# Adam's step is lr * m / (sqrt(v) + eps), about lr * sign(g): where an
# update's accumulated gradient is 0 up to roundoff, either side's roundoff
# turns into a step of up to lr.  The key biases' gradients are 0 in exact
# arithmetic (softmax is shift-invariant); elsewhere an element whose
# micro-steps' gradients cancel to within CANCEL of their magnitudes (the
# two sides' float32 gradients agree to ~1e-5 of them) is bounded so too,
# and such elements are at most CANCEL of the trained ones
CANCEL = 1e-3
# the freezing splits of the step tests: (a) every layer trained, FFNs
# frozen; (b) layer 0 frozen, layer 1's FFN and its adapter trained; (c)
# the conv stack and the feature projection trained, layer 0 frozen
CASES = {
    "a": dict(wav2vec_ft_layers=2),
    "b": dict(wav2vec_ft_layers=1, finetune_w2v_ffn=True, ffn_adapter=True),
    "c": dict(wav2vec_ft_layers=1, finetune_w2v_feat_enc=True),
}


def _models(finetune: bool = True, cfg=CFG, **kw):
    """(JAX spec, port module, JAX params) on shared weights."""
    common = dict(wav2vec_keep_layers=2, n_transformer_enc_layers=1,
                  n_transformer_enc_heads=4, init_dropout=0.0,
                  finetune_wav2vec=finetune, **kw)
    jm = JaxSHAS(**common)
    jcfg = dataclasses.replace(cfg, ffn_adapter=jm.use_adapter)
    jm.w2v_cfg, jm.d_model, jm.keep_layers = jcfg, jcfg.hidden_size, 2
    tm = SHAS(**common, w2v_cfg=tw2v.Wav2Vec2Config(**dataclasses.asdict(jcfg)))
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tm.load_state_dict(state_dict_from_jax_params(params, tm), strict=True)
    return jm, tm, params


def _is_key_bias(name: str) -> bool:
    return name.endswith(".attention.k_proj.bias") or name == KEY_BIAS


def _jax_grads_fn(jm):
    """jax.grad of the train step's loss (device-normalised audio, bce with
    POS_WEIGHT, no moving average), jitted."""
    def loss(params, audio, in_lengths, out_mask, target):
        logits = jm.apply(params, audio, in_lengths, out_mask,
                          deterministic=False, rng=jax.random.PRNGKey(0))
        return jstep.compute_bce_loss(
            logits, target, out_mask, JBCE(None).with_pos_weight(POS_WEIGHT),
            0)

    return jax.jit(jax.grad(loss))


def _norm_without_flag(grads) -> tuple[float, float]:
    """(global norm of every leaf, of every leaf but the adapter gate)."""
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    sq = {jax.tree_util.keystr(p): float(jnp.sum(jnp.square(g)))
          for p, g in flat}
    total = sum(sq.values())
    flag = sum(v for k, v in sq.items() if "'flag'" in k)
    return total ** 0.5, (total - flag) ** 0.5


@pytest.mark.parametrize("case,fused", [("a", "1"), ("b", "1"), ("c", "1"),
                                        ("c", "0")])
def test_lna_steps_match_jax(monkeypatch, case, fused):
    """Three LNA micro-steps with update_freq=2 (a full accumulation, then
    the epoch-end flush) against make_train_step / make_accum_flush with
    the JAX trainable mask: loss, grad_norm, every parameter after the
    steps; the frozen ones bitwise unchanged.  With adapters the JAX
    grad_norm includes the gate leaf ``flag``, which the port has not
    (ROADMAP C8): the port's norm is held against jax.grad's without it."""
    monkeypatch.setenv("W2VSEG_CONVFUSE", fused)
    monkeypatch.setenv("W2VSEG_FFNFUSE", fused)
    jm, tm, params = _models(**CASES[case])
    batches = _batches(3)
    update_freq = 2
    set_backend("pallas")
    try:
        with pltpu.force_tpu_interpret_mode():
            opt = jstep.make_optimizer(LR, TOTAL_STEPS, update_freq,
                                       jm.trainable_mask(params))
            state = jstep.init_train_state(
                jm, opt, jax.random.PRNGKey(1),
                jax.tree.map(jnp.asarray, params))
            step = jstep.make_train_step(jm, JBCE(None), "bce", 0, opt,
                                         device_normalize=True,
                                         dynamic_pos_weight=True)
            flush = jstep.make_accum_flush(opt)
            grads_fn = _jax_grads_fn(jm) if jm.use_adapter else None
            want = []
            for i, b in enumerate(batches):
                norm = None
                if grads_fn is not None:
                    audio = normalize_int16(torch.from_numpy(b.audio),
                                            b.norm_length,
                                            torch.from_numpy(b.included))
                    full, norm = _norm_without_flag(grads_fn(
                        state.params, jnp.asarray(audio.numpy()),
                        b.in_lengths, b.out_mask, b.target))
                state, m = step(state, _jax_batch(b), jax.random.PRNGKey(i))
                if grads_fn is not None:
                    np.testing.assert_allclose(full, float(m["grad_norm"]),
                                               rtol=GNORM_RTOL)
                    assert norm < full  # the gate's gradient (C8)
                want.append((float(m["loss"]),
                             norm or float(m["grad_norm"])))
            state = flush(state)
            jparams = jax.device_get(state.params)
    finally:
        set_backend("auto")

    initial = {k: v.clone() for k, v in tm.state_dict().items()}
    trained = tm.set_requires_grad()
    names = [n for n, p in tm.named_parameters() if p.requires_grad]
    assert len(names) == len(trained)
    opt = tstep.AccumulatingAdamW(trained, LR, TOTAL_STEPS, update_freq)
    step = tstep.make_train_step(tm, tloss.BCEWithLogitsLoss(None), 0, opt)
    got, grads = [], []
    for b in batches:
        m = step(b, POS_WEIGHT)
        got.append((float(m["loss"]), float(m["grad_norm"])))
        grads.append(m["grads"])
    assert opt.flush() and opt.updates == 2

    for (gl, gn), (wl, wn) in zip(got, want):
        np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(gn, wn, rtol=GNORM_RTOL)
    ref = state_dict_from_jax_params(jparams, tm)
    h = tm.w2v_cfg.hidden_size
    cancelled = dict(zip(names, _cancelled(grads, [(0, 1), (2,)])))
    n_cancelled = sum(int(c.sum()) for c in cancelled.values())
    assert n_cancelled <= CANCEL * sum(c.numel() for c in cancelled.values())
    for key, value in tm.state_dict().items():
        if key not in names:
            assert torch.equal(value, initial[key]), key
            assert torch.equal(ref[key], initial[key]), key
            continue
        diff = (value - ref[key]).abs()
        if _is_key_bias(key):
            part = slice(h, 2 * h) if key == KEY_BIAS else slice(None)
            cancelled[key][part] = True
        else:
            moved = (value - initial[key]).abs().max()
            assert moved > 10 * PARAM_ATOL, key
        # where an update's gradient is 0 up to roundoff, Adam turns either
        # side's roundoff into a step of up to lr
        assert (diff[cancelled[key]] <= 2 * LR * opt.updates).all(), key
        diff[cancelled[key]] = 0
        assert diff.max() <= PARAM_ATOL, (key, diff.max().item())


def _cancelled(grads, updates) -> list:
    """Per trained parameter, the elements whose accumulated gradient at
    some update cancels to within CANCEL of its micro-steps' magnitudes
    (and is not exactly 0 on both sides)."""
    out = []
    for per_step in zip(*grads):
        mask = torch.zeros_like(per_step[0], dtype=torch.bool)
        for steps in updates:
            total = sum(per_step[i] for i in steps)
            size = sum(per_step[i].abs() for i in steps)
            mask |= (total.abs() <= CANCEL * size) & (size > 0)
        out.append(mask)
    return out


def _jax_trainable_names(jm, tm, params) -> set:
    """The port names of the leaves where ``jm.trainable_mask`` is 1 (the
    mask broadcast to the leaves' shapes and carried through
    ``state_dict_from_jax_params``; each must be all 0 or all 1)."""
    mask = jax.tree.map(lambda m, p: np.broadcast_to(
        np.asarray(m, np.float32), np.shape(p)), jm.trainable_mask(params),
        params)
    layers = params["wav2vec"]["layers"]
    if "adapter" in layers:  # which layers carry one: the params' flags
        mask["wav2vec"]["layers"]["adapter"]["flag"] = \
            layers["adapter"]["flag"]
    sd = state_dict_from_jax_params(mask, tm)
    if "masked_spec_embed" not in params["wav2vec"]:
        del sd["wav2vec_model.model.masked_spec_embed"]  # no JAX leaf
    assert set(sd) <= set(tm.state_dict())
    for key, value in sd.items():
        assert value.min() == value.max() and value.min() in (0, 1), key
    return {key for key, value in sd.items() if value.min() == 1}


@pytest.mark.parametrize("case", [*CASES, "frozen_backbone", "spec_augment"])
def test_trainable_set_matches_jax_mask(case):
    """trainable_parameters() is the set of leaves where the JAX
    trainable_mask is 1, name for name: the three LNA splits, the frozen
    backbone (the head only) and SpecAugment on (masked_spec_embed
    trains); set_requires_grad freezes the rest."""
    if case == "frozen_backbone":
        jm, tm, params = _models(finetune=False, ffn_adapter=True)
    elif case == "spec_augment":
        jm, tm, params = _models(
            cfg=dataclasses.replace(CFG, apply_spec_augment=True),
            **CASES["a"])
    else:
        jm, tm, params = _models(**CASES[case])
    ids = {id(p) for p in tm.trainable_parameters()}
    got = {n for n, p in tm.named_parameters() if id(p) in ids}
    assert got == _jax_trainable_names(jm, tm, params)
    assert ("wav2vec_model.model.masked_spec_embed" in got) == (
        case == "spec_augment")
    tm.set_requires_grad()
    assert {n for n, p in tm.named_parameters() if p.requires_grad} == got
    adapters = {n.split(".")[4] for n, _ in tm.named_parameters()
                if ".ffn_adapter." in n}
    assert adapters == ({"1"} if case == "b" else set())
