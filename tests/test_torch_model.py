"""The port's models and checkpoints (wav2vecsegmenter_tpu_torch) against
the JAX package, on shared weights.

JAX ``init`` -> numpy -> ``state_dict_from_jax_params`` -> the port; the JAX
forward runs its Pallas kernels in interpret mode, in both of the
configurations the port runs: the default (fused conv layers and FFN; at
the small config's conv_dim=64, s*C = 128, so the JAX side really takes
its fused conv kernels) and ``W2VSEG_CONVFUSE=0 W2VSEG_FFNFUSE=0``.  The
flags are set for both sides.  Bound: the < 2e-4 of
tests/test_model_parity.py on valid frames (float32).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wav2vecsegmenter_tpu.checkpoints.torch_export import export_torch_checkpoint
from wav2vecsegmenter_tpu.models import wav2vec2 as jw2v
from wav2vecsegmenter_tpu.models.shas import SHAS as JaxSHAS
from wav2vecsegmenter_tpu.ops.backend import set_backend
from wav2vecsegmenter_tpu_torch.checkpoints.convert import (
    load_reference_checkpoint, state_dict_from_jax_params)
from wav2vecsegmenter_tpu_torch.models import wav2vec2 as tw2v
from wav2vecsegmenter_tpu_torch.models.shas import SHAS

BOUND = 2e-4

SMALL = dict(hidden_size=128, num_layers=2, ffn_dim=256, conv_dim=(64,) * 7,
             num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
             hidden_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0)


def _models(heads: int, finetune: bool = False):
    """(jax spec, port module) at the small config; ``heads`` = 2 gives
    D=64 (the packed head-pair path), 1 gives D=128."""
    jcfg = jw2v.Wav2Vec2Config(num_heads=heads, **SMALL)
    jm = JaxSHAS(wav2vec_keep_layers=2, n_transformer_enc_layers=1,
                 n_transformer_enc_heads=heads, init_dropout=0.0,
                 finetune_wav2vec=finetune)
    jm.w2v_cfg, jm.d_model, jm.keep_layers = jcfg, 128, 2
    tm = SHAS(wav2vec_keep_layers=2, n_transformer_enc_layers=1,
              n_transformer_enc_heads=heads, init_dropout=0.0,
              finetune_wav2vec=finetune,
              w2v_cfg=tw2v.Wav2Vec2Config(**dataclasses.asdict(jcfg)))
    return jm, tm


@functools.lru_cache(maxsize=None)
def _jax_params(heads: int):
    jm, _ = _models(heads)
    return jax.device_get(jm.init(jax.random.PRNGKey(heads)))


def _shared_weights(heads: int, finetune: bool = False):
    jm, tm = _models(heads, finetune)
    params = _jax_params(heads)
    tm.load_state_dict(state_dict_from_jax_params(params, tm), strict=True)
    return jm, tm, params


def _inputs(t_out: int):
    rng = np.random.RandomState(7)
    lengths = np.array([32000, 20000, 0], np.int32)  # full, part, padding
    audio = rng.randn(3, 32000).astype(np.float32)
    audio[np.arange(32000)[None, :] >= lengths[:, None]] = 0.0
    out_mask = np.arange(t_out)[None, :] < np.array([t_out, 62, 0])[:, None]
    return audio, lengths, out_mask


@pytest.fixture(params=["fused", "unfused"])
def jax_pallas_unfused(request, monkeypatch):
    """A configuration both packages run: Pallas kernels in interpret mode,
    conv and FFN fusion on (the default) or off (the A/B arm); the JAX
    package reads the flags at trace time, the port at call time."""
    flag = "1" if request.param == "fused" else "0"
    monkeypatch.setenv("W2VSEG_CONVFUSE", flag)
    monkeypatch.setenv("W2VSEG_FFNFUSE", flag)
    set_backend("pallas")
    try:
        with pltpu.force_tpu_interpret_mode():
            yield
    finally:
        set_backend("auto")


# conv stack on 32000 samples gives 99 frames: t_out 100 pads, 98 cuts
@pytest.mark.parametrize("heads,t_out", [(2, 100), (1, 98)])
def test_shas_logits_match_jax(jax_pallas_unfused, heads, t_out):
    jm, tm, params = _shared_weights(heads)
    audio, lengths, out_mask = _inputs(t_out)
    ref = np.asarray(jm.apply(params, jnp.asarray(audio),
                              jnp.asarray(lengths), jnp.asarray(out_mask)))
    with torch.no_grad():
        got = tm(torch.from_numpy(audio), torch.from_numpy(lengths),
                 torch.from_numpy(out_mask)).numpy()
    assert got.shape == ref.shape == out_mask.shape
    assert np.isfinite(got).all()
    diff = np.abs(got - ref)[out_mask]
    assert diff.max() < BOUND, f"max abs diff {diff.max()}"


def test_backbone_hidden_and_frame_mask_match_jax(jax_pallas_unfused):
    jm, tm, params = _shared_weights(2)
    audio, lengths, _ = _inputs(100)
    h_ref, fm_ref = jw2v.wav2vec2_forward(
        params["wav2vec"], jnp.asarray(audio), jnp.asarray(lengths), jm.w2v_cfg)
    with torch.no_grad():
        h, fm = tw2v.wav2vec2_forward(tm.wav2vec_model.model,
                                      torch.from_numpy(audio),
                                      torch.from_numpy(lengths))
    fm, fm_ref = fm.numpy(), np.asarray(fm_ref)
    np.testing.assert_array_equal(fm, fm_ref)
    assert fm.sum(1).tolist() == [99, 62, 0]
    diff = np.abs(h.numpy() - np.asarray(h_ref))[fm]
    assert diff.max() < BOUND, f"max abs diff {diff.max()}"


@pytest.mark.parametrize("layout", ["full", "seg_only"])
def test_reference_checkpoint_round_trip(tmp_path, monkeypatch, layout):
    """JAX params -> reference .pt (export_torch_checkpoint) -> the port."""
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))  # no local snapshot
    jm, tm = _models(2, finetune=layout == "full")
    params = _jax_params(2)
    path = export_torch_checkpoint(params, jm, tmp_path / "ckpt.pt")
    want = state_dict_from_jax_params(params, tm)
    if layout == "seg_only":
        with pytest.raises(FileNotFoundError):
            load_reference_checkpoint(path, tm)
        load_reference_checkpoint(path, tm, allow_random_wav2vec=True)
        want = {k: v for k, v in want.items() if k.startswith("seg_model.")}
    else:
        load_reference_checkpoint(path, tm)
    got = tm.state_dict()
    for key, value in want.items():
        torch.testing.assert_close(got[key], value, rtol=0, atol=0)


def test_presets_equal_the_jax_presets():
    assert tw2v.PRESETS == jw2v.PRESETS
    assert (dataclasses.asdict(tw2v.Wav2Vec2Config())
            == dataclasses.asdict(jw2v.Wav2Vec2Config()))
    for name in jw2v.PRESETS:
        for keep in (None, 15):
            assert (dataclasses.asdict(tw2v.config_for(name, keep))
                    == dataclasses.asdict(jw2v.config_for(name, keep)))


def test_numpy_init_is_seeded_and_finite():
    """The seeded numpy init (used for the full-width run on the card) is
    reproducible and gives finite logits."""
    _, a = _models(2)
    _, b = _models(2)
    tw2v.init_from_numpy(a, 5)
    tw2v.init_from_numpy(b, 5)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
    audio, lengths, out_mask = _inputs(100)
    with torch.no_grad():
        out = a(torch.from_numpy(audio), torch.from_numpy(lengths),
                torch.from_numpy(out_mask))
    assert torch.isfinite(out).all()
