"""The parts of LNA fine-tuning in the port against the JAX package: the
autograd Functions of the kernels the encoder runs under grad, the
full-layout checkpoints with FFN adapters, and the CLIs on an LNA run
(``tests/test_torch_lna.py`` holds the train step and the trainable set).

The Functions' gradients go through their kernel branch with the launches
stood in for by the plain versions (``kernels_forced``), against
``jax.vjp`` through the JAX custom VJPs in interpret mode.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from wav2vecsegmenter_tpu.checkpoints.torch_convert import (
    convert_reference_checkpoint, load_torch_state_dict)
from wav2vecsegmenter_tpu.checkpoints.torch_export import export_torch_checkpoint
from wav2vecsegmenter_tpu.models import wav2vec2 as jw2v
from wav2vecsegmenter_tpu.models.shas import SHAS as JaxSHAS
from wav2vecsegmenter_tpu.ops import attention as jattn
from wav2vecsegmenter_tpu.ops import convfuse as jconv
from wav2vecsegmenter_tpu.ops import ffn as jffn
from wav2vecsegmenter_tpu.ops import layernorm as jln
from wav2vecsegmenter_tpu_torch.checkpoints.convert import (
    load_pretrained_backbone, load_reference_checkpoint)
from wav2vecsegmenter_tpu_torch.cli import common as tcommon
from wav2vecsegmenter_tpu_torch.cli import train as tcli
from wav2vecsegmenter_tpu_torch.models import wav2vec2 as tw2v
from wav2vecsegmenter_tpu_torch.models.shas import SHAS
from wav2vecsegmenter_tpu_torch.models.wav2vec2 import init_from_numpy
from wav2vecsegmenter_tpu_torch.ops import attention as tattn
from wav2vecsegmenter_tpu_torch.ops import convfuse as tconv
from wav2vecsegmenter_tpu_torch.ops import ffn as tffn
from wav2vecsegmenter_tpu_torch.ops import layernorm as tln

from .helpers import make_speechlike_wav
from .test_torch_fused import CONV_CASES, _conv_inputs, _round
from .test_torch_lna import CASES, CFG, _models
from .test_torch_ops import (DTYPES, LENGTHS, _assert_grads_close, _key_mask,
                             _pallas_vjp, kernels_forced)  # noqa: F401
from .test_torch_train import _cli_args, corpus  # noqa: F401
from .torch_tiny import threads_per_worker  # noqa: F401

BOUND = 2e-4  # float32 logits, tests/test_model_parity.py's bound
EPS = 1e-5
# a bf16 replay's gradients against float32, relative to the JAX bf16
# one's distance (chip_smoke.py's KERNEL_SLACK)
REPLAY_SLACK = 1.25


# ------------------------------------------------ the autograd Functions

def _f32(*arrays):
    return tuple(torch.from_numpy(a).requires_grad_() for a in arrays)


def _assert_replay_grads_close(got, want, dtype):
    """``want(jdt)``: the JAX gradients with operands in ``jdt``.  float32:
    each gradient within _assert_grads_close's limits.  bf16: the two sides
    round every intermediate of the replayed composition independently and
    sum the rounded terms in other orders, so each gradient is held to be
    as close (relative L2) to the float32 gradient as the JAX bf16 one,
    within REPLAY_SLACK."""
    if dtype == "float32":
        _assert_grads_close(got, want(jnp.float32), dtype)
        return
    for g, wb, wf in zip(got, want(jnp.bfloat16), want(jnp.float32)):
        g = g.float().numpy()
        assert np.isfinite(g).all()
        norm = np.linalg.norm(wf)
        port, jax_ = (np.linalg.norm(a - wf) / norm for a in (g, wb))
        assert port <= REPLAY_SLACK * jax_, (g.shape, port, jax_)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ffn_fn_grads_match_jax_vjp(kernels_forced, dtype):
    """_FFNFn (K5's stand-in forward, the ffn_composed replay) against
    jax.vjp through _ffn_fused's custom VJP (ffn_xla's), every input."""
    tdt = DTYPES[dtype][0]
    rng = np.random.RandomState(21)
    b, t, h, f = 2, 37, 64, 256
    x = _round(rng.randn(b, t, h).astype(np.float32), tdt)
    w1 = _round((rng.randn(h, f) * h ** -0.5).astype(np.float32), tdt)
    b1 = _round((rng.randn(f) * 0.1).astype(np.float32), tdt)
    w2 = _round((rng.randn(f, h) * f ** -0.5).astype(np.float32), tdt)
    b2 = _round((rng.randn(h) * 0.1).astype(np.float32), tdt)
    g = rng.randn(b, t, h).astype(np.float32)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    params = _f32(w1.T.copy(), b1, w2.T.copy(), b2)
    out = tffn.ffn(xt, *params)
    assert kernels_forced["ffn"] == 1 and out.dtype == tdt
    got = torch.autograd.grad(out, (xt, *params), torch.from_numpy(g).to(tdt))

    def want(jdt):
        grads = _pallas_vjp(
            lambda a, p1, q1, p2, q2: jffn._ffn_fused(
                a, p1.astype(jdt), q1.astype(jdt), p2.astype(jdt),
                q2.astype(jdt), 16),
            (jnp.asarray(x, jdt), *(jnp.asarray(a)
                                    for a in (w1, b1, w2, b2))),
            jnp.asarray(g, jdt))
        grads[1], grads[3] = grads[1].T, grads[3].T  # [in, out] -> torch
        return grads

    assert got[0].dtype == tdt and all(a.dtype == torch.float32
                                       for a in got[1:])
    _assert_replay_grads_close(got, want, dtype)


class _CountMatmuls(torch.overrides.TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.n += "matmul" in getattr(func, "__name__", "")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("trained", [False, True])
def test_ffn_fn_computes_only_the_asked_gradients(kernels_forced, trained):
    """With frozen weights (finetune_w2v_ffn=False) the backward is dx
    only: the first product recomputed and two more, three GEMMs; with
    trained weights two more for dw1 and dw2.  The gradients are
    autograd's through ffn_composed."""
    rng = np.random.RandomState(22)
    x = torch.from_numpy(rng.randn(2, 9, 64).astype(np.float32))
    x.requires_grad_()
    params = [torch.from_numpy(rng.randn(*s).astype(np.float32))
              .requires_grad_(trained)
              for s in ((128, 64), (128,), (64, 128), (64,))]
    out = tffn.ffn(x, *params)
    g = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
    with _CountMatmuls() as count:
        grads = out.grad_fn.apply(g)
    assert count.n == (5 if trained else 3)
    assert grads[0] is not None
    assert all((gr is not None) == trained for gr in grads[1:])
    # the hand-written backward is the VJP of ffn_composed
    inputs = [x] + [p for p in params if trained]
    want = torch.autograd.grad(tffn.ffn_composed(x, *params), inputs, g)
    for got, w in zip([gr for gr in grads if gr is not None], want):
        torch.testing.assert_close(got, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["2tap_wide", "audio"])
def test_conv_fn_grads_match_jax_vjp(kernels_forced, monkeypatch, case,
                                     dtype):
    """_ConvLnGeluFn (the K6 and K7 stand-in forwards, the
    conv_bias_ln_gelu_composed replay) against jax.vjp through the JAX
    layer: its fold and tap weights (models/wav2vec2.feature_extractor)
    around convfuse._fused's custom VJP (_xla_ref's), every input."""
    tdt = DTYPES[dtype][0]
    monkeypatch.setattr(jconv, "_CONVWIDE", True)
    k, s, c, t = CONV_CASES[case]
    t_out = (t - k) // s + 1
    x, w, cb, scale, bias = _conv_inputs(k, s, c, t, seed=k * 10 + c)
    x, w = _round(x, tdt), _round(w, tdt)
    g = np.random.RandomState(23).randn(2, t_out, 128).astype(np.float32)

    def jax_layer(jdt, xx, ww, cbb, sc, bi):
        wj = jnp.transpose(ww, (2, 1, 0))  # [k, C, O]
        y = jw2v._fold_for_taps(xx, k, s, t_out, jdt)
        if case == "audio":
            y = jnp.concatenate([y[:, p:p + t_out]
                                 for p in range(-(-k // s))], axis=-1)
            taps = wj.reshape(-1, wj.shape[-1])[None]
        else:
            taps = jw2v._tap_weights(wj, s)
        return jconv._fused(y, taps.astype(jdt), cbb, sc, bi, EPS, t_out,
                            16)

    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    params = _f32(w, cb, scale, bias)
    out = tconv.conv_bias_ln_gelu(xt, *params, s, EPS)
    name = "conv_audio_ln_gelu" if case == "audio" else "conv_bias_ln_gelu"
    assert kernels_forced[name] == 1
    got = torch.autograd.grad(out, (xt, *params), torch.from_numpy(g).to(tdt))

    def want(jdt):
        return _pallas_vjp(
            lambda *a: jax_layer(jdt, *a),
            (jnp.asarray(x, jdt), *(jnp.asarray(a)
                                    for a in (w, cb, scale, bias))),
            jnp.asarray(g, jdt))

    _assert_replay_grads_close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_bias_ln_gelu_fn_grads_match_jax_vjp(kernels_forced, dtype):
    """_BiasLnGeluFn (K2's stand-in forward, the
    bias_layer_norm_gelu_composed replay) against jax.vjp through
    _bln_gelu_2d's custom VJP (_bln_gelu_xla's), every input."""
    tdt = DTYPES[dtype][0]
    rng = np.random.RandomState(24)
    rows, h = 150, 128
    x = _round((rng.randn(rows, h) * 2.0 + 0.5).astype(np.float32), tdt)
    cb, scale, bias = ((rng.randn(h) * 0.3).astype(np.float32),
                       (1.0 + 0.1 * rng.randn(h)).astype(np.float32),
                       (0.1 * rng.randn(h)).astype(np.float32))
    g = rng.randn(rows, h).astype(np.float32)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    params = _f32(cb, scale, bias)
    out = tln.bias_layer_norm_gelu(xt, *params)
    assert kernels_forced["bias_layer_norm_gelu"] == 1
    got = torch.autograd.grad(out, (xt, *params), torch.from_numpy(g).to(tdt))

    def want(jdt):
        return _pallas_vjp(
            lambda a, c, sc, bi: jln._bln_gelu_2d(a, c, sc, bi, EPS, 64),
            (jnp.asarray(x, jdt), *(jnp.asarray(a)
                                    for a in (cb, scale, bias))),
            jnp.asarray(g, jdt))

    _assert_replay_grads_close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_packed_grad_matches_jax_vjp(kernels_forced, dtype):
    """attention_packed under grad (the K3 stand-in forward, counted as
    attention_packed, and K10's at D=64 writing the packed [B, T, 3H]
    gradient) against jax.vjp through _fused_attn_packed's custom VJP,
    with ragged and all-masked key rows."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.RandomState(25)
    b, t, heads, h = len(LENGTHS), 50, 2, 128
    proj = _round(rng.randn(b, t, 3 * h).astype(np.float32), tdt)
    g = rng.randn(b, t, h).astype(np.float32)
    mask = _key_mask(LENGTHS, t)
    scale = (h // heads) ** -0.5
    pt = torch.from_numpy(proj).to(tdt).requires_grad_()
    out = tattn.attention_packed(pt, torch.from_numpy(mask), heads, scale)
    assert out.shape == (b, t, h)
    dproj, = torch.autograd.grad(out, pt, torch.from_numpy(g).to(tdt))
    assert kernels_forced["attention_packed"] == 1
    assert kernels_forced["attention_bthd"] == 0
    assert kernels_forced["attention_bwd"] == 1
    bias = jattn._key_bias(jnp.asarray(mask), b, t)
    want = _pallas_vjp(
        lambda p: jattn._fused_attn_packed(p, bias, float(scale), heads),
        (jnp.asarray(proj, jdt),), jnp.asarray(g, jdt))
    _assert_grads_close((dproj,), want, dtype)


# ---------------------------------------------- checkpoints and the CLIs

def _logits_inputs():
    rng = np.random.RandomState(7)
    lengths = np.array([32000, 20000], np.int32)
    audio = rng.randn(2, 32000).astype(np.float32)
    audio[np.arange(32000)[None, :] >= lengths[:, None]] = 0.0
    out_mask = np.arange(100)[None, :] < np.array([100, 62])[:, None]
    return audio, lengths, out_mask


def _assert_same_logits(jm, jparams, tm):
    audio, lengths, out_mask = _logits_inputs()
    ref = np.asarray(jm.apply(jparams, jnp.asarray(audio),
                              jnp.asarray(lengths), jnp.asarray(out_mask)))
    with torch.no_grad():
        got = tm(torch.from_numpy(audio), torch.from_numpy(lengths),
                 torch.from_numpy(out_mask)).numpy()
    assert np.isfinite(got).all()
    diff = np.abs(got - ref)[out_mask]
    assert diff.max() < BOUND, f"max abs diff {diff.max()}"


def test_pretrained_snapshot_loads_into_a_model_with_adapters(tmp_path,
                                                              monkeypatch):
    """A pretrained HF snapshot has no FFN adapters: load_pretrained_backbone
    loads it into a model built with them, strict for every other key, and
    the adapters keep their own weights."""
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    _, plain, _ = _models(**CASES["a"])
    snap = (tmp_path / "hub" / "models--facebook--wav2vec2-xls-r-300m"
            / "snapshots" / "0")
    snap.mkdir(parents=True)
    backbone = plain.wav2vec_model.model.state_dict()
    torch.save({f"wav2vec2.{k}": v for k, v in backbone.items()},
               snap / "pytorch_model.bin")
    _, tm, _ = _models(**CASES["b"])
    init_from_numpy(tm, seed=5)
    adapters = {k: v.clone() for k, v in tm.state_dict().items()
                if ".ffn_adapter." in k}
    assert adapters
    assert load_pretrained_backbone(tm)
    got = tm.wav2vec_model.model.state_dict()
    assert set(got) == set(backbone) | {k[len("wav2vec_model.model."):]
                                        for k in adapters}
    for key, value in backbone.items():
        assert torch.equal(got[key], value), key
    for key, value in adapters.items():
        assert torch.equal(tm.state_dict()[key], value), key


def test_jax_lna_checkpoint_loads_into_the_port(tmp_path, monkeypatch):
    """JAX params with adapters in the fine-tuned layer -> a full-layout
    reference .pt (export_torch_checkpoint) -> the port's
    load_reference_checkpoint into a model built with ffn_adapter=True:
    the same float32 logits."""
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))  # no local snapshot
    jm, _, params = _models(**CASES["b"])
    path = export_torch_checkpoint(params, jm, tmp_path / "ckpt.pt")
    saved = torch.load(path, weights_only=True)["state_dict"]
    assert any(".layers.1.ffn_adapter." in k for k in saved)
    assert not any(".layers.0.ffn_adapter." in k for k in saved)
    _, tm, _ = _models(**CASES["b"])
    init_from_numpy(tm, seed=3)  # nothing of the JAX weights is left
    load_reference_checkpoint(path, tm)
    _assert_same_logits(jm, params, tm)


def test_train_cli_lna_writes_a_full_checkpoint_jax_reads(tmp_path, corpus,
                                                          monkeypatch):
    """The train CLI with finetune_wav2vec=true trains the tiny model on
    the CPU to the end (and raises without a GPU unless asked for the CPU):
    layer 0 and every FFN stay frozen, the rest moves; final.pt holds the
    full state_dict with adapters in the fine-tuned layer only; the JAX
    package reads it (torch_convert) and computes the same float32
    logits."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    lna = ["task.model.finetune_wav2vec=true",
           "task.model.wav2vec_ft_layers=1"]  # conf/task/shas.yaml: adapters
    args = _cli_args(tmp_path, corpus) + lna
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(args)
    out = tcli.main(args + ["+runtime.device=cpu"])
    hist, steps = out["history"], out["steps_per_epoch"]
    assert len(hist["loss"]) == sum(steps) and len(steps) == 2
    assert np.isfinite(hist["loss"]).all()
    assert np.isfinite(hist["grad_norm"]).all()
    assert np.isfinite(list(out["eval"].values())).all()
    model = out["model"]
    saved = torch.load(out["checkpoint"], weights_only=True)["state_dict"]
    assert set(saved) == set(model.state_dict())
    assert {k.split(".")[4] for k in saved if ".ffn_adapter." in k} == {"1"}
    fresh, _ = tcommon.build_model(
        {**yaml.safe_load(open("run/.hydra/config.yaml"))["task"]["model"]})
    init_from_numpy(fresh, seed=0)
    for key, value in fresh.state_dict().items():
        w2v = key.startswith("wav2vec_model.model.")
        frozen = w2v and (".layers.0." in key or ".feed_forward." in key
                          or ".feature_" in key)
        assert torch.equal(saved[key], value) == frozen, key

    jm = JaxSHAS(wav2vec_model_name=str(tmp_path / "w2v"),
                 finetune_wav2vec=True, wav2vec_ft_layers=1,
                 ffn_adapter=True, n_transformer_enc_heads=1,
                 init_dropout=0.0)
    jparams = convert_reference_checkpoint(
        load_torch_state_dict(out["checkpoint"]), jm)
    np.testing.assert_array_equal(
        np.asarray(jparams["wav2vec"]["layers"]["adapter"]["flag"]), [0, 1])
    _assert_same_logits(jm, jparams, model.eval())


# --------------------------------------------------- the segment CLI (v)

TALKS = ("talk1.wav", "talk2.wav")


def _jax_lna():
    jm = JaxSHAS(wav2vec_keep_layers=2, n_transformer_enc_layers=1,
                 n_transformer_enc_heads=4, init_dropout=0.0,
                 **CASES["b"], finetune_wav2vec=True)
    jm.w2v_cfg = dataclasses.replace(CFG, ffn_adapter=True)
    jm.d_model, jm.keep_layers = CFG.hidden_size, 2
    return jm


def _port_lna() -> SHAS:
    return SHAS(wav2vec_keep_layers=2, n_transformer_enc_layers=1,
                n_transformer_enc_heads=4, init_dropout=0.0,
                **CASES["b"], finetune_wav2vec=True,
                w2v_cfg=tw2v.Wav2Vec2Config(**dataclasses.asdict(
                    dataclasses.replace(CFG, ffn_adapter=True))))


def test_segment_cli_on_an_lna_checkpoint_equals_jax_cli(tmp_path,
                                                         monkeypatch):
    """An LNA checkpoint with adapters segments the e2e fixtures (talks of
    65 s and 41.2 s) through the port's CLI into a custom_segments.yaml
    byte-equal to the JAX CLI's (both float32, the JAX engine on XLA)."""
    from wav2vecsegmenter_tpu.cli.segment import main as jax_main
    from wav2vecsegmenter_tpu.config import compose, registry, save_config
    from wav2vecsegmenter_tpu_torch.cli.segment import main as port_main

    import tests.helpers as helpers

    (tmp_path / "wav").mkdir()
    make_speechlike_wav(tmp_path / "wav" / TALKS[0], duration_secs=65.0,
                        seed=0)
    make_speechlike_wav(tmp_path / "wav" / TALKS[1], duration_secs=41.2,
                        seed=1)
    orig = [{"duration": d, "offset": 0.0, "speaker_id": "NA", "wav": w}
            for d, w in zip((65.0, 41.2), TALKS)]
    with open(tmp_path / "orig.yaml", "w") as f:
        yaml.dump(orig, f)
    jm = _jax_lna()
    params = jax.device_get(jm.init(jax.random.PRNGKey(4)))
    export_torch_checkpoint(params, jm, tmp_path / "ckpt.pt")
    save_config(compose(Path(__file__).parents[1] / "conf", "train",
                        ["task.model.finetune_wav2vec=true"]),
                tmp_path / "train_config.yaml")
    monkeypatch.setitem(registry._ALIASES, "lib.models.SHAS",
                        "tests.helpers:_tiny_builder")
    monkeypatch.setattr(helpers, "_tiny_builder", lambda **kwargs: _jax_lna(),
                        raising=False)
    monkeypatch.setattr(tcommon, "build_model",
                        lambda conf, device=None: (_port_lna().to(device),
                                                   None))
    common = [f"ckpt_path={tmp_path}/ckpt.pt",
              f"config_path={tmp_path}/train_config.yaml",
              f"infer_data.wav_dir={tmp_path}/wav",
              f"infer_data.orig_seg_yaml={tmp_path}/orig.yaml",
              "batch_size=3", "runtime.compute_dtype=float32",
              "algorithm=pthr"]
    out_jax, out_port = tmp_path / "jax", tmp_path / "port"
    rows_jax = jax_main(common + [f"output_dir={out_jax}",
                                  f"+results_path={out_jax}",
                                  "runtime.kernels=xla", "runtime.mesh.data=1"])
    rows_port = port_main(common + [f"output_dir={out_port}",
                                    f"+results_path={out_port}",
                                    "+runtime.device=cpu"])
    assert rows_port == rows_jax
    assert {r["wav"] for r in rows_port} == set(TALKS)
    assert ((out_port / "custom_segments.yaml").read_bytes()
            == (out_jax / "custom_segments.yaml").read_bytes())
