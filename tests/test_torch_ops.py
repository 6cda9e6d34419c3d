"""The port's ops (wav2vecsegmenter_tpu_torch.ops) against the JAX package.

On CPU tensors each port op runs its plain PyTorch version; here the same
seeded numpy inputs go through the JAX Pallas kernels (interpret mode, as
the JAX package's own tests run them) and their XLA references.  The CUDA
kernels themselves are held against the plain versions on the card by
``chip_smoke.py`` (pytest cannot collect tests/ there: conftest imports
jax, which the card's machine lacks).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from wav2vecsegmenter_tpu.ops import attention as jattn
from wav2vecsegmenter_tpu.ops import layernorm as jln
from wav2vecsegmenter_tpu.ops.backend import set_backend
from wav2vecsegmenter_tpu_torch.models import sfc as tsfc
from wav2vecsegmenter_tpu_torch.models.wav2vec2 import init_from_numpy
from wav2vecsegmenter_tpu_torch.ops import _build as tbuild
from wav2vecsegmenter_tpu_torch.ops import attention as tattn
from wav2vecsegmenter_tpu_torch.ops import backend as tbackend
from wav2vecsegmenter_tpu_torch.ops import convfuse as tconv
from wav2vecsegmenter_tpu_torch.ops import ffn as tffn
from wav2vecsegmenter_tpu_torch.ops import layernorm as tln

LN_ATOL = 1e-5     # float32 statistics, different summation orders
ATTN_ATOL = 2e-5   # float32 softmax over <= 64 keys, different orders


# gradients: float32 sums in different orders (the LayerNorm's column sums
# run over ~100 rows); bf16: one bf16 step at the tensor's largest magnitude
GRAD_F32 = dict(atol=1e-5, rtol=1e-6)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _pallas(fn):
    set_backend("pallas")
    try:
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(fn())
    finally:
        set_backend("auto")


def _pallas_vjp(fn, primals, cotangent):
    """jax.vjp through the Pallas custom VJP, in interpret mode -> float32
    numpy cotangents of the primals."""
    set_backend("pallas")
    try:
        with pltpu.force_tpu_interpret_mode():
            _, vjp = jax.vjp(fn, *primals)
            return [np.asarray(a.astype(jnp.float32)) for a in vjp(cotangent)]
    finally:
        set_backend("auto")


def _assert_grads_close(got, want, dtype):
    for g, w in zip(got, want):
        g = g.float().numpy()
        assert np.isfinite(g).all()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, **GRAD_F32)
        else:
            step = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
            np.testing.assert_allclose(g, w, atol=step, rtol=0)


def _ln_inputs(rows_shape, h, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*rows_shape, h).astype(np.float32) * 2.0 + 0.5
    scale = (1.0 + 0.1 * rng.randn(h)).astype(np.float32)
    bias = (0.1 * rng.randn(h)).astype(np.float32)
    cbias = (0.3 * rng.randn(h)).astype(np.float32)
    return x, scale, bias, cbias


@pytest.mark.parametrize("rows_shape,h", [((3, 37), 128), ((513,), 64),
                                          ((2, 5, 7), 512)])
def test_layer_norm_matches_jax(rows_shape, h):
    x, scale, bias, _ = _ln_inputs(rows_shape, h, seed=h)
    got = tln.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                         torch.from_numpy(bias)).numpy()
    ref_pallas = _pallas(lambda: jln.layer_norm_pallas(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    ref_xla = np.asarray(jln.layer_norm_xla(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    np.testing.assert_allclose(got, ref_pallas, atol=LN_ATOL, rtol=0)
    np.testing.assert_allclose(got, ref_xla, atol=LN_ATOL, rtol=0)


@pytest.mark.parametrize("rows_shape,h", [((3, 37), 128), ((2, 300), 64)])
def test_bias_layer_norm_gelu_matches_jax(rows_shape, h):
    x, scale, bias, cbias = _ln_inputs(rows_shape, h, seed=h + 1)
    got = tln.bias_layer_norm_gelu(
        torch.from_numpy(x), torch.from_numpy(cbias), torch.from_numpy(scale),
        torch.from_numpy(bias)).numpy()
    args = [jnp.asarray(a) for a in (x, cbias, scale, bias)]
    ref_pallas = _pallas(lambda: jln.bias_layer_norm_gelu(*args))
    ref_xla = np.asarray(jln._bln_gelu_xla(*args, 1e-5))
    np.testing.assert_allclose(got, ref_pallas, atol=LN_ATOL, rtol=0)
    np.testing.assert_allclose(got, ref_xla, atol=LN_ATOL, rtol=0)


def _key_mask(lengths, t):
    return np.arange(t)[None, :] < np.asarray(lengths)[:, None]


# ragged key masks: full, about half, 1 frame, and one row with every key
# masked (a batch-padding row)
LENGTHS = [50, 23, 1, 0]


def _valid_rows(mask):
    """[B, T] query rows to compare: real frames of rows with any key."""
    return mask & mask.any(axis=1, keepdims=True)


@pytest.mark.parametrize("num_heads,h", [(2, 128), (1, 128)])  # D=64, D=128
def test_attention_packed_matches_jax(num_heads, h):
    rng = np.random.RandomState(num_heads)
    b, t = len(LENGTHS), 50
    proj = rng.randn(b, t, 3 * h).astype(np.float32)
    mask = _key_mask(LENGTHS, t)
    scale = (h // num_heads) ** -0.5
    got = tattn.attention_packed(torch.from_numpy(proj),
                                 torch.from_numpy(mask), num_heads,
                                 scale).numpy()
    ref = _pallas(lambda: jattn.attention_packed(
        jnp.asarray(proj), jnp.asarray(mask), num_heads, scale))
    rows = _valid_rows(mask)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[rows], ref[rows], atol=ATTN_ATOL, rtol=0)
    # the all-masked row averages its values with finite uniform weights
    v = proj[3, :, 2 * h:]
    np.testing.assert_allclose(got[3], np.broadcast_to(v.mean(0), (t, h)),
                               atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("heads,d", [(8, 128), (2, 64)])
def test_attention_bthd_matches_jax(heads, d):
    rng = np.random.RandomState(d)
    b, t = len(LENGTHS), 50
    q, k, v = (rng.randn(b, t, heads, d).astype(np.float32) for _ in range(3))
    mask = _key_mask(LENGTHS, t)
    got = tattn.attention_bthd(*(torch.from_numpy(a) for a in (q, k, v)),
                               torch.from_numpy(mask), d ** -0.5).numpy()
    ref = _pallas(lambda: jattn.attention_pallas_bthd(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask), d ** -0.5))
    rows = _valid_rows(mask)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[rows], ref[rows], atol=ATTN_ATOL, rtol=0)


def test_cpu_tensors_take_the_plain_path_in_both_modes():
    """A CPU tensor runs the plain version in either mode and launches no
    kernel; the mode names are checked."""
    x = torch.randn(4, 64)
    s, bi = torch.ones(64), torch.zeros(64)
    tbackend.reset_launch_counts()
    for mode in tbackend.MODES:
        tbackend.set_kernels(mode)
        try:
            torch.testing.assert_close(tln.layer_norm(x, s, bi),
                                       tln.layer_norm_plain(x, s, bi))
        finally:
            tbackend.set_kernels("auto")
    assert set(tbackend.launch_counts().values()) == {0}
    with pytest.raises(ValueError):
        tbackend.set_kernels("xla")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_layer_norm_grad_matches_jax_vjp(dtype):
    """torch.autograd.grad through layer_norm (K9's formula on the CPU)
    against jax.vjp through _ln_2d's custom VJP (_ln_bwd_kernel), with a
    ragged row count (111 rows, JAX pads them to a block of 256)."""
    tdt, jdt = DTYPES[dtype]
    x, scale, bias, _ = _ln_inputs((3, 37), 128, seed=11)
    g = np.random.RandomState(12).randn(3, 37, 128).astype(np.float32)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    got = torch.autograd.grad(tln.layer_norm(xt, st, bt), (xt, st, bt),
                              torch.from_numpy(g).to(tdt))
    assert got[0].dtype == tdt and got[1].dtype == torch.float32
    want = _pallas_vjp(lambda a, s, b: jln.layer_norm_pallas(a, s, b),
                       (jnp.asarray(x, jdt), jnp.asarray(scale),
                        jnp.asarray(bias)), jnp.asarray(g, jdt))
    _assert_grads_close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("heads,d", [(8, 128), (2, 64)])
def test_attention_grad_matches_jax_vjp(dtype, heads, d):
    """torch.autograd.grad through attention_bthd and attention_qkv (K10's
    arithmetic on the CPU) against jax.vjp through _fused_attention's
    custom VJP (_attn_bwd_kernel), with ragged and all-masked key rows."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.RandomState(d + heads)
    b, t = len(LENGTHS), 50
    q, k, v, do = (rng.randn(b, t, heads, d).astype(np.float32)
                   for _ in range(4))
    mask = _key_mask(LENGTHS, t)
    scale = d ** -0.5
    want = _pallas_vjp(
        lambda a, bb, c: jattn.attention_pallas_bthd(a, bb, c,
                                                     jnp.asarray(mask), scale),
        tuple(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(do, jdt))
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (q, k, v))
    dout = torch.from_numpy(do).to(tdt)
    got = torch.autograd.grad(
        tattn.attention_bthd(tq, tk, tv, torch.from_numpy(mask), scale),
        (tq, tk, tv), dout)
    _assert_grads_close(got, want, dtype)
    qkv = torch.from_numpy(np.stack([q, k, v], axis=2)).to(tdt)
    qkv.requires_grad_()
    dqkv, = torch.autograd.grad(
        tattn.attention_qkv(qkv, torch.from_numpy(mask), scale), qkv, dout)
    _assert_grads_close(dqkv.unbind(2), want, dtype)


@pytest.fixture
def kernels_forced(monkeypatch):
    """Every wrapper takes its kernel branch on CPU tensors; the launches
    of K1, K4, K9 and K10 are stood in for by their plain versions, which,
    like a kernel, return tensors with no autograd graph.  Nothing is
    built or launched.  Yields the stand-ins' call counts."""
    calls = {"layer_norm": 0, "attention_bthd": 0, "layer_norm_bwd": 0,
             "attention_bwd": 0}

    def ln_fwd(x, conv_bias, scale, bias, eps, gelu):
        assert not gelu
        calls["layer_norm"] += 1
        with torch.no_grad():
            return tln.layer_norm_plain(x, scale, bias, eps)

    def attn_fwd(q, k, v, key_mask, scale, out, name, stats=None):
        calls["attention_bthd"] += 1
        with torch.no_grad():
            if stats is not None:
                stats.copy_(tattn.attention_stats_plain(q, k, key_mask, scale))
            return out.copy_(tattn.attention_bthd_plain(q, k, v, key_mask,
                                                        scale))

    def ln_bwd(x, scale, g, eps, need_dx):
        calls["layer_norm_bwd"] += 1
        return tln.layer_norm_bwd_plain(x, scale, g, eps, need_dx)

    def attn_bwd(q, k, v, key_mask, do, scale, o, stats, out):
        calls["attention_bwd"] += 1
        calls["attention_bwd_inputs"] = (o, stats)
        for dst, src in zip(out, tattn.attention_bwd_plain(q, k, v, key_mask,
                                                           do, scale)):
            dst.copy_(src)
        return out

    def no_library():
        raise LookupError("the kernel library was asked for")

    monkeypatch.setattr(tbackend, "use_kernel", lambda x: True)
    monkeypatch.setattr(tbuild, "library", no_library)
    monkeypatch.setattr(tln, "_launch", ln_fwd)
    monkeypatch.setattr(tln, "_launch_bwd", ln_bwd)
    monkeypatch.setattr(tattn, "_launch", attn_fwd)
    monkeypatch.setattr(tattn, "_launch_bwd", attn_bwd)
    yield calls


@pytest.mark.parametrize("heads,d", [(8, 128), (2, 64)])
def test_attention_fn_hands_forward_statistics_to_backward(kernels_forced,
                                                           heads, d):
    """The bf16 kernel path of _AttentionFn (launches stood in for by the
    plain versions): the forward asks the kernel for its statistics, and
    the backward gets them and the forward's output beside the new
    attention_bwd arguments; the gradients match jax.vjp through the JAX
    _fused_bwd (_attn_bwd_kernel, interpret mode)."""
    rng = np.random.RandomState(d + 3 * heads)
    b, t = len(LENGTHS), 50
    q, k, v, do = (rng.randn(b, t, heads, d).astype(np.float32)
                   for _ in range(4))
    mask = _key_mask(LENGTHS, t)
    scale = d ** -0.5
    qkv = torch.from_numpy(np.stack([q, k, v], axis=2)).bfloat16()
    qkv.requires_grad_()
    dout = torch.from_numpy(do).bfloat16()
    out = tattn.attention_qkv(qkv, torch.from_numpy(mask), scale)
    dqkv, = torch.autograd.grad(out, qkv, dout)
    o, stats = kernels_forced["attention_bwd_inputs"]
    assert torch.equal(o, out)
    assert stats.shape == (b, heads, t, 2) and stats.dtype == torch.float32
    torch.testing.assert_close(stats, tattn.attention_stats_plain(
        *qkv.detach().unbind(2)[:2], torch.from_numpy(mask), scale))
    assert kernels_forced["attention_bthd"] == 1
    assert kernels_forced["attention_bwd"] == 1
    want = _pallas_vjp(
        lambda a, bb, c: jattn.attention_pallas_bthd(a, bb, c,
                                                     jnp.asarray(mask), scale),
        tuple(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray(do, jnp.bfloat16))
    _assert_grads_close(dqkv.unbind(2), want, "bfloat16")


def _sfc_grads(head, x, mask):
    logits = tsfc.sfc_forward(head, x, mask)
    loss = torch.where(mask, logits, 0.0).square().sum()
    return torch.autograd.grad(loss, list(head.parameters()))


def test_kernel_paths_keep_the_graph_or_refuse(kernels_forced):
    """On the kernel path a raw launch cuts the graph; layer_norm and the
    attention go through autograd Functions whose backwards are K9 and K10,
    so every SFC head parameter gets the plain path's gradient; the kernels
    without a backward refuse a grad-requiring input instead of falling
    back."""
    x, scale, bias, cbias = (torch.from_numpy(a) for a in
                             _ln_inputs((2, 5), 64, seed=3))
    scale.requires_grad_()
    assert tln._layer_norm(x, scale, bias, tln.EPS).grad_fn is None
    assert tln.layer_norm(x, scale, bias).grad_fn is not None

    head = tsfc.SegmentationFrameClassifier(d_model=64, n_layers=1,
                                            n_heads=1, ffn_dim=128)
    init_from_numpy(head, seed=4)
    hid = torch.from_numpy(np.random.RandomState(5).randn(3, 20, 64)
                           .astype(np.float32))
    mask = torch.from_numpy(_key_mask([20, 9, 0], 20))
    kernels_forced.update(dict.fromkeys(kernels_forced, 0))
    got = _sfc_grads(head, hid, mask)
    inputs = kernels_forced.pop("attention_bwd_inputs")
    assert inputs[0] is not None and inputs[1] is None  # float32: no stats
    assert kernels_forced == {"layer_norm": 3, "attention_bthd": 1,
                              "layer_norm_bwd": 3, "attention_bwd": 1}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbackend, "use_kernel", lambda x: False)
        want = _sfc_grads(head, hid, mask)
    for (name, _), g, w in zip(head.named_parameters(), got, want):
        assert g.abs().sum() > 0, name
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)

    grad_x = torch.randn(2, 5, 64, requires_grad=True)
    w1, b1 = torch.randn(128, 64), torch.zeros(128)
    w2, b2 = torch.randn(64, 128), torch.zeros(64)
    refusals = {
        "ffn": lambda: tffn.ffn(grad_x, w1, b1, w2, b2),
        "bias_layer_norm_gelu": lambda: tln.bias_layer_norm_gelu(
            grad_x, cbias, scale, bias),
        "attention_packed": lambda: tattn.attention_packed(
            torch.randn(2, 5, 192, requires_grad=True), None, 1),
        "conv_bias_ln_gelu": lambda: tconv.conv_bias_ln_gelu(
            grad_x, torch.randn(64, 64, 2), cbias, scale, bias, 2),
    }
    for name, call in refusals.items():
        with pytest.raises(RuntimeError, match="LNA fine-tuning slice"):
            call()
    with torch.no_grad(), pytest.raises(LookupError):
        tffn.ffn(grad_x, w1, b1, w2, b2)  # refused only when grad is on
