"""The port's fused ops (``ops.ffn``, ``ops.convfuse``) against the JAX
package's Pallas kernels K5-K8, run in interpret mode as the JAX package's
own tests run them, and against their XLA references.

On CPU tensors each port op runs its plain PyTorch version, which rounds
where the hand kernel rounds; ``chip_smoke.py`` holds the CUDA kernels
against these plain versions on the card.  Tolerances: float32 1e-5
(summation order only); bf16 one bf16 step of the reference value, and at
least the step at 2^-6 (the two sides round the same float32 sums
independently).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from wav2vecsegmenter_tpu.models import wav2vec2 as jw2v
from wav2vecsegmenter_tpu.ops import convfuse as jconv
from wav2vecsegmenter_tpu.ops import ffn as jffn
from wav2vecsegmenter_tpu_torch.ops import convfuse as tconv
from wav2vecsegmenter_tpu_torch.ops import ffn as tffn

F32_ATOL = 1e-5
EPS = 1e-5
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _round(a: np.ndarray, dtype) -> np.ndarray:
    """Round float32 values through ``dtype`` (both sides then see the same
    operands)."""
    return torch.from_numpy(a).to(dtype).float().numpy()


def _assert_close(got: np.ndarray, ref: np.ndarray, dtype) -> None:
    got, ref = got.astype(np.float32), ref.astype(np.float32)
    assert np.isfinite(got).all()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, atol=F32_ATOL, rtol=0)
        return
    # one bf16 step (8 significant bits) at the reference's magnitude, at
    # least the step at 2^-6: near zero the TPU kernel's erf polynomial
    # (abs error ~1e-7, ops/layernorm._erf_approx) is not exact erf
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -6))) - 7)
    bad = np.abs(got - ref) > step
    assert not bad.any(), (
        f"{bad.sum()} of {bad.size} beyond one bf16 step; max diff "
        f"{np.abs(got - ref).max()}")


# ---------------------------------------------------------------- K5: ffn

def _ffn_inputs(t: int, seed: int):
    rng = np.random.RandomState(seed)
    b, h, f = 2, 64, 256
    x = rng.randn(b, t, h).astype(np.float32)
    w1 = (rng.randn(h, f) * h ** -0.5).astype(np.float32)  # JAX [H, F]
    b1 = (rng.randn(f) * 0.1).astype(np.float32)
    w2 = (rng.randn(f, h) * f ** -0.5).astype(np.float32)
    b2 = (rng.randn(h) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("t", [37, 48])  # ragged and whole row blocks of 16
def test_ffn_matches_jax_kernel(dtype, t):
    tdt, jdt = DTYPES[dtype]
    x, w1, b1, w2, b2 = _ffn_inputs(t, seed=t)
    x, w1, w2 = (_round(a, tdt) for a in (x, w1, w2))
    # the port takes torch.nn.Linear weights: w1 [F, H], w2 [H, F]
    got = tffn.ffn(torch.from_numpy(x).to(tdt), torch.from_numpy(w1.T.copy()),
                   torch.from_numpy(b1), torch.from_numpy(w2.T.copy()),
                   torch.from_numpy(b2)).float().numpy()
    with pltpu.force_tpu_interpret_mode():
        ref = jffn._ffn_call(jnp.asarray(x, jdt), jnp.asarray(w1, jdt),
                             jnp.asarray(b1), jnp.asarray(w2, jdt),
                             jnp.asarray(b2), 16)
    _assert_close(got, np.asarray(ref.astype(jnp.float32)), tdt)
    if tdt == torch.float32:
        ref_xla = jffn.ffn_xla(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))
        _assert_close(got, np.asarray(ref_xla), tdt)


def test_ffn_flag_is_read_at_call_time(monkeypatch):
    monkeypatch.delenv("W2VSEG_FFNFUSE", raising=False)
    assert tffn.ffnfuse_enabled()
    monkeypatch.setenv("W2VSEG_FFNFUSE", "0")
    assert not tffn.ffnfuse_enabled()


# ------------------------------------------------------ K6/K7/K8: conv

# (kernel, k, s, c_in, t_in): layers 1-4 (two stride-folded taps, K6 and
# K8), layers 5-6 (one tap, K7) and the raw-audio layer 0 (K7, k*c = 10)
CONV_CASES = {
    "2tap_wide": (3, 2, 64, 93),
    "2tap_narrow": (3, 2, 64, 93),
    "1tap": (2, 2, 64, 90),
    "audio": (10, 5, 1, 400),
}


def _conv_inputs(k, s, c, t, seed):
    rng = np.random.RandomState(seed)
    o = 128
    x = rng.randn(2, t, c).astype(np.float32)
    w = (rng.randn(o, c, k) * (c * k) ** -0.5).astype(np.float32)  # torch
    cb = (rng.randn(o) * 0.3).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(o)).astype(np.float32)
    bias = (0.1 * rng.randn(o)).astype(np.float32)
    return x, w, cb, scale, bias


def _jax_conv(case, x, w, cb, scale, bias, jdt):
    """The JAX package's fused layer: its fold, tap weights and dispatch
    (models/wav2vec2.feature_extractor), the Pallas kernel in interpret
    mode, blocks of 16 rows (ragged here)."""
    k, s, _, t = CONV_CASES[case]
    t_out = (t - k) // s + 1
    wj = jnp.asarray(np.transpose(w, (2, 1, 0)))  # [k, C, O]
    y = jw2v._fold_for_taps(jnp.asarray(x), k, s, t_out, jdt)
    if case == "audio":
        n_taps = -(-k // s)
        y = jnp.concatenate([y[:, p:p + t_out] for p in range(n_taps)],
                            axis=-1)
        w_taps = wj.reshape(-1, wj.shape[-1])[None]
    else:
        w_taps = jw2v._tap_weights(wj, s)
    args = (y, w_taps.astype(jdt), jnp.asarray(cb), jnp.asarray(scale),
            jnp.asarray(bias))
    with pltpu.force_tpu_interpret_mode():
        ref = jconv._fused(*args, EPS, t_out, 16)
    return (np.asarray(ref.astype(jnp.float32)),
            np.asarray(jconv._xla_ref(*args, EPS, t_out).astype(jnp.float32)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv_bias_ln_gelu_matches_jax_kernel(monkeypatch, case, dtype):
    """K6 (``_kernel_2tap_wide``), K8 (``_kernel_2tap``: the module constant
    ``_CONVWIDE`` is captured at import, so it is patched, not the
    environment) and K7 (``_kernel_1tap``) on the unfolded [B, T, C] input
    and torch-layout weights."""
    tdt, jdt = DTYPES[dtype]
    monkeypatch.setattr(jconv, "_CONVWIDE", case != "2tap_narrow")
    k, s, c, t = CONV_CASES[case]
    x, w, cb, scale, bias = _conv_inputs(k, s, c, t, seed=k * 100 + c)
    x, w = _round(x, tdt), _round(w, tdt)
    got = tconv.conv_bias_ln_gelu(
        torch.from_numpy(x).to(tdt), torch.from_numpy(w), torch.from_numpy(cb),
        torch.from_numpy(scale), torch.from_numpy(bias), s, EPS)
    assert got.dtype == tdt and got.shape == (2, (t - k) // s + 1, 128)
    ref, ref_xla = _jax_conv(case, x, w, cb, scale, bias, jdt)
    _assert_close(got.float().numpy(), ref, tdt)
    if tdt == torch.float32:  # _xla_ref rounds its product only in bf16
        _assert_close(got.numpy(), ref_xla, tdt)


def test_conv_flag_is_read_at_call_time(monkeypatch):
    monkeypatch.delenv("W2VSEG_CONVFUSE", raising=False)
    assert tconv.convfuse_enabled()
    monkeypatch.setenv("W2VSEG_CONVFUSE", "0")
    assert not tconv.convfuse_enabled()


def test_conv_plain_matches_torch_conv1d():
    """The overlapping-view GEMM is conv1d (float32, every kernel case)."""
    for case, (k, s, c, t) in CONV_CASES.items():
        x, w, cb, scale, bias = _conv_inputs(k, s, c, t, seed=3)
        xt = torch.from_numpy(x)
        conv = torch.nn.functional.conv1d(xt.transpose(1, 2),
                                           torch.from_numpy(w), stride=s)
        y = torch.nn.functional.layer_norm(
            conv.transpose(1, 2) + torch.from_numpy(cb), (128,),
            torch.from_numpy(scale), torch.from_numpy(bias), EPS)
        want = torch.nn.functional.gelu(y)
        got = tconv.conv_bias_ln_gelu_plain(
            xt, torch.from_numpy(w), torch.from_numpy(cb),
            torch.from_numpy(scale), torch.from_numpy(bias), s, EPS)
        torch.testing.assert_close(got, want, atol=F32_ATOL, rtol=0,
                                   msg=case)
