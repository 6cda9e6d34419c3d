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

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from wav2vecsegmenter_tpu.ops import attention as jattn
from wav2vecsegmenter_tpu.ops import layernorm as jln
from wav2vecsegmenter_tpu.ops.backend import set_backend
from wav2vecsegmenter_tpu_torch.ops import attention as tattn
from wav2vecsegmenter_tpu_torch.ops import backend as tbackend
from wav2vecsegmenter_tpu_torch.ops import layernorm as tln

LN_ATOL = 1e-5     # float32 statistics, different summation orders
ATTN_ATOL = 2e-5   # float32 softmax over <= 64 keys, different orders


def _pallas(fn):
    set_backend("pallas")
    try:
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(fn())
    finally:
        set_backend("auto")


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
