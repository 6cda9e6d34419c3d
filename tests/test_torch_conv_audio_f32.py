"""The schedule of the float32 raw-audio conv kernel, emulated on the CPU.

``conv_audio_f32_kernel`` (``ops/csrc/convfuse.cu``: conv layer 0, k=10,
s=5, one input channel, in float32) runs only on the card.  This file
writes its schedule out in torch float32, with the configuration read from
the source (``using AudioF32Cfg = AudioF32<ROWS, WARPS>``, the rows a
warp's group holds, the rows a tile), and holds it against the port's
plain version and the JAX package's Pallas kernel (interpret mode), at
B = 2 and ragged row tiles:

* the persistent walk: CTA c takes tiles c, c + G, ... of (batch element,
  16 * WARPS rows); each tile reads one span of (rows - 1)*s*C + k*C
  samples of its batch element, zeros past the element's end;
* within a tile, group q of warp w holds rows (q * WARPS + w) * group;
* the taps in the kernel's order onto the conv bias: scalar FMAs tap by
  tap;
* the per-lane partial sums and the warp's shuffle order: a lane holds
  channels 4 lane + 128 p + e and sums them in that order, then the warp's
  butterfly xor 16, 8, 4, 2, 1; the mean, the squared deviations the same
  way; one rounding (float32: none) at the store.

The refusal tests hold the wrapper's limit on the row step s*C (16 in
float32, 64 in bf16): a wider step raises before any launch.  The bounds
test walks the main path's shapes (a 14 x 20 s batch and the
22 s tail bucket) without the arithmetic: every sample a fetch reads lies
inside its batch element, and every output row is stored exactly once.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wav2vecsegmenter_tpu.models import wav2vec2 as jw2v
from wav2vecsegmenter_tpu.ops import convfuse as jconv
from wav2vecsegmenter_tpu_torch.ops import convfuse as tconv

from .torch_tiny import threads_per_worker  # noqa: F401

SRC = (Path(tconv.__file__).resolve().parent / "csrc" / "convfuse.cu"
       ).read_text()
EPS = 1e-5
# float32 against float32: sums in other orders, CUDA's rsqrtf against
# torch's
F32_ATOL = 1e-5


def _int(pattern: str) -> int:
    return int(re.search(pattern, SRC).group(1))


def f32_config() -> dict:
    """The kernel's configuration, from the source."""
    rows, warps = re.search(
        r"using AudioF32Cfg = AudioF32<(\d+), (\d+)>;", SRC).groups()
    return {"warps": int(warps), "group": int(rows),
            "tile": _int(r"kTile = (\d+) \* WARPS;") * int(warps),
            "max_k": _int(r"constexpr int kAudioMaxK = (\d+);"),
            "max_step": _int(r"constexpr int kAudioF32MaxStep = (\d+);"),
            "n": _int(r"constexpr int kConvN = (\d+);")}


CFG = f32_config()


def test_config_is_read():
    """The shapes the emulation assumes: 512 channels, K up to 16, whole
    groups a warp's 16 rows, and the wrapper's float32 step limit the
    kernel's."""
    assert CFG["n"] == 512 and CFG["max_k"] == tconv.AUDIO_MAX_K == 16
    assert CFG["max_step"] == tconv.AUDIO_MAX_STEP[torch.float32] >= 5
    assert CFG["tile"] == 16 * CFG["warps"] and 16 % CFG["group"] == 0


# ------------------------------------------------------------- the walk

def walk(b, t_in, c, k, s, t_out, tile, grid):
    """(batch element, first row, span's flat indices into x, validity) of
    each tile in the order CTA 0, 1, ... of a persistent grid walk them."""
    per_b = -(-t_out // tile)
    n_tiles = b * per_b
    len_b = t_in * c
    span = (tile - 1) * s * c + k * c
    for cta in range(min(grid, n_tiles)):
        for t in range(cta, n_tiles, grid):
            bi, r0 = t // per_b, (t % per_b) * tile
            e = np.arange(span)
            ok = r0 * s * c + e < len_b
            yield bi, r0, bi * len_b + r0 * s * c + e, ok


def groups(warps, group):
    """The first row within the tile of each group, in the order the warps
    take them (group q of warp w: rows (q * warps + w) * group)."""
    for q in range(16 // group):
        for w in range(warps):
            yield (q * warps + w) * group


# ------------------------------------------------------- the arithmetic

def taps_simt(a, wk, cb):
    """[R, K] samples, [512, K] weight -> [R, 512]: onto the conv bias, tap
    by tap."""
    v = cb.expand(a.shape[0], -1).clone()
    for j in range(a.shape[1]):
        v = v + a[:, j:j + 1] * wk[:, j]
    return v


def butterfly(p: torch.Tensor, steps) -> torch.Tensor:
    """[R, L] lane partials -> [R, L] after shuffles xor each of
    ``steps`` (as lane-index masks)."""
    lanes = torch.arange(p.shape[1])
    for o in steps:
        p = p + p[:, lanes ^ o]
    return p


def row_sums_simt(v: torch.Tensor) -> torch.Tensor:
    """[R, 512] -> [R]: lane L's channels 4 L + 128 p + e in (p, e) order,
    then xor 16, 8, 4, 2, 1."""
    w = v.reshape(v.shape[0], 4, 32, 4)  # [R, p, lane, e]
    s = torch.zeros(v.shape[0], 32)
    for p in range(4):
        for e in range(4):
            s = s + w[:, p, :, e]
    return butterfly(s, (16, 8, 4, 2, 1))[:, 0]


def gelu(y: torch.Tensor) -> torch.Tensor:
    return 0.5 * y * (1.0 + torch.erf(y * 0.70710678118654752))


def emulate(x, w, cb, scale, bias, s, cfg=CFG, grid=3, eps=EPS):
    """conv_audio_f32_kernel's schedule -> [B, t_out, 512] float32."""
    b, t_in, c = x.shape
    o, _, k = w.shape
    kdim, step = k * c, s * c
    t_out = (t_in - k) // s + 1
    assert kdim <= cfg["max_k"] and step <= cfg["max_step"]
    tile, group = cfg["tile"], cfg["group"]
    flat = x.reshape(-1)
    wk = tconv._gemm_weight(w, torch.float32)  # [512, k*C]
    out = torch.zeros(b, t_out, o)
    stored = torch.zeros(b, t_out, dtype=torch.int64)
    for bi, r0, idx, ok in walk(b, t_in, c, k, s, t_out, tile, grid):
        sp = torch.zeros(len(idx))
        sp[ok] = flat[idx[ok]]
        for rg in groups(cfg["warps"], group):
            valid = t_out - r0 - rg
            if valid <= 0:
                continue  # this warp's remaining groups
            rows = torch.arange(group)[:, None] * step
            a = sp[rg * step + rows + torch.arange(kdim)[None, :]]
            v = taps_simt(a, wk, cb)
            mean = row_sums_simt(v) / o
            d = v - mean[:, None]
            rstd = torch.rsqrt(row_sums_simt(d * d) / o + eps)
            y = gelu(d * rstd[:, None] * scale + bias)
            n = min(group, valid)
            out[bi, r0 + rg:r0 + rg + n] = y[:n]
            stored[bi, r0 + rg:r0 + rg + n] += 1
    assert bool((stored == 1).all())
    return out


# ------------------------------------------------------------ the checks

def inputs(b, t, c, k, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, t, c).astype(np.float32))
    w = torch.from_numpy((rng.randn(512, c, k) * (c * k) ** -0.5).astype(
        np.float32))
    cb = torch.from_numpy((rng.randn(512) * 0.3).astype(np.float32))
    scale = torch.from_numpy((1 + 0.1 * rng.randn(512)).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.randn(512)).astype(np.float32))
    return x, w, cb, scale, bias


def jax_conv_f32(x, w, cb, scale, bias, s):
    """The JAX package's fused raw-audio layer in float32 (its fold, taps
    concatenated into one dot, as models/wav2vec2.feature_extractor does
    where s*C <= 64; k a multiple of s), the Pallas kernel in interpret
    mode, blocks of 16 rows."""
    b, t, c = x.shape
    k = w.shape[2]
    t_out = (t - k) // s + 1
    xj = jnp.asarray(x.numpy())
    wj = jnp.asarray(np.transpose(w.numpy(), (2, 1, 0)))  # [k, C, O]
    y = jw2v._fold_for_taps(xj, k, s, t_out, jnp.float32)
    n_taps = -(-k // s)
    y = jnp.concatenate([y[:, p:p + t_out] for p in range(n_taps)], axis=-1)
    w_taps = wj.reshape(-1, wj.shape[-1])[None]
    with pltpu.force_tpu_interpret_mode():
        ref = jconv._fused(y, w_taps, *(jnp.asarray(a.numpy()) for a in (
            cb, scale, bias)), EPS, t_out, 16)
    return torch.from_numpy(np.array(ref))


def assert_close(got, want):
    err = (got - want).abs().max().item()
    assert err <= F32_ATOL, f"max abs err {err}"


# (t_in, k, s, c): layer 0 with t_out = 199 (one ragged tile an element)
# and 599 (two whole tiles of 256 rows and a ragged third, or more tiles
# at fewer warps); a two-channel narrow product (k*C = 8, s*C = 4); the
# widest product and step the float32 kernel takes (k*C = s*C = 16)
CASES = {"t199": (1000, 10, 5, 1), "t599": (3000, 10, 5, 1),
         "c2": (999, 4, 2, 2), "widest": (1000, 8, 8, 2)}


@pytest.mark.parametrize("case", list(CASES))
def test_conv_audio_f32_schedule(case):
    t, k, s, c = CASES[case]
    x, w, cb, scale, bias = inputs(2, t, c, k, seed=t + k)
    got = emulate(x, w, cb, scale, bias, s)
    assert got.shape == (2, (t - k) // s + 1, 512)
    assert_close(got, tconv.conv_bias_ln_gelu_plain(x, w, cb, scale, bias,
                                                    s))
    assert_close(got, jax_conv_f32(x, w, cb, scale, bias, s))


# a 20 s window and the 22 s tail bucket, in samples
BATCHES = {"20s": 320000, "22s": 352000}


@pytest.mark.parametrize("bucket", list(BATCHES))
def test_conv_audio_f32_bounds(bucket):
    """A batch of 14 at the main path's layer 0 (k=10, s=5, C=1), on a
    persistent grid of 132 CTAs: every span element a fetch copies lies in
    its batch element (the rest are zeros), every sample a stored row
    reads is a copied one, each span fits its buffer, and every output
    row is stored exactly once."""
    t_in, k, s, c, b = BATCHES[bucket], 10, 5, 1, 14
    t_out = (t_in - k) // s + 1
    tile, group = CFG["tile"], CFG["group"]
    assert (tile - 1) * s * c + k * c <= (tile - 1) * CFG["max_step"] \
        + CFG["max_k"]
    stored = np.zeros(b * t_out, dtype=np.int64)
    for bi, r0, idx, ok in walk(b, t_in, c, k, s, t_out, tile, 132):
        assert int(idx[ok].min()) >= bi * t_in * c
        assert int(idx[ok].max()) < (bi + 1) * t_in * c
        for rg in groups(CFG["warps"], group):
            n = min(group, t_out - r0 - rg)
            if n <= 0:
                continue
            # the last sample of the group's last stored row
            assert ok[(rg + n - 1) * s * c + k * c - 1]
            stored[bi * t_out + r0 + rg + np.arange(n)] += 1
    assert bool((stored == 1).all())


# (dtype, k, s, C): a narrow product (k*C <= 16) one step past the limit
WIDE_STEPS = {"float32": (torch.float32, 10, 17, 1),
              "bfloat16": (torch.bfloat16, 10, 65, 1)}


@pytest.mark.parametrize("dtype", list(WIDE_STEPS))
def test_conv_audio_wide_step_refused(dtype):
    """The wrapper refuses a row step s*C beyond the narrow kernel's limit
    for the dtype, with a ValueError, before it builds or launches."""
    dt, k, s, c = WIDE_STEPS[dtype]
    x, w, cb, scale, bias = inputs(1, 200, c, k, seed=k)
    assert k * c <= tconv.AUDIO_MAX_K < s * c
    assert s * c == tconv.AUDIO_MAX_STEP[dt] + 1
    with pytest.raises(ValueError, match="row step"):
        tconv._launch(x.to(dt), w, cb, scale, bias, s, EPS)
