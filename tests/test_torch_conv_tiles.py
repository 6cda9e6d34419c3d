"""The tile schedules of the bf16 conv kernels, emulated on the CPU.

The kernels of ``ops/csrc/convfuse.cu`` run only on the card.  This file
writes their schedules out in torch, with the tile sizes and configuration
read from the source, and holds them against the port's plain version and
the JAX package's Pallas kernel (interpret mode), at 512 channels, B = 2,
t_in odd and row tiles ragged in every batch element:

* ``conv_wg_kernel`` (conv layers 1-6, K6/K8 and K7's layers 5-6): row
  tiles of 128 rows a batch element, walked in the cluster's order; each
  K step of 64 reads the 64-row boxes of A that hold rows by TMA, from
  map A0 (rows of s*C elements at stride s*C: taps [0, s)) or map A1 (at
  x + s*C, rows of (k-s)*C: taps [s, k)), rows past t_out zero-filled (a
  second half wholly past t_out is not loaded: its rows are never
  stored), and the weight's box of the CTA's 256 channels; float32 sums in K order; each CTA's per-thread
  partial sums (channels 8i + 2q + e of its half, i then e), the quad's
  two shuffles, the pair's two partials added; the mean, the deviations in
  place, the squared deviations the same way; one bf16 rounding.
* ``conv_audio_tc_kernel`` (layer 0): row tiles of 16 * STRIPS rows, each
  reading one span of (rows - 1)*s*C + k*C samples of its batch element,
  zeros past its end; the taps (K padded to 16) on top of the conv bias;
  four warps of 128 channels a row merge their partials in channel order.

Every box and span is checked against its map's extent and x's storage,
also at the main path's full shapes (without the arithmetic).
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

SRC = (Path(tconv.__file__).resolve().parent / "csrc" / "convfuse.cu"
       ).read_text()
EPS = 1e-5
# the limit chip_smoke.py holds the conv kernels to against the plain
# version: one bf16 step at |y| in [4, 8) (independent bf16 roundings of
# float32 values that differ in summation order), no relative part
BF16_ATOL = 2 ** -5
BF16_RTOL = 0.0


def _int(pattern: str) -> int:
    return int(re.search(pattern, SRC).group(1))


def wg_config() -> dict:
    """conv_wg_kernel's tile sizes and configuration, from the source."""
    stages, cm, mc = re.search(
        r"using ConvWgCfg = ConvWg<(\d+), (\d+), (true|false)>;",
        SRC).groups()
    return {"stages": int(stages), "cm": int(cm), "mc": mc == "true",
            "rows": _int(r"static constexpr int kRows = (\d+);"),
            "bk": _int(r"static constexpr int kBK = (\d+);"),
            "halves": _int(r"static constexpr int kCols = kConvN / (\d+);"),
            "n": _int(r"constexpr int kConvN = (\d+);")}


def audio_config() -> dict:
    """conv_audio_tc_kernel's tile rows and K bound, from the source."""
    strips = _int(r"using AudioTcCfg = AudioTc<(\d+)>;")
    return {"rows": _int(r"static constexpr int kRows = (\d+) \* STRIPS;")
            * strips,
            "max_k": _int(r"constexpr int kAudioMaxK = (\d+);"),
            "quarters": 4}


CFG = wg_config()
AUDIO = audio_config()


def test_config_is_read():
    """The shapes the emulations below assume: 128-row tiles, a pair
    splitting 512 channels, 64-deep K steps, 64-row audio tiles."""
    assert (CFG["rows"], CFG["halves"], CFG["bk"], CFG["n"]) == (128, 2, 64,
                                                                 512)
    assert CFG["cm"] in (1, 2) and CFG["stages"] >= 2
    assert AUDIO["rows"] % 16 == 0 and AUDIO["max_k"] == 16


# ------------------------------------------------------- the tensor maps

class Map:
    """A 3-D TMA map over a flat tensor: element (c0, c1, c2) at
    base + c2 * s2 + c1 * s1 + c0 (elements), inside iff c_i < dims[i]."""

    def __init__(self, base, dims, s1, s2, size):
        self.base, self.dims, self.s1, self.s2 = base, dims, s1, s2
        self.size = size  # elements of the tensor's storage

    def box(self, flat: torch.Tensor, c0: int, c1: int, c2: int,
            rows: int, cols: int) -> torch.Tensor:
        """The [rows, cols] box at (c0, c1, c2), zeros outside the dims
        (the rows past t_out of a ragged tile).  Asserts that the box
        starts inside the map, that its columns do not clip (K steps are
        whole) and that every element it reads lies inside the storage."""
        d0, d1, d2 = self.dims
        assert 0 <= c0 and c0 + cols <= d0, (c0, cols, d0)
        assert 0 <= c1 < d1 and 0 <= c2 < d2, (c1, c2, self.dims)
        r = torch.arange(c1, c1 + rows)
        i = torch.arange(c0, c0 + cols)
        inside = (r < d1)[:, None] & (i < d0)[None, :]
        idx = self.base + c2 * self.s2 + r[:, None] * self.s1 + i[None, :]
        assert int(idx[inside].min()) >= 0
        assert int(idx[inside].max()) < self.size
        out = torch.zeros(rows, cols)
        out[inside] = flat[idx[inside]]
        return out


def a_maps(b, t_in, c, k, s, t_out):
    """Maps A0 (taps [0, min(k, s))) and A1 (taps [s, k), k > s) over x
    [b, t_in, c], as launch_conv_wg encodes them."""
    taps0 = min(k, s)
    size = b * t_in * c
    a0 = Map(0, (taps0 * c, t_out, b), s * c, t_in * c, size)
    a1 = Map(s * c, ((k - s) * c, t_out, b), s * c, t_in * c,
             size) if k > s else None
    return a0, a1, taps0 * c // CFG["bk"], k * c // CFG["bk"]


def tiles(b, t_out, rows, cm=1):
    """(cluster tile, row group, batch element, first row) in the order
    the clusters walk them; row groups past the end are skipped (they read
    zeros and store nothing)."""
    per_b = -(-t_out // rows)
    n = b * per_b
    for ct in range(-(-n // cm)):
        for group in range(cm):
            tile = ct * cm + group
            if tile < n:
                yield ct, group, tile // per_b, (tile % per_b) * rows


# --------------------------------------------------- conv_wg_kernel (bf16)

def thread_partials(v: torch.Tensor) -> torch.Tensor:
    """[R, 256] float32 -> [R] partial sums of one CTA's channels in the
    kernel's order: a thread (quad lane q) adds its channels 8i + 2q + e,
    i then e; the quad adds (q, q^1), then (q, q^2)."""
    w = v.reshape(v.shape[0], 32, 4, 2)
    s = torch.zeros(v.shape[0], 4)
    for i in range(32):
        for e in range(2):
            s = s + w[:, i, :, e]
    s = s + s[:, [1, 0, 3, 2]]
    s = s + s[:, [2, 3, 0, 1]]
    return s[:, 0]


def gelu(y: torch.Tensor) -> torch.Tensor:
    return 0.5 * y * (1.0 + torch.erf(y * 0.70710678118654752))


def emulate_wg(x, w, cb, scale, bias, s, eps=EPS):
    """conv_wg_kernel's schedule -> [B, t_out, 512] bf16."""
    b, t_in, c = x.shape
    o, _, k = w.shape
    t_out = (t_in - k) // s + 1
    rows, bk, half = CFG["rows"], CFG["bk"], CFG["n"] // CFG["halves"]
    flat = x.float().reshape(-1)
    wk = tconv._gemm_weight(w, x.dtype).float()  # [512, k*C]
    wmap = Map(0, (k * c, o, 1), k * c, k * c * o, o * k * c)
    wflat = wk.reshape(-1)
    a0, a1, k0_tiles, k_tiles = a_maps(b, t_in, c, k, s, t_out)
    out = torch.zeros(b, t_out, o, dtype=x.dtype)
    for _, _, bi, r0 in tiles(b, t_out, rows, CFG["cm"]):
        acc = torch.zeros(rows, o)
        for kt in range(k_tiles):
            amap, c0 = (a0, kt * bk) if kt < k0_tiles else (
                a1, (kt - k0_tiles) * bk)
            a = torch.cat([amap.box(flat, c0, r0 + 64 * j, bi, 64, bk)
                           if r0 + 64 * j < t_out else torch.zeros(64, bk)
                           for j in range(2)])
            wt = torch.cat([wmap.box(wflat, kt * bk, h * half, 0, half, bk)
                            for h in range(CFG["halves"])])
            acc = acc + a @ wt.t()
        v = acc + cb
        halves = [v[:, h * half:(h + 1) * half] for h in range(2)]
        mean = (thread_partials(halves[0]) + thread_partials(halves[1])) \
            / o
        d = [hv - mean[:, None] for hv in halves]
        var = (thread_partials(d[0] * d[0]) + thread_partials(d[1] * d[1])) \
            / o
        rstd = torch.rsqrt(var + eps)
        y = gelu(torch.cat(d, 1) * rstd[:, None] * scale + bias)
        n = min(rows, t_out - r0)
        out[bi, r0:r0 + n] = y[:n].to(x.dtype)
    return out


def jax_conv(x, w, cb, scale, bias, s):
    """The JAX package's fused layer (its fold, tap weights and dispatch,
    models/wav2vec2.feature_extractor), the Pallas kernel in interpret
    mode, blocks of 16 rows."""
    b, t, c = x.shape
    k = w.shape[2]
    t_out = (t - k) // s + 1
    xj = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    wj = jnp.asarray(np.transpose(w.float().numpy(), (2, 1, 0)))  # [k, C, O]
    y = jw2v._fold_for_taps(xj, k, s, t_out, jnp.bfloat16)
    if c * s <= 64:  # the raw-audio layer: taps concatenated, one dot
        n_taps = -(-k // s)
        y = jnp.concatenate([y[:, p:p + t_out] for p in range(n_taps)],
                            axis=-1)
        w_taps = wj.reshape(-1, wj.shape[-1])[None]
    else:
        w_taps = jw2v._tap_weights(wj, s)
    with pltpu.force_tpu_interpret_mode():
        ref = jconv._fused(y, w_taps.astype(jnp.bfloat16),
                           *(jnp.asarray(a.numpy()) for a in (cb, scale,
                                                               bias)),
                           EPS, t_out, 16)
    return torch.from_numpy(np.array(ref.astype(jnp.float32)))


def inputs(b, t, c, k, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, t, c).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rng.randn(512, c, k) * (c * k) ** -0.5).astype(
        np.float32)).bfloat16().float()
    cb = torch.from_numpy((rng.randn(512) * 0.3).astype(np.float32))
    scale = torch.from_numpy((1 + 0.1 * rng.randn(512)).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.randn(512)).astype(np.float32))
    return x, w, cb, scale, bias


def assert_close(got: torch.Tensor, want: torch.Tensor) -> None:
    diff = (got.float() - want.float()).abs()
    lim = BF16_ATOL + BF16_RTOL * want.float().abs()
    assert bool((diff <= lim).all()), f"max abs err {diff.max().item()}"


# (k, s, t_in): t_in odd, t_out = 165 and 130 rows, ragged against the
# 128-row tiles in both batch elements; "narrow" runs the JAX package's K8
# (``_kernel_2tap``) instead of K6 (``_kernel_2tap_wide``)
WG_CASES = {"k3s2": (3, 2, 331), "k3s2_narrow": (3, 2, 331),
            "k2s2": (2, 2, 261)}


@pytest.mark.parametrize("case", list(WG_CASES))
def test_conv_wg_schedule(monkeypatch, case):
    monkeypatch.setattr(jconv, "_CONVWIDE", case != "k3s2_narrow")
    k, s, t = WG_CASES[case]
    x, w, cb, scale, bias = inputs(2, t, 512, k, seed=k * 10 + t)
    got = emulate_wg(x, w, cb, scale, bias, s)
    assert got.shape == (2, (t - k) // s + 1, 512)
    assert_close(got, tconv.conv_bias_ln_gelu_plain(x, w, cb, scale, bias,
                                                    s))
    assert_close(got, jax_conv(x, w, cb, scale, bias, s))


# ------------------------------------------- conv_audio_tc_kernel (bf16)

def spans(b, t_in, c, k, s, t_out):
    """(batch element, first row, span indices into x's flat storage,
    their validity) of each tile, as the kernel's fetch reads them."""
    rows = AUDIO["rows"]
    span = (rows - 1) * s * c + k * c
    len_b = t_in * c
    for bi in range(b):
        for r0 in range(0, t_out, rows):
            e = torch.arange(span)
            ok = r0 * s * c + e < len_b
            idx = bi * len_b + r0 * s * c + e
            assert int(idx[ok].max()) < (bi + 1) * len_b  # inside x[bi]
            yield bi, r0, idx, ok


def quarter_partials(v: torch.Tensor) -> torch.Tensor:
    """[R, 512] -> [R]: each warp's 128 channels (8 nt + 2q + e, nt then e;
    the quad's two shuffles), the four warps' partials added in channel
    order."""
    w = v.reshape(v.shape[0], 4, 16, 4, 2)
    s = torch.zeros(v.shape[0], 4, 4)
    for nt in range(16):
        for e in range(2):
            s = s + w[:, :, nt, :, e]
    s = s + s[:, :, [1, 0, 3, 2]]
    s = s + s[:, :, [2, 3, 0, 1]]
    p = s[:, :, 0]
    return ((p[:, 0] + p[:, 1]) + p[:, 2]) + p[:, 3]


def emulate_audio(x, w, cb, scale, bias, s, eps=EPS):
    """conv_audio_tc_kernel's schedule -> [B, t_out, 512] bf16."""
    b, t_in, c = x.shape
    o, _, k = w.shape
    kdim, t_out, rows = k * c, (t_in - k) // s + 1, AUDIO["rows"]
    assert kdim <= AUDIO["max_k"]
    flat = x.float().reshape(-1)
    wk = torch.zeros(o, AUDIO["max_k"])  # K padded to 16 with zeros
    wk[:, :kdim] = tconv._gemm_weight(w, x.dtype).float()
    out = torch.zeros(b, t_out, o, dtype=x.dtype)
    r = torch.arange(rows)[:, None] * s * c
    kk = torch.arange(AUDIO["max_k"])[None, :]
    for bi, r0, idx, ok in spans(b, t_in, c, k, s, t_out):
        sp = torch.zeros(idx.numel())
        sp[ok] = flat[idx[ok]]
        a = torch.where(kk < kdim, sp[(r + kk).clamp(max=idx.numel() - 1)],
                        torch.zeros(()))
        v = cb + a @ wk.t()  # the bias is the accumulator's start
        mean = quarter_partials(v) / o
        d = v - mean[:, None]
        rstd = torch.rsqrt(quarter_partials(d * d) / o + eps)
        y = gelu(d * rstd[:, None] * scale + bias)
        n = min(rows, t_out - r0)
        out[bi, r0:r0 + n] = y[:n].to(x.dtype)
    return out


def test_conv_audio_schedule():
    """Layer 0 (k=10, s=5, one channel): t_out = 199, ragged against the
    64-row tiles; the last tile's span reaches past t_in (zeros)."""
    x, w, cb, scale, bias = inputs(2, 1000, 1, 10, seed=5)
    got = emulate_audio(x, w, cb, scale, bias, 5)
    assert got.shape == (2, 199, 512)
    assert_close(got, tconv.conv_bias_ln_gelu_plain(x, w, cb, scale, bias,
                                                    5))
    assert_close(got, jax_conv(x, w, cb, scale, bias, 5))


# --------------------------------- the main path's shapes: bounds only

# conv layers of a 14 x 20 s batch: (t_in, c, k, s)
LAYERS = {1: (63999, 512, 3, 2), 2: (31999, 512, 3, 2),
          3: (15999, 512, 3, 2), 4: (7999, 512, 3, 2),
          5: (3999, 512, 2, 2), 6: (1999, 512, 2, 2)}


@pytest.mark.parametrize("layer", list(LAYERS))
def test_boxes_stay_inside_x(layer):
    """Every A box the kernel loads, at every K step of every tile of a
    batch of 14, starts inside its map, and every element a map addresses
    lies inside x; one map of s*C-wide rows over t_out + 1 rows (the fold
    without the second map) would read past x's end when t_in is odd."""
    t_in, c, k, s = LAYERS[layer]
    b, bk, rows = 14, CFG["bk"], CFG["rows"]
    t_out = (t_in - k) // s + 1
    a0, a1, k0_tiles, k_tiles = a_maps(b, t_in, c, k, s, t_out)
    # the row starts of the 64-row halves loaded (those that hold rows)
    starts = np.array([r0 + 64 * j for _, _, _, r0 in tiles(1, t_out, rows)
                       for j in range(2) if r0 + 64 * j < t_out])
    for kt in range(k_tiles):
        amap, c0 = (a0, kt * bk) if kt < k0_tiles else (a1,
                                                         (kt - k0_tiles) * bk)
        d0, d1, d2 = amap.dims
        # K steps never clip; every loaded box starts inside the map
        assert c0 + bk <= d0 and starts.max() < d1 == t_out and d2 == b
        # the map's last element (last batch element, row, column) lies
        # inside x, and so does every element it addresses
        last = amap.base + (d2 - 1) * amap.s2 + (d1 - 1) * amap.s1 + d0 - 1
        assert amap.base >= 0 and last < amap.size
    if k > s:  # rows 0 .. t_out of the fold, s*C wide, in the last element
        one_map_end = (b - 1) * t_in * c + (t_out + 1) * s * c
        assert (one_map_end > b * t_in * c) == (t_in % 2 == 1)


def test_audio_spans_stay_inside_x():
    """Layer 0 at a batch of 14: every span element the fetch reads lies
    inside its batch element (the rest are zeros)."""
    t_in, k, s = 320000, 10, 5
    t_out = (t_in - k) // s + 1
    n = sum(1 for _ in spans(14, t_in, 1, k, s, t_out))
    assert n == 14 * -(-t_out // AUDIO["rows"])
