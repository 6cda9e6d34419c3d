"""The schedule of the float32 FFN and conv kernels (split TF32), emulated
on the CPU.

The float32 routes of ``ops/csrc/ffn.cu`` (``ffn_tf32_kernel``, K5: two
products) and ``ops/csrc/convfuse.cu`` (``conv_tf32_kernel``, K6: conv
layers 1-6) run the mainloop ``Tf32Gemm`` of ``ops/csrc/gemm.cuh`` on the
card's tensor cores (``wgmma`` in TF32).  This file writes their
arithmetic out in torch, with the partial length, tiles, stages and
cluster read from the ``kF32Gemm*`` constants of the sources:

* the split: each A element split in registers and each weight element
  split once a call into hi = x rounded to TF32 and lo = x - hi rounded
  the same way (``tf32_round`` and ``split`` of
  ``test_torch_attention_tiles_f32``); each product taken as
  lo_a hi_b + hi_a lo_b + hi_a hi_b over every k8 step, in that order,
  into a partial begun from zero; partials of ``kF32GemmSteps`` k-steps
  added to the running sums in k order;
* the ragged last row tile: rows past the end read as zeros and are not
  stored (tiles of ``kF32GemmRows`` rows over all the GEMM rows; K6's run
  across batch elements, the A operand the input read in place as an
  overlapping strided view);
* K5: bias and exact-erf GELU on the first product's float32 sums (the
  activation stays float32), bias on the second;
* K6: the conv bias, then the LayerNorm statistics in the kernel's order:
  each thread's two columns of each of its CTA's sixteen 8-channel blocks
  (channels 8j + 2t, + 1 of the CTA's 128: a warp holds its rows' 128),
  the quad's two shuffles, the cluster's CTAs in rank order; the mean, the
  deviations in place, their squares the same way, 1/std, scale, bias, the
  exact-erf GELU.

Each emulation is held against the JAX package in float32, from numpy
inputs: K5 against ``ffn_xla`` at full width (1024 x 4096 and 768 x 3072)
on 2 x 37 rows; K6 against ``_xla_ref`` and the Pallas kernel in
interpret mode at conv layer 1's and layer 5's geometry, B = 2, t_in odd
and the row tiles ragged.  The limit is chip_smoke.F32_ATOL (1e-4), the
one the card holds the float32 kernels to against their plain versions:
summation order and the split-TF32 products (three TF32 products a
product, ~2^-22 of it) differ from a float32 GEMM by far less.
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
from wav2vecsegmenter_tpu.ops import ffn as jffn
from wav2vecsegmenter_tpu_torch.ops import convfuse as tconv
from wav2vecsegmenter_tpu_torch.ops import ffn as tffn

from .test_torch_attention_tiles_f32 import split
from .torch_tiny import threads_per_worker  # noqa: F401

CSRC = Path(tffn.__file__).resolve().parent / "csrc"
# chip_smoke.F32_ATOL: the limit of the float32 rows against their plain
# versions on the card
F32_ATOL = 1e-4
EPS = 1e-5
BK = 32         # Tf32Gemm::kBK: K a stage (8 chunks of 16 bytes a row)
SMEM_MAX = 227 * 1024  # shared memory a block can use on the H100


def f32_constants(name: str) -> dict:
    text = (CSRC / name).read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (kF32Gemm\w+) = (\d+);", text)}


FFN = f32_constants("ffn.cu")
CONV = f32_constants("convfuse.cu")


def test_constants_are_read():
    """The schedules below take their sizes from the sources, and the
    sources' tiles fit the card: a stage holds the A tile and the weight
    tile's hi and lo parts (32 floats a row), a block's stages (and 1024
    bytes to align them) fit its shared memory (two blocks an SM for the
    small FFN tiles), a partial ends inside a stage, two warpgroups take
    128 rows, and a cluster holds a row's 512 channels."""
    for cfg in (FFN, CONV):
        assert BK // 8 % cfg["kF32GemmSteps"] == 0
        assert cfg["kF32GemmRows"] == 128
    stage = lambda rows, cols: (rows + 2 * cols) * BK * 4  # noqa: E731
    assert FFN["kF32GemmStages"] * stage(
        FFN["kF32GemmRows"], FFN["kF32GemmCols"]) + 1024 <= SMEM_MAX
    assert 2 * (FFN["kF32GemmSmallStages"] * stage(
        FFN["kF32GemmRows"], FFN["kF32GemmSmallCols"]) + 1024) <= SMEM_MAX
    assert CONV["kF32GemmStages"] * stage(
        CONV["kF32GemmRows"], CONV["kF32GemmCols"]) + 1024 <= SMEM_MAX
    assert CONV["kF32GemmCluster"] * CONV["kF32GemmCols"] == 512
    assert min(FFN["kF32GemmStages"], FFN["kF32GemmSmallStages"],
               CONV["kF32GemmStages"]) >= 3


def gemm_tf32(a: torch.Tensor, b_hi: torch.Tensor, b_lo: torch.Tensor,
              steps: int) -> torch.Tensor:
    """A [M, K] . B^T, B [N, K] given split, as Tf32Gemm takes it: A split
    per element, per k8 step lo_a hi_b, hi_a lo_b, hi_a hi_b into a
    partial begun from zero, partials of ``steps`` k-steps added to the
    running sums in order (float32 throughout)."""
    a_hi, a_lo = split(a)
    out = torch.zeros(a.shape[0], b_hi.shape[0])
    for k0 in range(0, a.shape[1], 8 * steps):
        part = None
        for k in range(k0, k0 + 8 * steps, 8):
            s = slice(k, k + 8)
            for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
                term = x[:, s] @ y[:, s].t()
                part = term if part is None else part + term
        out = out + part
    return out


def tile_rows(a: torch.Tensor, rows: int) -> torch.Tensor:
    """a [M, K] with zero rows up to a whole number of row tiles: the rows
    past M that the last tile reads as zeros."""
    pad = -a.shape[0] % rows
    return torch.cat([a, a.new_zeros(pad, a.shape[1])])


def gelu(y: torch.Tensor) -> torch.Tensor:
    return 0.5 * y * (1.0 + torch.erf(y * 0.70710678118654752))


def emulate_ffn(x, w1, b1, w2, b2):
    """ffn_tf32_kernel's two products: x [rows, H], w1 [F, H], w2 [H, F]
    -> [rows, H].  The tile shape (large or small) changes which CTA takes
    an output, not its arithmetic."""
    rows, steps = x.shape[0], FFN["kF32GemmSteps"]
    xp = tile_rows(x, FFN["kF32GemmRows"])
    hidden = gelu(gemm_tf32(xp, *split(w1), steps) + b1)
    hidden[rows:] = 0  # not stored; the second product reads zeros there
    out = gemm_tf32(hidden, *split(w2), steps) + b2
    return out[:rows]


def stat_order(v: torch.Tensor) -> torch.Tensor:
    """[M, 512] -> [M]: a row's sum in conv_tf32_kernel's order.  Channel
    128 r + 8 j + 2 t + e is CTA r's, 8-channel block j's, lane t's of its
    quad, element e's."""
    blocks = CONV["kF32GemmCols"] // 8
    v = v.reshape(v.shape[0], CONV["kF32GemmCluster"], blocks, 4, 2)
    s = torch.zeros(v.shape[:2] + (4,))  # [M, r, t]
    for j in range(blocks):
        s = s + v[..., j, :, 0]
        s = s + v[..., j, :, 1]
    s = s + s[..., [1, 0, 3, 2]]  # shfl_xor 1
    s = s + s[..., [2, 3, 0, 1]]  # shfl_xor 2
    total = s[:, 0, 0]
    for r in range(1, s.shape[1]):
        total = total + s[:, r, 0]
    return total


def emulate_conv(x, w, cb, scale, bias, s, eps=EPS):
    """conv_tf32_kernel: x [B, T, C], w [512, C, k] -> [B, t_out, 512]."""
    b, t, c = x.shape
    k = w.shape[2]
    t_out = (t - k) // s + 1
    m = b * t_out
    a = x.contiguous().as_strided((b, t_out, k * c),
                                  (t * c, s * c, 1)).reshape(m, k * c)
    wk = tconv._gemm_weight(w, torch.float32).contiguous()  # [512, k*C]
    v = gemm_tf32(tile_rows(a, CONV["kF32GemmRows"]), *split(wk),
                  CONV["kF32GemmSteps"]) + cb
    mean = stat_order(v) / 512
    d = v - mean[:, None]
    rstd = torch.rsqrt(stat_order(d * d) / 512 + eps)
    y = gelu(d * rstd[:, None] * scale + bias)
    return y[:m].reshape(b, t_out, 512)


def assert_within(got: torch.Tensor, want) -> None:
    want = torch.from_numpy(np.array(want, np.float32))
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    diff = (got.double() - want.double()).abs()
    assert bool((diff <= F32_ATOL).all()), f"max abs err {diff.max().item()}"


@pytest.mark.parametrize("h,f", [(1024, 4096), (768, 3072)])
def test_ffn_schedule_matches_jax(h, f):
    rng = np.random.RandomState(h + f)
    x = rng.randn(2, 37, h).astype(np.float32)
    w1 = (rng.randn(h, f) * h ** -0.5).astype(np.float32)  # JAX [H, F]
    b1 = (rng.randn(f) * 0.1).astype(np.float32)
    w2 = (rng.randn(f, h) * f ** -0.5).astype(np.float32)
    b2 = (rng.randn(h) * 0.1).astype(np.float32)
    tx, tw1, tb1, tw2, tb2 = (torch.from_numpy(a) for a in (x, w1, b1, w2,
                                                            b2))
    got = emulate_ffn(tx.reshape(-1, h), tw1.t().contiguous(), tb1,
                      tw2.t().contiguous(), tb2).reshape(2, 37, h)
    ref = jffn.ffn_xla(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))
    assert_within(got, ref)
    assert_within(got, tffn.ffn_plain(tx, tw1.t(), tb1, tw2.t(), tb2))


# (k, s, t_in): conv layer 1's geometry (K = 1536) and layer 5's (K =
# 1024), t_in odd; B * t_out = 330 and 260 GEMM rows: three row tiles, the
# second crossing from one batch element into the next, the last ragged
CONV_CASES = {"layer1": (3, 2, 331), "layer5": (2, 2, 261)}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv_schedule_matches_jax(monkeypatch, case):
    monkeypatch.setattr(jconv, "_CONVWIDE", True)
    k, s, t = CONV_CASES[case]
    rng = np.random.RandomState(k * 1000 + t)
    x = rng.randn(2, t, 512).astype(np.float32)
    w = (rng.randn(512, 512, k) * (512 * k) ** -0.5).astype(np.float32)
    cb = (rng.randn(512) * 0.3).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(512)).astype(np.float32)
    bias = (0.1 * rng.randn(512)).astype(np.float32)
    got = emulate_conv(*(torch.from_numpy(a) for a in (x, w, cb, scale,
                                                       bias)), s)
    t_out = (t - k) // s + 1
    wj = jnp.asarray(np.transpose(w, (2, 1, 0)))  # [k, C, O]
    y = jw2v._fold_for_taps(jnp.asarray(x), k, s, t_out, jnp.float32)
    args = (y, jw2v._tap_weights(wj, s), jnp.asarray(cb),
            jnp.asarray(scale), jnp.asarray(bias))
    assert_within(got, jconv._xla_ref(*args, EPS, t_out))
    with pltpu.force_tpu_interpret_mode():
        assert_within(got, jconv._fused(*args, EPS, t_out, 16))
    assert_within(got, tconv.conv_bias_ln_gelu_plain(
        *(torch.from_numpy(a) for a in (x, w, cb, scale, bias)), s))
