"""The schedule of the bf16 LayerNorm kernel, emulated on the CPU.

``ln_vec_kernel`` of ``ops/csrc/layernorm.cu`` (K1, and K2 with the conv
bias and GELU) runs only on the card.  This file writes its schedule out
in torch and numpy, with its configuration read from the source, and holds
it against the port's plain versions and the JAX package's Pallas kernels
(interpret mode) at ``chip_smoke.py``'s bf16 limit:

* the chunk map: lane l owns columns [256 p + 8 l, 256 p + 8 l + 8) of
  every 256-column pass p, one 16-byte access each where the chunk is
  whole and h is a multiple of 8, else (the masked tail) 8-, 4- or 2-byte
  accesses as the row's alignment allows;
* the persistent grid: min(ceil(rows / warps), SMs x CTAs an SM) CTAs,
  each warp walking rows with a grid stride through a ring of kDepth
  register buffers (a row's buffer is refilled with the row kDepth strides
  on before the row is reduced; nothing past the last row is loaded), and
  asking L2 for the kPrefetch rows beyond the ring;
* the arithmetic: each lane's partial sums pass by pass, 8 columns in
  order, then the xor butterfly 16, 8, 4, 2, 1; the mean; the deviations;
  their squares the same way (fused multiply-adds, emulated in float64);
  rsqrt; scale and bias; the exact GELU; one bf16 rounding.

Every (row, column) is written exactly once and no access leaves
[0, rows * h), at small ragged shapes in full and at the main path's
shapes by rows.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wav2vecsegmenter_tpu.ops import layernorm as jln
from wav2vecsegmenter_tpu.ops.backend import set_backend
from wav2vecsegmenter_tpu_torch.ops import layernorm as tln

CSRC = Path(tln.__file__).resolve().parent / "csrc"
# the kernel and its shared pieces (chunk map, masked tail: ln_vec.cuh)
SRC = (CSRC / "layernorm.cu").read_text() + (CSRC / "ln_vec.cuh").read_text()
EPS = 1e-5
# the limit chip_smoke.py holds the bf16 kernels to against the plain
# version: one bf16 step at |y| in [4, 8)
BF16_ATOL = 2 ** -5
# the float32 arithmetic of the emulation against the float32 plain
# version (summation order, rsqrt rounding)
F32_ATOL = 1e-5
SMS = 132  # the H100 SXM's SMs


def config(name: str) -> dict:
    """LnVec<WARPS, DEPTH, MINB, PREFETCH> of the line ``using <name> =
    ...``."""
    warps, depth, minb, prefetch = re.search(
        rf"using {name} = LnVec<(\d+), (\d+), (\d+), (\d+)>;", SRC).groups()
    return {"warps": int(warps), "depth": int(depth), "minb": int(minb),
            "prefetch": int(prefetch)}


CHUNK = int(re.search(r"constexpr int kLnChunk = (\d+);", SRC).group(1))
PASS = 32 * CHUNK
CFG = {False: config("LnVecCfg"), True: config("LnVecGeluCfg")}


def test_config_is_read():
    """The shapes the emulation assumes: 16-byte chunks of 8 bf16 columns,
    256-column passes, at most 4 passes (h <= 1024)."""
    assert CHUNK == 8 and "constexpr int kLnPass = 32 * kLnChunk;" in SRC
    assert "h > 4 * kLnPass" in SRC and tln.MAX_H == 4 * PASS
    for cfg in CFG.values():
        assert cfg["warps"] >= 1 and cfg["depth"] >= 1 and cfg["minb"] >= 1


# ------------------------------------------------------------ the schedule

def grid(rows: int, warps: int, ctas: int) -> int:
    """CTAs launch_vec_at launches: the rows' warps, at most the CTAs the
    card holds at once (``ctas``)."""
    return min(-(-rows // warps), ctas)


def walk(rows: int, cfg: dict, ctas: int):
    """Per warp, in the kernel's order: (rows it loads, rows it reduces
    and stores).  Asserts that each row is reduced from the ring slot its
    load went to, and that each row asked of L2 ahead (kPrefetch rows
    beyond the ring) is one the warp loads later."""
    warps, depth, ahead = cfg["warps"], cfg["depth"], cfg["prefetch"]
    stride = grid(rows, warps, ctas) * warps
    for w in range(stride):
        if w >= rows:  # the whole warp returns
            continue
        slots, loads, order, asked = {}, [], [], []

        def prefetch(r):
            if r < rows:
                asked.append(r)

        for d in range(depth):  # the prologue
            if w + d * stride < rows:
                slots[d] = w + d * stride
                loads.append(w + d * stride)
        for k in range(depth, depth + ahead):
            prefetch(w + k * stride)
        row = w
        while row < rows:
            for d in range(depth):
                r = row + d * stride
                if r >= rows:
                    break
                assert slots.pop(d) == r
                nxt = r + depth * stride
                if nxt < rows:  # the refill, before the reduction
                    assert ahead == 0 or nxt in asked
                    slots[d] = nxt
                    loads.append(nxt)
                if ahead:
                    prefetch(r + (depth + ahead) * stride)
                order.append(r)
            row += depth * stride
        assert not slots
        assert sorted(asked) == sorted(set(asked)) and set(asked) <= set(loads)
        yield w, loads, order


def access_width(h: int, n: int) -> int:
    """Elements in one access of a chunk with n columns below h: 8 (16
    bytes) for a whole chunk of a row whose width is a multiple of 8, else
    the widest the row's alignment allows (ln_load_part)."""
    if h % 8 == 0 and n == CHUNK:
        return 8
    return 4 if h % 4 == 0 else 2 if h % 2 == 0 else 1


def chunks(h: int):
    """(pass, lane, first column, valid columns) of every chunk that holds
    a column below h."""
    for p in range(-(-h // PASS)):
        for lane in range(32):
            c0 = p * PASS + lane * CHUNK
            n = min(max(h - c0, 0), CHUNK)
            if n:
                yield p, lane, c0, n


def accesses(r: int, h: int, rows: int, counts: np.ndarray | None = None):
    """Row r's loads (or stores: ``counts`` counts their elements), each
    asserted inside [0, rows * h) and aligned to its own size (x's base is
    16-byte aligned); a chunk's columns are a whole number of accesses."""
    for _, _, c0, n in chunks(h):
        width = access_width(h, n)
        assert n % width == 0
        for base in range(r * h + c0, r * h + c0 + n, width):
            assert base % width == 0
            assert base >= 0 and base + width <= rows * h
            if counts is not None:
                counts[base:base + width] += 1


# --------------------------------------------------------- the arithmetic

def lane_sum(v: torch.Tensor) -> torch.Tensor:
    """[R, passes, 32, 8] float32 -> [R] sums in the kernel's order: each
    lane adds its columns pass by pass, 8 in order; then the butterfly."""
    s = torch.zeros(v.shape[0], 32)
    for p in range(v.shape[1]):
        for j in range(CHUNK):
            s = s + v[:, p, :, j]
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, lanes ^ o]
    assert bool((s == s[:, :1]).all())  # every lane holds the same sum
    return s[:, 0]


def lane_sq_sum(d: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The squared deviations' sums: fused multiply-adds (sq += d * d,
    one rounding, emulated in float64) over the valid columns, then the
    butterfly."""
    s = torch.zeros(d.shape[0], 32)
    for p in range(d.shape[1]):
        for j in range(CHUNK):
            dj = d[:, p, :, j].double()
            fma = (s.double() + dj * dj).float()
            s = torch.where(valid[p, :, j], fma, s)
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, lanes ^ o]
    return s[:, 0]


def emulate_rows(x: torch.Tensor, conv_bias, scale, bias, gelu: bool,
                 eps: float = EPS) -> torch.Tensor:
    """[R, h] -> [R, h] float32 (before the cast), every row as a warp of
    ln_vec_kernel computes it."""
    rows, h = x.shape
    passes = -(-h // PASS)
    width = passes * PASS

    def lanes(a):  # [..., h] -> [..., passes, 32, 8], zeros past h
        a = torch.nn.functional.pad(a.float(), (0, width - h))
        return a.reshape(*a.shape[:-1], passes, 32, CHUNK)

    v = lanes(x)
    if gelu:
        v = v + lanes(conv_bias)
    valid = lanes(torch.ones(h)) > 0
    mean = lane_sum(v) / h
    d = v - mean[:, None, None, None]
    rstd = torch.rsqrt(lane_sq_sum(d, valid) / h + eps)
    t = d * rstd[:, None, None, None]
    y = ((t.double() * lanes(scale).double() + lanes(bias).double())
         .float())  # fma(t, scale, bias)
    if gelu:
        y = 0.5 * y * (1.0 + torch.erf(y * 0.70710678118654752))
    return y.reshape(rows, width)[:, :h]


def emulate(x, conv_bias, scale, bias, gelu: bool, ctas: int):
    """The kernel's output: every warp's rows in its order, stored through
    the chunk map into an output that starts as NaN; asserts each element
    is loaded and stored once."""
    rows, h = x.shape
    y = emulate_rows(x, conv_bias, scale, bias, gelu).to(x.dtype)
    out = torch.full_like(x, float("nan")).reshape(-1)
    loaded = np.zeros(rows * h, np.int64)
    stored = np.zeros(rows * h, np.int64)
    for _, loads, order in walk(rows, CFG[gelu], ctas):
        for r in loads:
            accesses(r, h, rows, loaded)
        for r in order:
            before = stored.copy()
            accesses(r, h, rows, stored)
            idx = torch.from_numpy(np.nonzero(stored != before)[0])
            out[idx] = y[r][idx - r * h]
    assert (loaded == 1).all() and (stored == 1).all()
    return out.reshape(rows, h)


def inputs(rows, h, seed, dtype=torch.bfloat16):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(rows, h) * 2.0 + 0.5).astype(np.float32))
    scale = torch.from_numpy((1.0 + 0.1 * rng.randn(h)).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.randn(h)).astype(np.float32))
    cbias = torch.from_numpy((0.3 * rng.randn(h)).astype(np.float32))
    return x.to(dtype), scale, bias, cbias


def jax_ref(x, cbias, scale, bias, gelu: bool) -> torch.Tensor:
    """The JAX Pallas kernel (_ln_kernel or _bln_gelu_kernel) in interpret
    mode on the same bf16 inputs."""
    xj = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    sj, bj, cj = (jnp.asarray(a.numpy()) for a in (scale, bias, cbias))
    set_backend("pallas")
    try:
        with pltpu.force_tpu_interpret_mode():
            out = (jln.bias_layer_norm_gelu(xj, cj, sj, bj) if gelu
                   else jln.layer_norm_pallas(xj, sj, bj))
            return torch.from_numpy(np.array(out.astype(jnp.float32)))
    finally:
        set_backend("auto")


def assert_close(got, want, atol):
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= atol).all()), f"max abs err {diff.max().item()}"


# (h, rows, CTAs the card holds, gelu): the main path's widths and widths
# with a masked tail (200: a partial pass; 1020, 518 and 301: also not a
# multiple of 8, in 8-, 4- and 2-byte accesses); rows not a multiple of the
# grid's warps, and fewer rows than a CTA's warps
CASES = {
    "k1_h1024": (1024, 37, 3, False),
    "k1_h1024_few_rows": (1024, 3, SMS, False),
    "k1_h512": (512, 37, 2, False),
    "k2_h512": (512, 37, 3, True),
    "k2_h512_few_rows": (512, 5, SMS, True),
    "k1_h200_tail": (200, 29, 2, False),
    "k2_h200_tail": (200, 29, 2, True),
    "k1_h1020_tail": (1020, 21, 2, False),
    "k2_h518_tail": (518, 13, 2, True),
    "k1_h301_tail": (301, 11, 2, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ln_vec_schedule(case):
    """The emulated kernel against the plain version and the JAX Pallas
    kernel (bf16 in and out), and its float32 arithmetic against the
    float32 plain version."""
    h, rows, ctas, gelu = CASES[case]
    x, scale, bias, cbias = inputs(rows, h, seed=h + rows)
    got = emulate(x, cbias, scale, bias, gelu, ctas)
    if gelu:
        plain = tln.bias_layer_norm_gelu_plain(x, cbias, scale, bias)
    else:
        plain = tln.layer_norm_plain(x, scale, bias)
    assert torch.isfinite(got.float()).all()
    assert_close(got, plain, BF16_ATOL)
    assert_close(got, jax_ref(x, cbias, scale, bias, gelu), BF16_ATOL)
    x32 = x.float()
    want32 = (tln.bias_layer_norm_gelu_plain(x32, cbias, scale, bias) if gelu
              else tln.layer_norm_plain(x32, scale, bias))
    assert_close(emulate_rows(x32, cbias, scale, bias, gelu), want32,
                 F32_ATOL)


# the main path's shapes: K1 at a batch of 14 x 20 s and at the tail
# bucket (22 s), h = 1024 and 512; K2 at conv layers 0 and 1's outputs
FULL = {"k1_h1024": (14 * 999, 1024, False),
        "k1_h512": (14 * 999, 512, False),
        "k1_tail_bucket": (14 * 1099, 1024, False),
        "k2_layer0": (14 * 63999, 512, True),
        "k2_layer1": (14 * 31999, 512, True)}


@pytest.mark.parametrize("shape", list(FULL))
def test_full_shapes_cover_rows(shape):
    """At the main path's shapes, for 1-3 CTAs an SM on 132 SMs: the grid
    stride gives every row to exactly one warp, each warp's loads (the
    prologue's and the refills) are exactly its rows, and a row's chunks
    cover its columns once, inside x."""
    rows, h, gelu = FULL[shape]
    cfg = CFG[gelu]
    warps, depth = cfg["warps"], cfg["depth"]
    for per_sm in (1, 2, 3):
        stride = grid(rows, warps, SMS * per_sm) * warps
        k = np.arange(-(-rows // stride))
        owned = (np.arange(stride)[:, None] + k[None, :] * stride)
        assert np.bincount(owned[owned < rows], minlength=rows).max() == 1
        assert (owned < rows).sum() == rows
        # a warp's loads: rows w + d*stride (d < depth) in the prologue,
        # then r + depth*stride after reducing r, all below rows
        first = owned[:, :depth]
        refill = owned + depth * stride
        loads = np.concatenate([first[first < rows], refill[refill < rows]])
        assert np.array_equal(np.sort(loads), np.arange(rows))
    cols = np.zeros(h, np.int64)
    for _, _, c0, n in chunks(h):
        cols[c0:c0 + n] += 1
    assert (cols == 1).all()
    accesses(rows - 1, h, rows)
    accesses(0, h, rows)


@pytest.mark.parametrize("depth,ahead", [(1, 1), (1, 2), (2, 2), (2, 4)])
def test_walk_with_l2_prefetch(depth, ahead):
    """The row walk with other ring depths and L2 prefetch distances than
    the source's (the sweep's variants): every row is loaded, asked of L2
    before its load (past the ring's first rows) and stored exactly once."""
    rows, h = 53, 1024
    cfg = {"warps": 4, "depth": depth, "minb": 1, "prefetch": ahead}
    loaded = np.zeros(rows, np.int64)
    stored = np.zeros(rows, np.int64)
    for _, loads, order in walk(rows, cfg, ctas=3):
        np.add.at(loaded, loads, 1)
        np.add.at(stored, order, 1)
        for r in order:
            accesses(r, h, rows)
    assert (loaded == 1).all() and (stored == 1).all()
