"""The schedule of the bf16 LayerNorm backward kernel (K9), emulated on the
CPU.

``ln_bwd_vec_kernel`` of ``ops/csrc/layernorm_bwd.cu`` runs only on the
card.  This file writes its schedule out in torch and numpy, with its
configuration read from the source (``using LnBwdCfg = LnBwd<...>;``,
``kRedGroups``, ``kRedCols``), and holds it against the port's plain
version and the JAX package's Pallas kernel (``jax.vjp`` through
``_ln_2d``'s custom VJP, interpret mode):

* the chunk map and masked tail of the forward kernel (lane l owns columns
  [256 p + 8 l, 256 p + 8 l + 8) of pass p; 16-byte accesses where the
  chunk is whole and h a multiple of 8, else 8-, 4- or 2-byte ones), for
  the loads of x and g and the stores of dx; with bulk-copied rows (the
  BULK option, widths that are a multiple of 8) one 2h-byte copy a row;
* the persistent grid: min(ceil(rows / warps), SMs x CTAs an SM) CTAs,
  each warp walking rows with a grid stride through a ring of kDepth rows;
* the arithmetic: the row statistics as the forward kernel takes them;
  s1 = sum g * scale and s2 = sum g * scale * xhat lane by lane, pass by
  pass, 8 columns in order (s2 by fused multiply-adds, emulated in
  float64), then the xor butterfly; dx = (gs - m1 - xhat * m2) * rstd (a
  fused multiply-add, then one multiply); one bf16 rounding;
* the column sums: each lane adds dscale += g * xhat (fused) and dbias +=
  g over its warp's rows in order; the CTA adds its warps in order into
  one partial row; the cross-block pass adds partial rows y, y +
  kRedGroups, ... for each group y, then the groups in order (the same in
  the second kernel and in the in-kernel handoff).

Limits, those ``chip_smoke.py`` holds K9 to on the card: a bf16 dx within
2^-5 + 2^-7 |want| (one bf16 step); float32 outputs (dx of the float32
arithmetic, dscale and dbias in both) within 1e-4 + 1e-5 |want|.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wav2vecsegmenter_tpu.ops import layernorm as jln
from wav2vecsegmenter_tpu.ops.backend import set_backend
from wav2vecsegmenter_tpu_torch.ops import backend as tbackend
from wav2vecsegmenter_tpu_torch.ops import layernorm as tln

from .test_torch_ln_tiles import (CHUNK, PASS, SMS, accesses, chunks, grid,
                                  lane_sq_sum, lane_sum, walk)

SRC = (Path(tln.__file__).resolve().parent / "csrc" / "layernorm_bwd.cu"
       ).read_text()
EPS = 1e-5
BF16_LIMITS = (2 ** -5, 2 ** -7)   # chip_smoke: BF16_ATOL, BWD_RTOL[bf16]
F32_LIMITS = (1e-4, 1e-5)          # chip_smoke: F32_ATOL, BWD_RTOL[f32]


def config() -> dict:
    """LnBwd<WARPS, DEPTH, MINB, SMEM_SUMS, HANDOFF, BULK> of the line
    ``using LnBwdCfg = ...``."""
    m = re.search(r"using LnBwdCfg = LnBwd<(\d+), (\d+), (\d+), (true|false),"
                  r" (true|false), (true|false)>;", SRC)
    w, d, minb, smem, handoff, bulk = m.groups()
    return {"warps": int(w), "depth": int(d), "minb": int(minb),
            "smem_sums": smem == "true", "handoff": handoff == "true",
            "bulk": bulk == "true", "prefetch": 0}


CFG = config()
GROUPS = int(re.search(r"constexpr int kRedGroups = (\d+);", SRC).group(1))
RED_COLS = int(re.search(r"constexpr int kRedCols = (\d+);", SRC).group(1))


def test_config_is_read():
    """The shapes the emulation assumes: at most 4 passes (h <= 1024), a
    warp a row, whole column groups in the in-kernel pass."""
    assert "constexpr int kMaxH = 4 * kLnPass;" in SRC and tln.MAX_H == 4 * PASS
    assert CFG["warps"] >= 1 and CFG["depth"] >= 1 and CFG["minb"] >= 1
    assert GROUPS >= 1 and RED_COLS >= 1
    assert "constexpr int kRedThreads = kRedGroups * kRedCols;" in SRC
    assert (CFG["warps"] * 32) % GROUPS == 0


# --------------------------------------------------------- the arithmetic

def lanes(a: torch.Tensor, h: int) -> torch.Tensor:
    """[..., h] -> [..., passes, 32, 8] float32, zeros past h."""
    passes = -(-h // PASS)
    a = torch.nn.functional.pad(a.float(), (0, passes * PASS - h))
    return a.reshape(*a.shape[:-1], passes, 32, CHUNK)


def unlanes(a: torch.Tensor, h: int) -> torch.Tensor:
    return a.reshape(a.shape[0], -1)[:, :h]


def fma(a, b, c):
    """float32 fused multiply-add (one rounding), emulated in float64."""
    return (a.double() * b.double() + c.double()).float()


def butterfly(s: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, idx ^ o]
    return s[:, 0]


def emulate_rows(x, scale, g, need_dx=True, eps=EPS):
    """Every row as a warp computes it: (xhat [R, h], dx [R, h] float32
    before the cast, or None)."""
    h = x.shape[1]
    v, gv, sc = lanes(x, h), lanes(g, h), lanes(scale, h)
    valid = lanes(torch.ones(h), h) > 0
    mean = lane_sum(v) / h
    d = v - mean[:, None, None, None]
    rstd = torch.rsqrt(lane_sq_sum(d, valid) / h + eps)[:, None, None, None]
    xh = d * rstd
    gs = gv * sc
    if not need_dx:
        return unlanes(xh, h), None
    s2 = torch.zeros(x.shape[0], 32)
    for p in range(v.shape[1]):
        for j in range(CHUNK):
            s2 = fma(gs[:, p, :, j], xh[:, p, :, j], s2)
    m1 = (lane_sum(gs) / h)[:, None, None, None]
    m2 = (butterfly(s2) / h)[:, None, None, None]
    dx = fma(-xh, m2, gs - m1) * rstd
    return unlanes(xh, h), unlanes(dx, h)


def column_sums(g, xh, ctas, cfg=CFG):
    """(dscale, dbias, partial rows [n_ctas, 2, h]): each lane's sums over
    its warp's rows in order, the CTA's warps in order, then the
    cross-block groups."""
    rows, h = g.shape
    warps = cfg["warps"]
    n_cta = grid(rows, warps, ctas)
    stride = n_cta * warps
    g32 = g.float()
    acc = torch.zeros(2, stride, h)
    w = torch.arange(stride)
    for k in range(-(-rows // stride)):
        r = w + k * stride
        ok = (r < rows)[:, None]
        rr = r.clamp(max=rows - 1)
        acc[0] = torch.where(ok, fma(g32[rr], xh[rr], acc[0]), acc[0])
        acc[1] = torch.where(ok, acc[1] + g32[rr], acc[1])
    per_cta = acc.reshape(2, n_cta, warps, h)
    part = torch.zeros(2, n_cta, h)
    for i in range(warps):
        part = part + per_cta[:, :, i]
    return (*cross(part.transpose(0, 1)), part.transpose(0, 1))


def cross(part: torch.Tensor):
    """[n, 2, h] -> (dscale, dbias): group y adds partial rows y, y +
    GROUPS, ... in order; then the groups in order."""
    groups = torch.zeros(GROUPS, *part.shape[1:])
    for b in range(part.shape[0]):
        groups[b % GROUPS] = groups[b % GROUPS] + part[b]
    total = torch.zeros(part.shape[1:])
    for y in range(GROUPS):
        total = total + groups[y]
    return total[0], total[1]


def emulate(x, scale, g, ctas, need_dx=True, cfg=CFG):
    """The kernel's outputs (dx or None, dscale, dbias): dx stored through
    the chunk map into an output that starts as NaN; asserts every element
    of x and g is loaded once and of dx stored once, inside [0, rows * h)."""
    rows, h = x.shape
    xh, dx = emulate_rows(x, scale, g, need_dx)
    out = torch.full((rows * h,), float("nan"), dtype=x.dtype)
    loaded = np.zeros(rows * h, np.int64)
    stored = np.zeros(rows * h, np.int64)
    bulk = cfg["bulk"] and h % 8 == 0
    for _, loads, order in walk(rows, cfg, ctas):
        for r in loads:  # x and g alike
            if bulk:  # one 2h-byte copy a row, 16-byte aligned
                assert (2 * r * h) % 16 == 0 and (2 * h) % 16 == 0
                loaded[r * h:(r + 1) * h] += 1
            else:
                accesses(r, h, rows, loaded)
        if not need_dx:
            continue
        for r in order:
            before = stored.copy()
            accesses(r, h, rows, stored)
            idx = torch.from_numpy(np.nonzero(stored != before)[0])
            out[idx] = dx[r][idx - r * h].to(x.dtype)
    assert (loaded == 1).all()
    assert (stored == int(need_dx)).all()
    dscale, dbias, _ = column_sums(g, xh, ctas, cfg)
    return (out.reshape(rows, h) if need_dx else None), dscale, dbias


def inputs(rows, h, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(rows, h) * 2.0 + 0.5).astype(np.float32))
    g = torch.from_numpy(rng.randn(rows, h).astype(np.float32))
    scale = torch.from_numpy((1.0 + 0.1 * rng.randn(h)).astype(np.float32))
    return x, g, scale


def jax_vjp(x, scale, g):
    """(dx, dscale, dbias) of jax.vjp through the Pallas custom VJP
    (_ln_bwd_kernel, interpret mode) on the same bf16 x and g."""
    bias = jnp.zeros(scale.shape[0], jnp.float32)
    set_backend("pallas")
    try:
        with pltpu.force_tpu_interpret_mode():
            _, vjp = jax.vjp(jln.layer_norm_pallas,
                             jnp.asarray(x.float().numpy(), jnp.bfloat16),
                             jnp.asarray(scale.numpy()), bias)
            return [torch.from_numpy(np.array(a.astype(jnp.float32)))
                    for a in vjp(jnp.asarray(g.float().numpy(),
                                             jnp.bfloat16))]
    finally:
        set_backend("auto")


def assert_close(got, want, limits):
    atol, rtol = limits
    diff = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    assert bool((diff <= lim).all()), f"max abs err {diff.max().item()}"


# (h, rows, CTAs the card holds): the main path's width, A4's feature
# projection's, widths with a masked tail (1020, 518, 301: not a multiple
# of 8; 200: a partial pass), fewer rows than a CTA's warps, and more CTAs
# than column groups (partial rows that share a group)
CASES = {
    "h1024": (1024, 37, 3),
    "h1024_few_rows": (1024, 3, SMS),
    "h512": (512, 45, 2),
    "h1020_tail": (1020, 21, 2),
    "h518_tail": (518, 13, 2),
    "h301_tail": (301, 11, 2),
    "h200_tail": (200, 29, 2),
    "h64_many_ctas": (64, 300, 70),
}


@pytest.mark.parametrize("need_dx", [True, False], ids=["dx", "no_dx"])
@pytest.mark.parametrize("case", list(CASES))
def test_ln_bwd_schedule(case, need_dx):
    """The emulated kernel against the plain version and jax.vjp through
    the JAX Pallas kernel (bf16 x and g), and its float32 arithmetic
    against the float32 plain version; without dx, the same column sums
    bit for bit and no dx written."""
    h, rows, ctas = CASES[case]
    x, g, scale = inputs(rows, h, seed=h + rows)
    xb, gb = x.bfloat16(), g.bfloat16()
    got = emulate(xb, scale, gb, ctas, need_dx)
    plain = tln.layer_norm_bwd_plain(xb, scale, gb, need_dx=need_dx)
    ref = jax_vjp(xb, scale, gb)
    for i, limits in enumerate((BF16_LIMITS, F32_LIMITS, F32_LIMITS)):
        if i == 0 and not need_dx:
            assert got[0] is None and plain[0] is None
            continue
        assert torch.isfinite(got[i].float()).all()
        assert got[i].dtype == plain[i].dtype
        assert_close(got[i], plain[i], limits)
        assert_close(got[i], ref[i], limits)
    if not need_dx:
        full = emulate(xb, scale, gb, ctas, True)
        assert torch.equal(got[1], full[1]) and torch.equal(got[2], full[2])
    got32 = emulate(x, scale, g, ctas, need_dx)
    want32 = tln.layer_norm_bwd_plain(x, scale, g, need_dx=need_dx)
    for a, b in zip(got32, want32):
        if a is not None:
            assert_close(a, b, F32_LIMITS)


def sum_order(rows: int, h: int, ctas: int, cfg=CFG):
    """The order in which column c of dscale (and dbias) adds the rows, the
    same for every column: for each group y in order, for each of its
    partial rows b in order, for each warp of CTA b in order, the warp's
    rows in order."""
    warps = cfg["warps"]
    n_cta = grid(rows, warps, ctas)
    stride = n_cta * warps
    return tuple(
        tuple(tuple(tuple(range(b * warps + i, rows, stride))
                    for i in range(warps))
              for b in range(y, n_cta, GROUPS))
        for y in range(GROUPS))


@pytest.mark.parametrize("h,rows,ctas", [(64, 300, 70), (200, 29, 2),
                                         (1020, 21, 2)])
def test_summation_order_depends_on_shape_and_grid_only(h, rows, ctas):
    """Every row is added once into each column's sum, in an order that
    sum_order(rows, h, grid) spells out without the data; following that
    order one float32 operation at a time gives the emulation's bits for
    two different draws of the data (so two runs agree bitwise); another
    grid is another order."""
    order = sum_order(rows, h, ctas)
    flat = [r for grp in order for cta in grp for w in cta for r in w]
    assert sorted(flat) == list(range(rows))
    assert sum_order(rows, h, ctas) == order
    if grid(rows, CFG["warps"], ctas) > 1:
        assert sum_order(rows, h, 1) != order
    for seed in (0, 1):
        x, g, scale = inputs(rows, h, seed)
        xb, gb = x.bfloat16(), g.bfloat16()
        xh, _ = emulate_rows(xb, scale, gb, need_dx=False)
        dscale, dbias, _ = column_sums(gb, xh, ctas)
        gn, xn = gb.float().numpy(), xh.numpy()
        for c in (0, h // 2, h - 1):
            tot_s = tot_b = np.float32(0)
            for grp in order:
                gs_ = gb_ = np.float32(0)
                for cta in grp:
                    ps = pb = np.float32(0)
                    for w in cta:
                        s = b = np.float32(0)
                        for r in w:
                            s = np.float32(np.float64(gn[r, c])
                                           * np.float64(xn[r, c])
                                           + np.float64(s))
                            b = np.float32(b + gn[r, c])
                        ps, pb = np.float32(ps + s), np.float32(pb + b)
                    gs_, gb_ = np.float32(gs_ + ps), np.float32(gb_ + pb)
                tot_s, tot_b = np.float32(tot_s + gs_), np.float32(tot_b + gb_)
            assert tot_s == dscale[c].item() and tot_b == dbias[c].item()


@pytest.mark.parametrize("h", [1024, 512, 1020, 64])
@pytest.mark.parametrize("n_part", [1, 31, 132, 264, 528])
def test_cross_pass_covers_columns(h, n_part):
    """Both homes of the cross-block pass give each of the 2h columns to
    exactly one set of kRedGroups threads: the second kernel's CTAs
    (kRedCols columns each) and the in-kernel handoff's persistent CTAs
    (warps * 32 / kRedGroups columns a round, grid-strided); each group
    reads partial rows y, y + kRedGroups, ... below n_part, each once."""
    second = np.zeros(2 * h, np.int64)
    for blk in range(-(-2 * h // RED_COLS)):
        for x in range(RED_COLS):
            if blk * RED_COLS + x < 2 * h:
                second[blk * RED_COLS + x] += 1
    nc = CFG["warps"] * 32 // GROUPS
    handoff = np.zeros(2 * h, np.int64)
    for blk in range(n_part):
        for col0 in range(blk * nc, 2 * h, n_part * nc):
            for x in range(nc):
                if col0 + x < 2 * h:
                    handoff[col0 + x] += 1
    assert (second == 1).all() and (handoff == 1).all()
    reads = np.zeros(n_part, np.int64)
    for y in range(GROUPS):
        reads[y:n_part:GROUPS] += 1
    assert (reads == 1).all()


# the main path's shapes (train phase; A4's feature projection) and the
# masked-tail width chip_smoke.py checks
FULL = {"h1024": (14 * 999, 1024), "h512": (14 * 999, 512),
        "h1020": (14 * 999, 1020)}


@pytest.mark.parametrize("shape", list(FULL))
def test_full_shapes_cover_rows(shape):
    """At the main path's shapes, for 1-4 CTAs an SM on 132 SMs: the grid
    stride gives every row to exactly one warp, each warp's loads (the
    prologue's and the refills) are exactly its rows, a row's chunks cover
    its columns once inside x, and the partial rows fit the cross pass."""
    rows, h = FULL[shape]
    warps, depth = CFG["warps"], CFG["depth"]
    for per_sm in (1, 2, 3, 4):
        n_cta = grid(rows, warps, SMS * per_sm)
        stride = n_cta * warps
        k = np.arange(-(-rows // stride))
        owned = np.arange(stride)[:, None] + k[None, :] * stride
        assert np.bincount(owned[owned < rows], minlength=rows).max() == 1
        assert (owned < rows).sum() == rows
        first = owned[:, :depth]
        refill = owned + depth * stride
        loads = np.concatenate([first[first < rows], refill[refill < rows]])
        assert np.array_equal(np.sort(loads), np.arange(rows))
        # the partial rows: 2h float32 a CTA (about 1-4 MB)
        assert n_cta * 2 * h * 4 <= 4.5e6
    cols = np.zeros(h, np.int64)
    for _, _, c0, n in chunks(h):
        cols[c0:c0 + n] += 1
    assert (cols == 1).all()
    accesses(rows - 1, h, rows)
    accesses(0, h, rows)


@pytest.mark.parametrize("depth,warps,bulk", [(1, 4, False), (3, 8, False),
                                              (2, 4, True), (4, 2, True)])
def test_other_configurations(depth, warps, bulk):
    """The sweep's other configurations (ring depth, warps, rows staged by
    bulk copies) keep the schedule whole: every row loaded and dx stored
    once, the sums within the limits of the plain version's."""
    cfg = dict(CFG, depth=depth, warps=warps, bulk=bulk)
    h, rows = 512, 53
    x, g, scale = (a.bfloat16() if a.dim() == 2 else a
                   for a in inputs(rows, h, seed=5))
    got = emulate(x, scale, g, 3, True, cfg)
    want = tln.layer_norm_bwd_plain(x, scale, g)
    for a, b, lim in zip(got, want, (BF16_LIMITS, F32_LIMITS, F32_LIMITS)):
        assert_close(a, b, lim)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_asks_no_dx_when_x_needs_none(monkeypatch, dtype):
    """torch.autograd.grad through layer_norm with x not requiring grad
    calls layer_norm_bwd with need_dx=False, and its dscale and dbias equal
    the full path's bit for bit; on the kernel path the flag reaches the
    launch (launches stood in for by the plain versions)."""
    x, g, scale = inputs(23, 128, seed=9)
    x, g = x.to(dtype), g.to(dtype)
    scale = scale.requires_grad_()
    bias = torch.zeros(128, requires_grad=True)
    calls = []
    real = tln.layer_norm_bwd

    def spy(x_, scale_, g_, eps=tln.EPS, need_dx=True):
        calls.append(need_dx)
        return real(x_, scale_, g_, eps, need_dx)

    monkeypatch.setattr(tln, "layer_norm_bwd", spy)
    ds, db = torch.autograd.grad(tln.layer_norm(x, scale, bias),
                                 (scale, bias), g)
    xg = x.clone().requires_grad_()
    dx, ds2, db2 = torch.autograd.grad(tln.layer_norm(xg, scale, bias),
                                       (xg, scale, bias), g)
    assert calls == [False, True]
    assert torch.equal(ds, ds2) and torch.equal(db, db2)
    assert dx.dtype == dtype and ds.dtype == torch.float32
    assert tln.layer_norm_bwd_plain(x, scale, g, need_dx=False)[0] is None

    launched = []

    def launch_bwd(x_, scale_, g_, eps, need_dx):
        launched.append(need_dx)
        return tln.layer_norm_bwd_plain(x_, scale_, g_, eps, need_dx)

    def launch_fwd(x_, conv_bias, scale_, bias_, eps, gelu):
        with torch.no_grad():
            return tln.layer_norm_plain(x_, scale_, bias_, eps)

    monkeypatch.setattr(tbackend, "use_kernel", lambda t: True)
    monkeypatch.setattr(tln, "_launch", launch_fwd)
    monkeypatch.setattr(tln, "_launch_bwd", launch_bwd)
    monkeypatch.setattr(tln, "layer_norm_bwd", real)
    ds3, db3 = torch.autograd.grad(tln.layer_norm(x, scale, bias),
                                   (scale, bias), g)
    assert launched == [False]
    assert torch.equal(ds3, ds) and torch.equal(db3, db)
