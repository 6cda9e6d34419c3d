"""The schedule of the float32 attention kernels (split TF32), emulated on
the CPU.

The float32 kernels of ``ops/csrc/attention.cu`` (``attn_fwd_f32_kernel``,
K3/K4) and ``ops/csrc/attention_bwd.cu`` (the rows pre-pass,
``attn_bwd_dq_f32_kernel`` and ``attn_bwd_dkdv_f32_kernel``, K10) run on
the card's tensor cores (``mma.sync`` in TF32).  This file writes their
arithmetic out in torch, at their own tile sizes (read from the ``kF32*``
constants of the sources):

* the split: x = hi + lo, hi = x rounded to TF32 (to nearest, ties away
  from zero, on the 13 low mantissa bits, as ``cvt.rna.tf32.f32`` and the
  kernels' ``tf32_round`` do) and lo = x - hi rounded the same way; each
  product a b taken as lo_a hi_b + hi_a lo_b + hi_a hi_b over every k8
  step, in that order, from a zero partial, the partials of S and dP
  (``kF32Steps`` k-steps each) and of a tile's second product (all its
  k-steps) added to their running sums in order;
* the forward: key tiles of the source's size, the skip rule (a tile with
  no valid key is skipped unless the batch row has none), the online
  softmax in log2 units from m = -1e30, the biases -1e30 (masked) and
  -inf (past T), O = alpha O + P V, and (m, l) under grad;
* the backward: the rows table (m, 1/l, delta = do . o) from the
  forward's output and statistics; dq over the visited key tiles; dk and
  dv over every query tile, an own tile whose keys are all masked (in a
  batch row with a valid key) written as zeros.

The emulation is held against the JAX package's ``attention_xla_bthd``
and ``attention_xla`` and against ``jax.vjp`` of them, all float32 from
numpy inputs, at the limits the card holds the kernels to against their
plain versions (chip_smoke.F32_ATOL, and BWD_RTOL[float32] on top for the
gradients), at T = 999, 1099 and 1, head dims 64, 96 and 128, prefix
masks, masks that are not prefixes and a batch row whose keys are all
masked.  Batch rows run side by side, each with its own tile list.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vecsegmenter_tpu.ops import attention as jattn
from wav2vecsegmenter_tpu_torch.ops import attention as tattn

from .test_torch_attention_tiles_fwd import CASES, LOG2E, key_tiles, make_mask
from .torch_tiny import threads_per_worker  # noqa: F401

CSRC = Path(tattn.__file__).resolve().parent / "csrc"
# chip_smoke.F32_ATOL and BWD_RTOL[torch.float32]: the limits of the
# float32 rows against their plain versions on the card
F32_ATOL = 1e-4
F32_RTOL = 1e-5
STATS_TOL = 1e-4  # chip_smoke.STATS_ATOL and STATS_RTOL


def f32_constants(name: str) -> dict:
    text = (CSRC / name).read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (kF32\w+) = (\d+);", text)}


FWD = f32_constants("attention.cu")
BWD = f32_constants("attention_bwd.cu")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32: half a TF32 ulp added to the bits, the low 13
    cleared (nearest, ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor, steps: int) -> torch.Tensor:
    """a [..., M, K] @ b [..., K, N] as the kernels take it: per k8 step
    lo_a hi_b, hi_a lo_b, hi_a hi_b from a zero partial, partials of
    ``steps`` k-steps added in order (float32 throughout)."""
    ks = a.shape[-1] // 8
    (ah, al), (bh, bl) = split(a), split(b)

    def per_step(x, y):  # [..., ks, M, N]: each k-step's own product
        return torch.einsum("...mkc,...kcn->...kmn", x.unflatten(-1, (ks, 8)),
                            y.unflatten(-2, (ks, 8)))

    terms = (per_step(al, bh), per_step(ah, bl), per_step(ah, bh))
    out = None
    for k0 in range(0, ks, steps):
        part = None
        for kk in range(k0, min(ks, k0 + steps)):
            for term in terms:
                part = term[..., kk, :, :] if part is None \
                    else part + term[..., kk, :, :]
        out = part if out is None else out + part
    return out


def key_bias(valid: torch.Tensor, k0: int, n: int) -> torch.Tensor:
    """[B, n] key biases of rows k0 .. k0 + n: 0 valid, -1e30 masked, -inf
    past T."""
    t = valid.shape[1]
    j = torch.arange(k0, k0 + n)
    inside = torch.where(valid[:, j.clamp(max=t - 1)], 0.0, -1e30)
    return torch.where(j < t, inside, -torch.inf)


def tile_rows(x: torch.Tensor, r0: int, n: int) -> torch.Tensor:
    """Rows r0 .. r0 + n of x [B, H, T, D], zeros past T (the zero fill)."""
    out = x.new_zeros(*x.shape[:2], n, x.shape[3])
    part = x[:, :, r0:r0 + n]
    out[:, :, :part.shape[2]] = part
    return out


def visited(mask: torch.Tensor, bk: int) -> torch.Tensor:
    """[B, tiles] bool: the key tiles each batch row's CTA visits."""
    n = -(-mask.shape[1] // bk)
    out = torch.zeros(mask.shape[0], n, dtype=torch.bool)
    for b in range(mask.shape[0]):
        out[b, key_tiles(mask[b], bk)] = True
    return out


def emulate_fwd(q, k, v, mask, scale):
    """attn_fwd_f32_kernel: q [B, Tq, H, D], k, v [B, Tk, H, D] float32 ->
    (out [B, Tq, H, D], stats [B, H, Tq, 2])."""
    d, tk = q.shape[-1], k.shape[1]
    bk = FWD[f"kF32KeyTile{d}"]
    qh, kh, vh = (a.transpose(1, 2) for a in (q, k, v))  # [B, H, T, D]
    c = scale * LOG2E
    m = torch.full(qh.shape[:3] + (1,), -1e30)
    l = torch.zeros(qh.shape[:3] + (1,))
    o = torch.zeros(qh.shape)
    go = visited(mask, bk)
    for i in range(go.shape[1]):
        k0 = i * bk
        kt, vt = tile_rows(kh, k0, bk), tile_rows(vh, k0, bk)
        s = mm3(qh, kt.transpose(2, 3), FWD["kF32Steps"]) * c \
            + key_bias(mask, k0, bk)[:, None, None, :]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l_new = l * alpha + p.sum(-1, keepdim=True)
        o_new = o * alpha + mm3(p, vt, bk // 8)
        keep = go[:, i][:, None, None, None]
        m, l, o = (torch.where(keep, new, old) for new, old in
                   ((m_new, m), (l_new, l), (o_new, o)))
    out = (o / l).transpose(1, 2)
    return out, torch.cat([m, l], -1)


def emulate_bwd(q, k, v, mask, do, scale, o, stats):
    """The rows pre-pass, attn_bwd_dq_f32_kernel and
    attn_bwd_dkdv_f32_kernel -> (dq, dk, dv) [B, T, H, D]."""
    d, tq, tk = q.shape[-1], q.shape[1], k.shape[1]
    bn, own, steps = BWD[f"kF32Stream{d}"], BWD["kF32Rows"], BWD["kF32Steps"]
    qh, kh, vh, doh = (a.transpose(1, 2) for a in (q, k, v, do))
    c = scale * LOG2E
    # the rows table: (m, 1/l, delta = do . o), [B, H, Tq]
    m, il = stats[..., 0], 1.0 / stats[..., 1]
    delta = (do * o).sum(-1).transpose(1, 2)

    # dq: the visited key tiles of each batch row
    dq = torch.zeros(qh.shape)
    go = visited(mask, bn)
    for i in range(go.shape[1]):
        k0 = i * bn
        kt, vt = tile_rows(kh, k0, bn), tile_rows(vh, k0, bn)
        s = mm3(qh, kt.transpose(2, 3), steps)
        dp = mm3(doh, vt.transpose(2, 3), steps)
        p = torch.exp2(s * c + key_bias(mask, k0, bn)[:, None, None, :]
                       - m[..., None]) * il[..., None]
        ds = p * (dp - delta[..., None])
        dq = torch.where(go[:, i][:, None, None, None],
                         dq + mm3(ds, kt, bn // 8), dq)

    # dk, dv: every key row at once (own tiles side by side), every query
    # tile; rows past Tq carry zeros (m = 1/l = delta = 0 there)
    kb = key_bias(mask, 0, tk)[:, None, :, None]  # [B, 1, Tk, 1]
    dk, dv = torch.zeros(kh.shape), torch.zeros(kh.shape)
    for i0 in range(0, tq, bn):
        qt, dot = tile_rows(qh, i0, bn), tile_rows(doh, i0, bn)
        mt, ilt, dlt = (tile_rows(x[..., None], i0, bn)[..., 0][:, :, None, :]
                        for x in (m, il, delta))
        st = mm3(kh, qt.transpose(2, 3), steps)  # S^T [B, H, Tk, bn]
        dpt = mm3(vh, dot.transpose(2, 3), steps)
        pt = torch.exp2(st * c + kb - mt) * ilt
        dst = pt * (dpt - dlt)
        dv = dv + mm3(pt, dot, bn // 8)
        dk = dk + mm3(dst, qt, bn // 8)
    # the skip rule: an own tile whose keys are all masked, in a batch row
    # with a valid key, writes zeros
    for b in range(mask.shape[0]):
        for k0 in range(0, tk, own):
            if mask[b].any() and not mask[b, k0:k0 + own].any():
                dk[b, :, k0:k0 + own] = 0
                dv[b, :, k0:k0 + own] = 0
    return tuple(a.transpose(1, 2) for a in (dq * scale, dk * scale, dv))


def make_inputs(t: int, d: int, seed: int):
    """q, k, v, do [4, t, 2, d] float32 numpy; v has mean 1.5, so that an
    all-masked row's average would show a zero-filled key past T."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(4, t, 2, d).astype(np.float32)
                   for _ in range(4))
    return q, k, v + np.float32(1.5), do


def assert_within(got, want, atol, rtol=0.0):
    got = got.double()
    want = torch.from_numpy(np.asarray(want, np.float64))
    assert torch.isfinite(got).all()
    diff = (got - want).abs()
    lim = atol + rtol * want.abs()
    assert (diff <= lim).all(), f"max diff {diff.max().item()}, worst " \
        f"share of the limit {(diff / lim).max().item()}"


def _bhtd(a):
    return a.transpose(0, 2, 1, 3)


@pytest.mark.parametrize("x", [
    np.float32(1.0 + 2 ** -11),          # a tie: away from zero
    np.float32(-(1.0 + 3 * 2 ** -11)),   # a tie below zero: away
    np.float32(1.0 + 2 ** -11 - 2 ** -23),  # just below a tie: down
    np.float32(2 - 2 ** -23)])           # carries into the exponent
def test_tf32_round_is_nearest_ties_away(x):
    """tf32_round against float64 arithmetic: to the nearest multiple of
    the TF32 ulp at x's exponent, ties away from zero."""
    got = float(tf32_round(torch.tensor([x]))[0])
    xf = float(x)
    ulp = 2.0 ** (np.floor(np.log2(abs(xf))) - 10)
    want = np.sign(xf) * np.floor(abs(xf) / ulp + 0.5) * ulp
    assert got == want


def test_split_covers_float32():
    """hi and lo are TF32 (13 low bits clear) and hi + lo is x to within
    2^-21 |x| over magnitudes from 1e-30 to 1e30, both signs."""
    rng = np.random.RandomState(0)
    x = (rng.uniform(1, 2, 100_000) * 10.0 ** rng.uniform(-30, 30, 100_000)
         * rng.choice([-1, 1], 100_000)).astype(np.float32)
    hi, lo = split(torch.from_numpy(x))
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    rest = (torch.from_numpy(x).double() - hi.double() - lo.double()).abs()
    rest = rest.numpy()
    assert (rest <= 2.0 ** -21 * np.abs(x.astype(np.float64))).all()


@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("t,kind", CASES)
def test_forward_schedule_matches_jax(t, kind, d):
    q, k, v, _ = make_inputs(t, d, seed=3 * t + d)
    mask = make_mask(t, kind)
    scale = d ** -0.5
    tm = torch.from_numpy(mask)
    got, stats = emulate_fwd(*(torch.from_numpy(a) for a in (q, k, v)), tm,
                             scale)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ref = jattn.attention_xla_bthd(jq, jk, jv, jnp.asarray(mask), scale)
    assert_within(got, ref, F32_ATOL)
    ref_bhtd = jattn.attention_xla(*(jnp.asarray(_bhtd(a)) for a in
                                     (q, k, v)), jnp.asarray(mask), scale)
    assert_within(got, _bhtd(np.asarray(ref_bhtd)), F32_ATOL)
    # the statistics the forward writes under grad
    want = tattn.attention_stats_plain(*(torch.from_numpy(a) for a in (q, k)),
                                       tm, scale)
    assert_within(stats, want, STATS_TOL, STATS_TOL)
    # the all-masked batch row averages its in-range values uniformly
    assert_within(got[3], np.broadcast_to(v[3].mean(0, keepdims=True),
                                          v[3].shape), F32_ATOL)


@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("t,kind", CASES)
def test_backward_schedule_matches_jax_vjp(t, kind, d):
    q, k, v, do = make_inputs(t, d, seed=5 * t + d)
    mask = make_mask(t, kind)
    scale = d ** -0.5
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tm = torch.from_numpy(mask)
    o, stats = emulate_fwd(tq, tk, tv, tm, scale)
    got = emulate_bwd(tq, tk, tv, tm, tdo, scale, o, stats)
    jm = jnp.asarray(mask)
    _, vjp = jax.vjp(lambda a, b, c: jattn.attention_xla_bthd(a, b, c, jm,
                                                              scale),
                     *(jnp.asarray(a) for a in (q, k, v)))
    for g, w in zip(got, vjp(jnp.asarray(do))):
        assert_within(g, w, F32_ATOL, F32_RTOL)
    if t == 999:  # the [B, H, T, D] function too
        _, vjp = jax.vjp(lambda a, b, c: jattn.attention_xla(a, b, c, jm,
                                                             scale),
                         *(jnp.asarray(_bhtd(a)) for a in (q, k, v)))
        for g, w in zip(got, vjp(jnp.asarray(_bhtd(do)))):
            assert_within(g, _bhtd(np.asarray(w)), F32_ATOL, F32_RTOL)
