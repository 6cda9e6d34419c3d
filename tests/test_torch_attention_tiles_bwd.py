"""The schedule of the bf16 attention backward (K10), emulated on the CPU.

The tensor-core kernels of ``ops/csrc/attention_bwd.cu`` (``wgmma``) run
only on the card.  This file writes their schedule out in torch, at their
own tile sizes (read from the ``kTc*`` constants of the source):

* the row statistics (m, l) come from the forward kernel's schedule
  (``emulate_fwd`` of tests/test_torch_attention_tiles_fwd.py), as the forward writes them under
  grad, and the forward's bf16 output o goes with them;
* the pre-pass forms each query row's (m, 1/l, delta) with
  delta = do . o from that bf16 o (the TPU kernel takes
  delta = sum_j P dP from float32 P: these tests are what shows the bf16
  output is precise enough);
* the query-major dq kernel: 128 own query rows, the key tiles the skip
  rule visits, P = exp2(s c + bias - m) / l and dS = T(P (dP - delta)),
  dq += dS K;
* the key-major dk/dv kernel: 128 own key rows, every query tile, the
  statistics broadcast along the tile's columns, dv += T(P^T) dO and
  dk += T(dS^T) Q, zeros for an own tile whose keys are all masked in a
  batch row with a valid key.

The emulation is held against the port's plain backward and against the
JAX package's Pallas backward in interpret mode, at T = 999 and 1099
(ragged against every tile) and 1, with prefix masks, masks that are not
prefixes and a batch row whose keys are all masked.  The own tiles are
stacked (``stack_tiles``) so that each step of the streamed loop is one
batched product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wav2vecsegmenter_tpu.ops import attention as jattn
from wav2vecsegmenter_tpu.ops.backend import set_backend
from wav2vecsegmenter_tpu_torch.ops import attention as tattn

from .test_torch_attention_tiles_fwd import (BF16_ATOL, BF16_RTOL, CASES, LOG2E,
                              assert_close, bias, box_padded, constants,
                              emulate_fwd, fwd_tiles, key_tiles, make_inputs,
                              make_mask, rows, stack_tiles)
from .torch_tiny import threads_per_worker  # noqa: F401

BWD = constants("attention_bwd.cu")
STATS_RTOL = 1e-5  # float32 sums of one set of terms in two orders


def bwd_tiles(d: int) -> tuple[int, int]:
    """(own rows, streamed rows) of a backward tile at head dim d."""
    return BWD["kTcRows"], BWD[f"kTcStream{d}"]


def emulate_pre_pass(o, do, stats) -> torch.Tensor:
    """attn_bwd_rows_kernel: [B, H, T, 3] of (m, 1/l, delta = do . o)."""
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    return torch.stack([stats[..., 0], 1.0 / stats[..., 1], delta], -1)


def emulate_bwd(q, k, v, mask, do, scale, o, stats):
    """The pre-pass, attn_bwd_dq_tc_kernel and attn_bwd_dkdv_tc_kernel ->
    (dq, dk, dv) in q's type; q and do [B, Tq, H, D], k and v [B, Tk, H,
    D].  The operands are padded with zero columns to whole TMA boxes
    (D=96 runs D=128's schedule: its loads fill columns 96-127 with zeros)
    and the outputs keep the first D columns, as the kernels store them."""
    b, t, h, d = q.shape
    tk = k.shape[1]
    own, bn = bwd_tiles(d)
    table = emulate_pre_pass(o, do, stats)
    q, k, v, do = (box_padded(a) for a in (q, k, v, do))
    dp_ = q.shape[-1]
    c = scale * LOG2E
    rnd = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    dq = torch.empty(b, t, h, dp_)
    dk, dv = torch.empty(b, tk, h, dp_), torch.empty(b, tk, h, dp_)
    for bi in range(b):
        valid = mask[bi]
        rw = table[bi].transpose(0, 1)  # [T, H, 3]
        # dq kernel: every CTA of query rows at once, over the key tiles
        qt, dot, st = (stack_tiles(a, own) for a in (q[bi], do[bi], rw))
        m, il, dl = (st[..., i:i + 1] for i in range(3))  # rows past T: 0
        acc = torch.zeros(qt.shape)
        for i in key_tiles(valid, bn):
            kt, vt = rows(k[bi], i * bn, bn), rows(v[bi], i * bn, bn)
            s = qt @ kt.transpose(1, 2) * c + bias(valid, i * bn, bn)
            p = torch.exp2(s - m) * il
            dp = dot @ vt.transpose(1, 2)
            acc = acc + rnd(p * (dp - dl)) @ kt
        dq[bi] = (acc * scale).transpose(1, 2).reshape(-1, h, dp_)[:t]
        # dk/dv kernel: every CTA of key rows at once, over the query tiles
        kt, vt = stack_tiles(k[bi], own), stack_tiles(v[bi], own)
        kb = torch.stack([bias(valid, k0, own)
                          for k0 in range(0, tk, own)])[:, None, :, None]
        ka, va = torch.zeros(kt.shape), torch.zeros(vt.shape)
        for i0 in range(0, t, bn):
            qs, dos = rows(q[bi], i0, bn), rows(do[bi], i0, bn)
            sr = rows(rw, i0, bn)  # [H, bn, 3]; zero rows past T
            m, il, dl = (sr[None, :, None, :, i] for i in range(3))
            s = kt @ qs.transpose(1, 2) * c + kb
            p = torch.exp2(s - m) * il
            ds = p * (vt @ dos.transpose(1, 2) - dl)
            va = va + rnd(p) @ dos
            ka = ka + rnd(ds) @ qs
        dk[bi] = (ka * scale).transpose(1, 2).reshape(-1, h, dp_)[:tk]
        dv[bi] = va.transpose(1, 2).reshape(-1, h, dp_)[:tk]
        if valid.any():  # the skip rule: all-masked own tiles write zeros
            for k0 in range(0, tk, own):
                if not valid[k0:k0 + own].any():
                    dk[bi, k0:k0 + own] = 0.0
                    dv[bi, k0:k0 + own] = 0.0
    return tuple(a[..., :d].to(q.dtype) for a in (dq, dk, dv))


def _jax_bwd(q, k, v, mask, do, scale):
    set_backend("pallas")
    try:
        with pltpu.force_tpu_interpret_mode():
            _, vjp = jax.vjp(
                lambda a, bb, cc: jattn.attention_pallas_bthd(
                    a, bb, cc, jnp.asarray(mask.numpy()), scale),
                *(jnp.asarray(a.float().numpy(), jnp.bfloat16)
                  for a in (q, k, v)))
            ref = vjp(jnp.asarray(do.float().numpy(), jnp.bfloat16))
    finally:
        set_backend("auto")
    return [np.asarray(w.astype(jnp.float32)) for w in ref]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t,kind", CASES)
def test_forward_statistics_match_plain(t, kind, d):
    """The (m, l) the forward kernel writes under grad, by its schedule
    (online over the visited key tiles), against attention_stats_plain;
    the all-masked batch row has m = -1e30 and l = T (uniform P)."""
    q, k, v, _ = make_inputs(t, d, seed=3 * t + d)
    mask = torch.from_numpy(make_mask(t, kind))
    scale = d ** -0.5
    _, stats = emulate_fwd(q, k, v, mask, scale, with_stats=True)
    want = tattn.attention_stats_plain(q, k, mask, scale)
    assert stats.shape == want.shape == (4, 2, t, 2)
    torch.testing.assert_close(stats, want, rtol=STATS_RTOL, atol=1e-6)
    assert (stats[3, ..., 0] == -1e30).all()
    assert (stats[3, ..., 1] == t).all()


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t,kind", CASES)
def test_backward_schedule_matches_plain_and_jax(t, kind, d):
    q, k, v, do = make_inputs(t, d, seed=2 * t + d)
    mask = torch.from_numpy(make_mask(t, kind))
    scale = d ** -0.5
    o, stats = emulate_fwd(q, k, v, mask, scale, with_stats=True)
    got = emulate_bwd(q, k, v, mask, do, scale, o, stats)
    want = tattn.attention_bwd_plain(q, k, v, mask, do, scale)
    for g, w in zip(got, want):
        assert_close(g, w, BF16_ATOL, BF16_RTOL)
    for g, w in zip(got, _jax_bwd(q, k, v, mask, do, scale)):
        assert_close(g, w, BF16_ATOL, BF16_RTOL)


@pytest.mark.parametrize("t,kind", [(1099, "scattered"), (999, "cross")])
def test_backward_schedule_at_head_dim_96(t, kind):
    """A base model's D=96 (D=128's schedule over operands whose last 32
    columns load as zeros).  The SFC head, ragged against every tile, with
    whole masked tiles and an all-masked row: the forward's statistics,
    then the backward against the port's plain backward and the JAX
    package's Pallas backward.  The arseg decoder's cross-attention, 1000
    queries over 999 keys: as test_cross_schedule_within_chip_smoke_limits
    at D=128."""
    if kind == "cross":
        _check_cross(t + 1, t, 96)
        return
    q, k, v, do = make_inputs(t, 96, seed=2 * t + 96)
    mask = torch.from_numpy(make_mask(t, kind))
    scale = 96 ** -0.5
    o, stats = emulate_fwd(q, k, v, mask, scale, with_stats=True)
    torch.testing.assert_close(
        stats, tattn.attention_stats_plain(q, k, mask, scale),
        rtol=STATS_RTOL, atol=1e-6)
    got = emulate_bwd(q, k, v, mask, do, scale, o, stats)
    assert all(g.shape == q.shape for g in got)
    want = tattn.attention_bwd_plain(q, k, v, mask, do, scale)
    for g, w in zip(got, want):
        assert_close(g, w, BF16_ATOL, BF16_RTOL)
    for g, w in zip(got, _jax_bwd(q, k, v, mask, do, scale)):
        assert_close(g, w, BF16_ATOL, BF16_RTOL)


def test_skip_rules():
    """The tiles each kernel visits: a masked tile among valid ones is
    skipped, an all-masked row visits every tile, and the dk/dv tile of an
    all-masked key range in a row with valid keys is zero exactly."""
    mask = torch.from_numpy(make_mask(1099, "scattered"))
    _, bk = fwd_tiles(128)
    visits = key_tiles(mask[1], bk)
    assert 0 in visits and 600 // bk in visits
    assert len(visits) < -(-1099 // bk)
    assert key_tiles(mask[3], bk) == list(range(-(-1099 // bk)))
    assert key_tiles(mask[0], bk) == list(range(-(-1099 // bk)))
    q, k, v, do = make_inputs(300, 64, seed=5)
    m = torch.zeros(4, 300, dtype=torch.bool)
    m[:, 200:260] = True
    m[3] = False
    o, stats = emulate_fwd(q, k, v, m, 0.125, with_stats=True)
    dq, dk, dv = emulate_bwd(q, k, v, m, do, 0.125, o, stats)
    own, _ = bwd_tiles(64)
    assert 200 >= own  # the first own tile holds no valid key
    assert (dk[0, :own] == 0).all() and (dv[0, :own] == 0).all()
    assert (dv[3] != 0).any()  # the all-masked row still sends gradient


@pytest.mark.parametrize("tq,tk", [(1000, 999), (64, 999), (999, 64)])
def test_cross_schedule_within_chip_smoke_limits(tq, tk):
    """The autoregressive decoder's cross-attention (Tq != Tk) through both
    kernels' schedules at D=128, keys of every count down to a few and
    none: the forward and its statistics against the plain versions; the
    backward against attention_bwd_plain within chip_smoke.py's limits of
    its cross rows (the bf16 atol and rtol plus attn_bwd_slack: on a row of
    a few keys dk sums ~Tq large terms, and the two routes' bf16 roundings
    of dS part by more than the self rows' limits)."""
    _check_cross(tq, tk, 128)


def _check_cross(tq: int, tk: int, d: int) -> None:
    """test_cross_schedule_within_chip_smoke_limits at head dim d."""
    import chip_smoke

    rng = np.random.RandomState(tq + tk)
    lengths = [tk, tk // 2, 2, 0, 3, 5, 1, 17]
    q, do = (torch.from_numpy(rng.randn(8, tq, 2, d).astype(np.float32))
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(8, tk, 2, d).astype(np.float32))
            .to(torch.bfloat16) for _ in range(2))
    mask = torch.arange(tk)[None, :] < torch.tensor(lengths)[:, None]
    scale = d ** -0.5
    o, stats = emulate_fwd(q, k, v, mask, scale, with_stats=True)
    assert_close(o, tattn.attention_bthd_plain(q, k, v, mask, scale),
                 BF16_ATOL)
    torch.testing.assert_close(
        stats, tattn.attention_stats_plain(q, k, mask, scale),
        rtol=STATS_RTOL, atol=1e-6)
    got = emulate_bwd(q, k, v, mask, do, scale, o, stats)
    want = tattn.attention_bwd_plain(q, k, v, mask, do, scale)
    slack = chip_smoke.attn_bwd_slack(q, k, v, mask, do, scale)
    for g, w, room in zip(got, want, slack):
        assert g.shape == w.shape
        diff = (g.float() - w.float()).abs()
        assert (diff <= BF16_ATOL + BF16_RTOL * w.float().abs()
                + room).all(), f"max diff {diff.max().item()}"
