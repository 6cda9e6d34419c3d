"""The tile schedule of the bf16 attention kernels, emulated on the CPU.

The tensor-core kernels of ``ops/csrc/attention.cu`` (forward, ``wgmma``)
and ``ops/csrc/attention_bwd.cu`` (backward, ``mma.sync``) run only on the
card.  This file writes their schedule out in torch, at the kernels' own
tile sizes (read from the sources): query tiles of 128 (forward) and 64
(backward), the key and streamed tiles the sources pick for each head dim,
the online softmax in log2 units with P rounded to bf16 against the running
max, the two kinds of minus infinity (-1e30 for a masked key in range,
-inf for a zero-filled key past T), the skip rules (a key tile with no
valid key is skipped unless the batch row has none), and the backward's two
passes through the [B, H, T, 3] statistics workspace.  The emulation is
held against the port's plain versions and against the JAX package (the
XLA forward and the Pallas backward in interpret mode), at T = 999 and
1099 (ragged against every tile) and 1, with prefix masks, masks that are
not prefixes (whole masked tiles among valid ones) and a batch row whose
keys are all masked.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from wav2vecsegmenter_tpu.ops import attention as jattn
from wav2vecsegmenter_tpu.ops.backend import set_backend
from wav2vecsegmenter_tpu_torch.ops import attention as tattn

CSRC = Path(tattn.__file__).resolve().parent / "csrc"
LOG2E = 1.4426950408889634
# One bf16 step at |y| in [4, 8): the limit chip_smoke.py holds the kernels
# to against the plain versions (independent bf16 roundings of one float32
# sum), and for the gradients one more bf16 step of the value on top
# (chip_smoke.BWD_RTOL); the emulation must meet the same limits.
BF16_ATOL = 2 ** -5
BF16_RTOL = 2 ** -7


def _constants(name: str) -> dict:
    text = (CSRC / name).read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (kTc\w+) = (\d+);", text)}


FWD = _constants("attention.cu")
BWD = _constants("attention_bwd.cu")


def fwd_tiles(d: int) -> tuple[int, int]:
    """(query rows, key rows) of a forward tile at head dim d."""
    return FWD["kTcRows"], FWD[f"kTcKeyTile{d}"]


def bwd_tiles(d: int) -> tuple[int, int]:
    """(own rows, streamed rows) of a backward tile at head dim d."""
    return BWD["kTcRows"], BWD[f"kTcStream{d}"]


def key_tiles(valid: torch.Tensor, bk: int) -> list[int]:
    """w2v_key_tiles: the tiles holding a valid key, or all of them when
    the row has none."""
    n = -(-valid.numel() // bk)
    tiles = [i for i in range(n) if valid[i * bk:(i + 1) * bk].any()]
    return tiles or list(range(n))


def _bias(valid: torch.Tensor, k0: int, bk: int) -> torch.Tensor:
    """Key biases of the tile at k0: 0 valid, -1e30 masked, -inf past T."""
    t = valid.numel()
    j = torch.arange(k0, k0 + bk)
    inside = torch.where(valid[j.clamp(max=t - 1)], 0.0, -1e30)
    return torch.where(j < t, inside, -torch.inf)


def _rows(x: torch.Tensor, r0: int, n: int) -> torch.Tensor:
    """Rows [r0, r0 + n) of x [T, H, D] as float32 [H, n, D], rows past T
    zero (the TMA / cp.async zero fill)."""
    out = torch.zeros(x.shape[1], n, x.shape[2])
    part = x[r0:r0 + n].float().transpose(0, 1)
    out[:, :part.shape[1]] = part
    return out


def emulate_fwd(q, k, v, mask, scale):
    """attn_fwd_tc_kernel's schedule -> [B, T, H, D] in q's type."""
    b, t, h, d = q.shape
    bq, bk = fwd_tiles(d)
    c = scale * LOG2E
    out = torch.empty(b, t, h, d)
    for bi in range(b):
        valid = mask[bi]
        tiles = key_tiles(valid, bk)
        for q0 in range(0, t, bq):
            qt = _rows(q[bi], q0, bq)
            m = torch.full((h, bq, 1), -1e30)
            l = torch.zeros(h, bq, 1)
            o = torch.zeros(h, bq, d)
            for i in tiles:
                kt, vt = _rows(k[bi], i * bk, bk), _rows(v[bi], i * bk, bk)
                s = qt @ kt.transpose(1, 2) * c + _bias(valid, i * bk, bk)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                o = o * alpha + p.to(torch.bfloat16).float() @ vt
                m = m_new
            rows = min(bq, t - q0)
            out[bi, q0:q0 + rows] = (o / l).transpose(0, 1)[:rows]
    return out.to(q.dtype)


def emulate_bwd(q, k, v, mask, do, scale):
    """attn_bwd_dq_tc_kernel then attn_bwd_dkdv_tc_kernel -> (dq, dk, dv)
    in q's type; the statistics pass between them through a [B, H, T, 3]
    workspace, as on the card."""
    b, t, h, d = q.shape
    rows_, bn = bwd_tiles(d)
    c = scale * LOG2E
    rnd = lambda x: x.to(torch.bfloat16).float()
    dq, dk, dv = (torch.empty(b, t, h, d) for _ in range(3))
    stats = torch.empty(b, h, t, 3)
    for bi in range(b):
        valid = mask[bi]
        tiles = key_tiles(valid, bn)
        # kernel 1: per query tile, sweep 1 (m, l, sum of exp * dP) and
        # sweep 2 (dS, dq) over the same key tiles
        for q0 in range(0, t, rows_):
            qt, dot = _rows(q[bi], q0, rows_), _rows(do[bi], q0, rows_)
            m = torch.full((h, rows_, 1), -1e30)
            l = torch.zeros(h, rows_, 1)
            dsum = torch.zeros(h, rows_, 1)
            for i in tiles:
                kt, vt = _rows(k[bi], i * bn, bn), _rows(v[bi], i * bn, bn)
                s = qt @ kt.transpose(1, 2) * c + _bias(valid, i * bn, bn)
                dp = dot @ vt.transpose(1, 2)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                dsum = dsum * alpha + (p * dp).sum(-1, keepdim=True)
                m = m_new
            delta = dsum / l
            acc = torch.zeros(h, rows_, d)
            for i in tiles:
                kt, vt = _rows(k[bi], i * bn, bn), _rows(v[bi], i * bn, bn)
                s = qt @ kt.transpose(1, 2) * c + _bias(valid, i * bn, bn)
                dp = dot @ vt.transpose(1, 2)
                p = torch.exp2(s - m) / l
                acc = acc + rnd(p * (dp - delta)) @ kt
            n = min(rows_, t - q0)
            dq[bi, q0:q0 + n] = (acc * scale).transpose(0, 1)[:n]
            stats[bi, :, q0:q0 + n] = torch.cat([m, l, delta], -1)[:, :n]
        # kernel 2: per key tile, zeros where the skip rule holds, else a
        # sweep over every query tile
        row_any = bool(valid.any())
        for k0 in range(0, t, rows_):
            n = min(rows_, t - k0)
            if row_any and not valid[k0:k0 + n].any():
                dk[bi, k0:k0 + n] = 0.0
                dv[bi, k0:k0 + n] = 0.0
                continue
            kt, vt = _rows(k[bi], k0, rows_), _rows(v[bi], k0, rows_)
            bias = _bias(valid, k0, rows_)[None, :, None]
            ka, va = torch.zeros(h, rows_, d), torch.zeros(h, rows_, d)
            for i0 in range(0, t, bn):
                qt, dot = _rows(q[bi], i0, bn), _rows(do[bi], i0, bn)
                st = torch.zeros(h, bn, 3)
                st[:, :min(bn, t - i0)] = stats[bi, :, i0:i0 + bn]
                inside = (torch.arange(i0, i0 + bn) < t)[None, None, :]
                s = kt @ qt.transpose(1, 2) * c + bias
                dpt = vt @ dot.transpose(1, 2)
                p = torch.exp2(s - st[..., 0][:, None, :]) \
                    / st[..., 1][:, None, :]
                p = torch.where(inside, p, 0.0)
                ds = torch.where(inside, p * (dpt - st[..., 2][:, None, :]),
                                 0.0)
                va = va + rnd(p) @ dot
                ka = ka + rnd(ds) @ qt
            dk[bi, k0:k0 + n] = (ka * scale).transpose(0, 1)[:n]
            dv[bi, k0:k0 + n] = va.transpose(0, 1)[:n]
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _mask(t: int, kind: str) -> np.ndarray:
    """[4, t]: a full row, a ragged row, a 1-frame row, and a batch-padding
    row with every key masked.  ``scattered``: the ragged row holds two
    islands of valid keys with whole masked tiles between them, and the
    1-frame row's valid key sits mid-window."""
    m = np.zeros((4, t), bool)
    m[0] = True
    m[1, : max(1, t // 2 + 7)] = True
    m[2, 0] = True
    if kind == "scattered":
        m[1] = False
        m[1, 3:90] = True
        m[1, 600:700] = True
        m[2] = False
        m[2, t // 2] = True
    return m


def _inputs(t: int, d: int, seed: int):
    """q, k, v, do [4, t, 2, d] in bf16; v has mean 1.5, so that an
    all-masked row's average would show a zero-filled key past T counted in
    (at T = 1099 and 1 it moves the average by more than BF16_ATOL)."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(4, t, 2, d).astype(np.float32) for _ in range(4))
    return [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v + 1.5, do)]


def _assert_close(got, want, atol, rtol=0.0):
    if not isinstance(want, torch.Tensor):
        want = torch.from_numpy(np.array(want, np.float32))
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    diff = (got - want).abs()
    lim = atol + rtol * want.abs()
    assert (diff <= lim).all(), f"max diff {diff.max().item()}"


CASES = [(999, "prefix"), (1099, "scattered"), (1, "prefix")]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t,kind", CASES)
def test_forward_schedule_matches_plain_and_jax(t, kind, d):
    q, k, v, _ = _inputs(t, d, seed=t + d)
    mask = torch.from_numpy(_mask(t, kind))
    scale = d ** -0.5
    got = emulate_fwd(q, k, v, mask, scale)
    # every row, padded query rows too: the kernel never skips a query tile
    _assert_close(got, tattn.attention_bthd_plain(q, k, v, mask, scale),
                  BF16_ATOL)
    jq, jk, jv = (jnp.asarray(a.float().numpy(), jnp.bfloat16)
                  for a in (q, k, v))
    ref = jattn.attention_xla_bthd(jq, jk, jv, jnp.asarray(mask.numpy()),
                                   scale)
    _assert_close(got, np.asarray(ref.astype(jnp.float32)), BF16_ATOL)
    # the all-masked batch row averages its in-range values uniformly
    want = v[3].float().mean(0, keepdim=True).expand(t, -1, -1)
    _assert_close(got[3], want, BF16_ATOL)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t,kind", CASES)
def test_backward_schedule_matches_plain_and_jax(t, kind, d):
    q, k, v, do = _inputs(t, d, seed=2 * t + d)
    mask = torch.from_numpy(_mask(t, kind))
    scale = d ** -0.5
    got = emulate_bwd(q, k, v, mask, do, scale)
    want = tattn.attention_bwd_plain(q, k, v, mask, do, scale)
    for g, w in zip(got, want):
        _assert_close(g, w, BF16_ATOL, BF16_RTOL)
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
    for g, w in zip(got, ref):
        _assert_close(g, np.asarray(w.astype(jnp.float32)), BF16_ATOL,
                      BF16_RTOL)


def test_skip_rules():
    """The tiles each kernel visits: a masked tile among valid ones is
    skipped, an all-masked row visits every tile, and the dk/dv tile of an
    all-masked key range in a row with valid keys is zero exactly."""
    mask = torch.from_numpy(_mask(1099, "scattered"))
    _, bk = fwd_tiles(128)
    visits = key_tiles(mask[1], bk)
    assert 0 in visits and 600 // bk in visits
    assert len(visits) < -(-1099 // bk)
    assert key_tiles(mask[3], bk) == list(range(-(-1099 // bk)))
    assert key_tiles(mask[0], bk) == list(range(-(-1099 // bk)))
    q, k, v, do = _inputs(300, 64, seed=5)
    m = torch.zeros(4, 300, dtype=torch.bool)
    m[:, 200:260] = True
    m[3] = False
    dq, dk, dv = emulate_bwd(q, k, v, m, do, 0.125)
    rows, _ = bwd_tiles(64)
    assert (dk[0, :rows] == 0).all() and (dv[0, :rows] == 0).all()
    assert (dv[3] != 0).any()  # the all-masked row still sends gradient
