"""The tile schedule of the bf16 attention forward kernel, emulated on the
CPU.

The tensor-core kernel of ``ops/csrc/attention.cu`` (``wgmma``) runs only
on the card.  This file writes its schedule out in torch, at the kernel's
own tile sizes (read from the source): query tiles of 128, the key tiles the source picks for each head dim, the head dim
padded with zeros to whole TMA boxes (D=96 computes over 128 columns, as
the kernel's map fills the second box's last 32 with zeros), the online
softmax in log2 units with P rounded to bf16 against the running max, the
two kinds of minus infinity (-1e30 for a masked key in range, -inf for a
zero-filled key past T) and the skip rule (a key tile with no valid key is
skipped unless the batch row has none).  The emulation is held against the
port's plain version and against the JAX package's XLA forward, at T = 999
and 1099 (ragged against every tile) and 1, with prefix masks, masks that
are not prefixes (whole masked tiles among valid ones) and a batch row
whose keys are all masked.  The backward's schedule is in
tests/test_torch_attention_tiles_bwd.py, which takes the shared pieces
(tile sizes, loads, masks, inputs, the forward's schedule and its
statistics) from here.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vecsegmenter_tpu.ops import attention as jattn
from wav2vecsegmenter_tpu_torch.ops import attention as tattn

CSRC = Path(tattn.__file__).resolve().parent / "csrc"
LOG2E = 1.4426950408889634
# One bf16 step at |y| in [4, 8): the limit chip_smoke.py holds the kernels
# to against the plain versions (independent bf16 roundings of one float32
# sum), and for the gradients one more bf16 step of the value on top
# (chip_smoke.BWD_RTOL); the emulations must meet the same limits.
BF16_ATOL = 2 ** -5
BF16_RTOL = 2 ** -7


def constants(name: str) -> dict:
    text = (CSRC / name).read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (kTc\w+) = (\d+);", text)}


FWD = constants("attention.cu")


def fwd_tiles(d: int) -> tuple[int, int]:
    """(query rows, key rows) of a forward tile at head dim d."""
    return FWD["kTcRows"], FWD[f"kTcKeyTile{d}"]


def box_padded(x: torch.Tensor) -> torch.Tensor:
    """x [..., D] with zero columns up to whole TMA boxes of the source's
    width: what the forward's tiles hold past the head dim."""
    d = x.shape[-1]
    return torch.nn.functional.pad(x, (0, -(-d // FWD["kTcBox"])
                                       * FWD["kTcBox"] - d))


def key_tiles(valid: torch.Tensor, bk: int) -> list[int]:
    """w2v_key_tiles: the tiles holding a valid key, or all of them when
    the row has none."""
    n = -(-valid.numel() // bk)
    tiles = [i for i in range(n) if valid[i * bk:(i + 1) * bk].any()]
    return tiles or list(range(n))


def bias(valid: torch.Tensor, k0: int, bk: int) -> torch.Tensor:
    """Key biases of the tile at k0: 0 valid, -1e30 masked, -inf past T."""
    t = valid.numel()
    j = torch.arange(k0, k0 + bk)
    inside = torch.where(valid[j.clamp(max=t - 1)], 0.0, -1e30)
    return torch.where(j < t, inside, -torch.inf)


def rows(x: torch.Tensor, r0: int, n: int) -> torch.Tensor:
    """Rows [r0, r0 + n) of x [T, H, ...] as float32 [H, n, ...], rows past
    T zero (the TMA zero fill)."""
    out = torch.zeros(x.shape[1], n, *x.shape[2:])
    part = x[r0:r0 + n].float().transpose(0, 1)
    out[:, :part.shape[1]] = part
    return out


def stack_tiles(x: torch.Tensor, n: int) -> torch.Tensor:
    """x [T, H, ...] as the tiles of n rows along T, stacked [tiles, H, n,
    ...] in float32, rows past T zero: the blocks of a grid that run side
    by side, emulated as one batched product a step."""
    return torch.stack([rows(x, r0, n) for r0 in range(0, x.shape[0], n)])


def emulate_fwd(q, k, v, mask, scale, with_stats=False):
    """attn_fwd_tc_kernel's schedule -> [B, T, H, D] in q's type; with
    ``with_stats`` also the [B, H, T, 2] (m, l) it writes under grad.
    Every query tile of a batch row at once, over the key tiles in order."""
    b, t, h, d = q.shape
    bq, bk = fwd_tiles(d)
    q, k, v = (box_padded(a) for a in (q, k, v))
    c = scale * LOG2E
    out = torch.empty(b, t, h, d)
    stats = torch.empty(b, h, t, 2)
    for bi in range(b):
        valid = mask[bi]
        qt = stack_tiles(q[bi], bq)  # [tiles, H, bq, DP]
        m = torch.full((*qt.shape[:3], 1), -1e30)
        l = torch.zeros(*qt.shape[:3], 1)
        o = torch.zeros(qt.shape)
        for i in key_tiles(valid, bk):
            kt, vt = rows(k[bi], i * bk, bk), rows(v[bi], i * bk, bk)
            s = qt @ kt.transpose(1, 2) * c + bias(valid, i * bk, bk)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha + p.to(torch.bfloat16).float() @ vt
            m = m_new
        out[bi] = (o / l).transpose(1, 2).reshape(-1, h, o.shape[-1])[
            :t, :, :d]
        stats[bi] = torch.cat([m, l], -1).transpose(0, 1).reshape(
            h, -1, 2)[:, :t]
    out = out.to(q.dtype)
    return (out, stats) if with_stats else out


def make_mask(t: int, kind: str) -> np.ndarray:
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


def make_inputs(t: int, d: int, seed: int):
    """q, k, v, do [4, t, 2, d] in bf16; v has mean 1.5, so that an
    all-masked row's average would show a zero-filled key past T counted in
    (at T = 1099 and 1 it moves the average by more than BF16_ATOL)."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(4, t, 2, d).astype(np.float32) for _ in range(4))
    return [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v + 1.5, do)]


def assert_close(got, want, atol, rtol=0.0):
    if not isinstance(want, torch.Tensor):
        want = torch.from_numpy(np.array(want, np.float32))
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    diff = (got - want).abs()
    lim = atol + rtol * want.abs()
    assert (diff <= lim).all(), f"max diff {diff.max().item()}"


CASES = [(999, "prefix"), (1099, "scattered"), (1, "prefix")]


@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("t,kind", CASES)
def test_forward_schedule_matches_plain_and_jax(t, kind, d):
    q, k, v, _ = make_inputs(t, d, seed=t + d)
    mask = torch.from_numpy(make_mask(t, kind))
    scale = d ** -0.5
    got = emulate_fwd(q, k, v, mask, scale)
    # every row, padded query rows too: the kernel never skips a query tile
    assert_close(got, tattn.attention_bthd_plain(q, k, v, mask, scale),
                 BF16_ATOL)
    jq, jk, jv = (jnp.asarray(a.float().numpy(), jnp.bfloat16)
                  for a in (q, k, v))
    ref = jattn.attention_xla_bthd(jq, jk, jv, jnp.asarray(mask.numpy()),
                                   scale)
    assert_close(got, np.asarray(ref.astype(jnp.float32)), BF16_ATOL)
    # the all-masked batch row averages its in-range values uniformly
    want = v[3].float().mean(0, keepdim=True).expand(t, -1, -1)
    assert_close(got[3], want, BF16_ATOL)
