"""The bce head's output layer at inference (ROADMAP C18): the row-local
route of ``ops.rowdot`` against the JAX head's ``h @ w.astype(dt) +
b.astype(dt)``, and its batch invariance.

On the CPU ``row_dot`` runs its plain version, ``_lin``'s matmul; the
kernel's summation order is ``row_dot_ordered`` (one warp a row, lane l
on the 16-byte chunks l, l + 32, ... of the row, a butterfly), which the
card's kernel equals bit for bit in bf16 (``chip_smoke.py``).  The CPU's
float32 matmul is itself not batch-invariant (its blocking follows the
row count), which the kernel's order is.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vecsegmenter_tpu.models.sfc import sfc_forward as jax_sfc_forward
from wav2vecsegmenter_tpu_torch.models import sfc
from wav2vecsegmenter_tpu_torch.models.wav2vec2 import _lin
from wav2vecsegmenter_tpu_torch.ops import backend, rowdot

from .test_torch_ops import kernels_forced  # noqa: F401

H, T = 1024, 999


def _inputs(rows: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, H).astype(np.float32)
    w = (rng.randn(H) * H ** -0.5).astype(np.float32)
    b = np.float32(0.1 * rng.randn())
    return x, w, b


def _bf16_step(v: np.ndarray) -> np.ndarray:
    """One bf16 step (2^-7 of the leading power of two) at |v|."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 2 ** -126))) - 7)


def test_output_layer_equals_jax_float32():
    """float32: row_dot (and the ordered sum) against jnp h @ w + b, to
    1e-6 of the magnitude of the terms summed."""
    x, w, b = _inputs(3 * T)
    want = np.asarray(jnp.asarray(x) @ jnp.asarray(w)[:, None]
                      + jnp.asarray(b)[None])[:, 0]
    scale = np.abs(x) @ np.abs(w) + abs(b)
    xt, wt, bt = (torch.from_numpy(np.asarray(a)) for a in (x, w, [b]))
    for got in (rowdot.row_dot(xt, wt, bt),
                rowdot.row_dot_ordered(xt, wt, bt)):
        assert got.dtype == torch.float32 and got.shape == (3 * T,)
        assert (np.abs(got.numpy() - want) <= 1e-6 * scale).all()


def test_output_layer_equals_jax_bf16():
    """bf16: the dot product rounded to bf16, then the bf16 bias: within
    one bf16 step of the JAX head's rounding (the float32 sums run in
    other orders)."""
    x, w, b = _inputs(2 * T, seed=1)
    bf = jnp.bfloat16
    want = np.asarray((jnp.asarray(x, bf) @ jnp.asarray(w, bf)[:, None]
                       + jnp.asarray([b], bf)).astype(jnp.float32))[:, 0]
    xt, wt, bt = (torch.from_numpy(np.asarray(a)).bfloat16()
                  for a in (x, w, [b]))
    for got in (rowdot.row_dot(xt, wt, bt),
                rowdot.row_dot_ordered(xt, wt, bt)):
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        assert (np.abs(got - want) <= _bf16_step(want)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_order_is_batch_invariant(dtype):
    """A window's logits in the kernel's order are bitwise the same alone
    and in a batch of 8 windows; in bf16 so are the CPU matmul's."""
    x, w, b = _inputs(8 * T, seed=2)
    xt, wt, bt = (torch.from_numpy(np.asarray(a)).to(dtype)
                  for a in (x, w, [b]))
    batched = rowdot.row_dot_ordered(xt.view(8, T, H), wt, bt)
    plain = rowdot.row_dot(xt.view(8, T, H), wt, bt)
    for k in range(8):
        alone = xt.view(8, T, H)[k:k + 1].clone()
        assert torch.equal(rowdot.row_dot_ordered(alone, wt, bt)[0],
                           batched[k])
        if dtype == torch.bfloat16:
            assert torch.equal(rowdot.row_dot(alone, wt, bt)[0], plain[k])


def test_plain_version_is_lins_matmul():
    """On the CPU the route is _lin bitwise, so the CPU path is unchanged."""
    x, w, b = _inputs(50, seed=3)
    lin = torch.nn.Linear(H, 1)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w)[None])
        lin.bias.fill_(float(b))
    for dt in (torch.float32, torch.bfloat16):
        h = torch.from_numpy(x).to(dt).view(2, 25, H)
        with torch.no_grad():
            assert torch.equal(sfc.output_layer(lin, h, dt), _lin(lin, h, dt))


def test_head_routes_the_output_layer(kernels_forced, monkeypatch):
    """The bce head at inference takes row_dot's kernel branch (stood in
    for by the ordered sum, counted); under grad and at V > 1 it takes
    _lin; a CPU tensor never reaches the kernel."""
    calls = []

    def launch(x, w, b):
        calls.append(x.shape)
        backend.count_launch("row_dot")
        return rowdot.row_dot_ordered(x, w, b)

    monkeypatch.setattr(rowdot, "_launch", launch)
    head = sfc.SegmentationFrameClassifier(d_model=64, n_heads=4,
                                           ffn_dim=128)
    wide = sfc.SegmentationFrameClassifier(d_model=64, n_heads=4,
                                           ffn_dim=128, vocab_size=4)
    x = torch.randn(2, 30, 64)
    mask = torch.ones(2, 30, dtype=torch.bool)
    backend.reset_launch_counts()
    with torch.no_grad():
        logits = head(x, mask)
        assert wide(x, mask).shape == (2, 30, 4)
    assert logits.shape == (2, 30) and calls == [(2, 30, 64)]
    assert backend.launch_counts()["row_dot"] == 1
    head(x, mask).sum().backward()  # under grad: _lin
    assert len(calls) == 1 and head.output_layer.weight.grad is not None


def test_head_logits_equal_jax_sfc_forward():
    """The whole bce head on the CPU, float32, against the JAX
    sfc_forward on the same weights, through the output layer's route."""
    import tempfile
    from pathlib import Path

    from .torch_tiny import tiny_pair

    with tempfile.TemporaryDirectory() as tmp:
        _, params, model = tiny_pair(Path(tmp) / "c.pt")
    rng = np.random.RandomState(4)
    x = rng.randn(3, 40, 64).astype(np.float32)
    mask = np.arange(40)[None] < np.array([[40], [23], [1]])
    want = np.asarray(jax_sfc_forward(params["seg"], jnp.asarray(x),
                                      jnp.asarray(mask), n_heads=4))
    with torch.no_grad():
        got = model.seg_model(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy()[mask], want[mask], rtol=2e-4,
                               atol=2e-4)
