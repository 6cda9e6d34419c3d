"""A row-local dot product: the SFC head's output layer at V = 1.

``row_dot(x, w, b)`` computes ``x @ w + b`` for x [..., H], w [H] and one
bias value, all in the compute type: the dot product in float32, rounded
to the compute type, then the bias added and rounded again (the rounding
points of the JAX head's ``h @ w.astype(dt) + b.astype(dt)``,
``wav2vecsegmenter_tpu/models/sfc.py:133-134``).  On CUDA tensors it runs
the kernel of ``csrc/rowdot.cu``: one warp a row, a float32 sum in an
order fixed by the column alone, so that a window's logit is the same bit
for bit alone and in any batch (ROADMAP C18: cuBLAS at N = 1 reduced in an
order that moved with the batch).  On CPU tensors it runs its plain
version, the matmul of the model's ``_lin``.  ``models/sfc.output_layer``
routes the bce head's output layer here at inference.

``row_dot_ordered`` is the kernel's summation order written in PyTorch:
lane l of 32 takes the 16-byte chunks l, l + 32, ... of the row, sums its
products in column order, and the lanes meet in a butterfly.  In bf16 a
product of two bf16 values is exact in float32, so it gives the kernel's
result bit for bit; the tests and ``chip_smoke.py`` hold the kernel to it.
"""

from __future__ import annotations

import torch

from . import _build, backend

backend.register_kernel("row_dot")

LANES = 32


def row_dot_plain(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """``_lin``'s ops on the same views: one matmul in x's type, then the
    bias."""
    return (x @ w[None, :].t() + b.reshape(1))[..., 0]


def row_dot(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [..., H] . w [H] + b -> [...], in x's type (w and b of that type).
    Autograd records nothing through the kernel: callers under grad take
    the plain version."""
    if not backend.use_kernel(x):
        return row_dot_plain(x, w, b)
    return _launch(x, w, b)


def _launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1]
    vec = 16 // x.element_size()
    if w.shape != (h,) or b.numel() != 1 or w.dtype != x.dtype \
            or b.dtype != x.dtype:
        raise ValueError("row_dot: w must be [h] and b one value, of x's "
                         "type")
    if h % vec:
        raise ValueError(f"row_dot kernel takes rows of whole 16-byte "
                         f"chunks, got h={h} in {x.dtype}")
    x = x.contiguous()
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("row_dot kernel takes 16-byte aligned x and w")
    out = torch.empty(x.shape[:-1], dtype=x.dtype, device=x.device)
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    status = _build.library().w2v_row_dot(
        x.data_ptr(), w.data_ptr(), b.contiguous().data_ptr(),
        out.data_ptr(), x.numel() // h, h, _build.dtype_code(x.dtype), stream)
    _build.check(status, "row_dot")
    backend.count_launch("row_dot")
    return out


def row_dot_ordered(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """The kernel's result from plain PyTorch ops in its order: x [..., H],
    w [H], b one value, all of one type -> [...] in that type."""
    h = x.shape[-1]
    vec = 16 // x.element_size()
    chunks = h // vec
    passes = -(-chunks // LANES)
    prod = (x.float() * w.float()).reshape(-1, chunks, vec)
    prod = torch.nn.functional.pad(prod, (0, 0, 0, passes * LANES - chunks))
    prod = prod.reshape(-1, passes, LANES, vec)
    acc = torch.zeros(prod.shape[0], LANES, device=x.device)
    for p in range(passes):
        for j in range(vec):
            acc = acc + prod[:, p, :, j]
    lane = torch.arange(LANES, device=x.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ o]
    out = acc[:, 0].to(x.dtype) + b.reshape(()).to(x.dtype)
    return out.reshape(x.shape[:-1])
