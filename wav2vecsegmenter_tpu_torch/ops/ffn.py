"""The encoder's feed-forward block: (x·w1 + b1) -> GELU -> ·w2 + b2.

Counterpart of ``wav2vecsegmenter_tpu/ops/ffn.py``: ``ffn`` replaces the
Pallas ``_ffn_kernel`` (K5).  On CUDA tensors it runs the kernels of
``csrc/ffn.cu`` (two launches of one GEMM mainloop, a bias + GELU + cast
epilogue and a bias epilogue: in bf16 ``wgmma`` fed by TMA, which reads x,
the weights and the activation through tensor maps; in float32 ``wgmma`` in
split TF32 fed by ``cp.async``, after one pass splits w1 and w2 into TF32
hi and lo parts in scratch this wrapper allocates; either way x, the
weights and the activation 16-byte aligned; the source says why the
activation is not kept on chip as on the TPU); on CPU tensors the plain
version.  It takes float32 and
bfloat16: the JAX kernel's bf16-only and inference-only gates came from the
TPU's 16 MB scoped-VMEM limit.

Weights are in ``torch.nn.Linear`` layout (w1 [F, H], w2 [H, F]) and are
cast to x's type per call, biases go in as float32.  Rounding points (the
TPU kernel's): both products accumulate in float32, bias and exact GELU act
on the float32 sums, the activation is rounded to x's type before the
second product, the output once at the end.  (``ffn_xla`` rounds the first
product before its bias instead.)

Where a gradient is needed, ``ffn`` goes through ``_FFNFn``, the
counterpart of the JAX custom VJP ``_ffn_fused``: its forward is the above,
and it saves only its inputs (x and the float32 masters), so the [rows, F]
activation is not kept for the backward.  The backward replays
``ffn_composed`` (``ffn_xla``'s dtype-native composition: products in x's
type with float32 accumulation, rounded where ``ffn_xla`` rounds) by hand,
computing only the gradients autograd asks for: with frozen weights it
recomputes the first product and takes dx in two more (three GEMMs), with
trained weights two more for dw1 and dw2.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from . import _build, backend

backend.register_kernel("ffn")


def ffnfuse_enabled() -> bool:
    """Route the encoder FFN through ``ffn`` (default).  ``W2VSEG_FFNFUSE=0``
    restores the separate GEMM chain of the JAX package's A/B arm; read at
    call time."""
    return os.environ.get("W2VSEG_FFNFUSE", "1") == "1"


def ffn_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: float32 products of the
    operands in x's type (exact for bf16), the kernel's rounding points."""
    w1, w2 = w1.to(x.dtype).float(), w2.to(x.dtype).float()
    t = F.linear(x.float(), w1, b1.float())
    g = F.gelu(t).to(x.dtype)
    return F.linear(g.float(), w2, b2.float()).to(x.dtype)


def ffn_composed(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """``ffn_xla``'s composition in x's type: each product accumulates in
    float32 and is rounded to x's type before its bias is added; the GELU
    output is in x's type.  The backward of ``_FFNFn`` replays it."""
    dt = x.dtype
    t = x @ w1.to(dt).t() + b1.to(dt)
    return F.gelu(t) @ w2.to(dt).t() + b2.to(dt)


def _ffn(x, w1, b1, w2, b2):
    if not backend.use_kernel(x):
        return ffn_plain(x, w1, b1, w2, b2)
    return _launch(x, w1, b1, w2, b2)


def _launch(x, w1, b1, w2, b2) -> torch.Tensor:
    h = x.shape[-1]
    f = w1.shape[0]
    if w1.shape != (f, h) or w2.shape != (h, f) or b1.shape != (f,) \
            or b2.shape != (h,):
        raise ValueError("ffn kernel: w1 [F, H], b1 [F], w2 [H, F], b2 [H]")
    if not x.is_contiguous():
        raise ValueError("ffn kernel takes a contiguous input")
    for p in (w1, b1, w2, b2):
        if p.device != x.device:
            raise ValueError("ffn parameters must be on x's device")
    w1 = w1.to(x.dtype).contiguous()
    w2 = w2.to(x.dtype).contiguous()
    b1 = b1.float().contiguous()
    b2 = b2.float().contiguous()
    if x.data_ptr() % 16:
        raise ValueError("ffn kernel takes a 16-byte-aligned input")
    rows = x.numel() // h
    hidden = torch.empty((rows, f), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    # float32: the weights' TF32 hi and lo parts, written by the call
    split = (torch.empty(4 * h * f, dtype=torch.float32, device=x.device)
             if x.dtype == torch.float32 else None)
    status = _build.library().w2v_ffn(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), hidden.data_ptr(), out.data_ptr(),
        None if split is None else split.data_ptr(), rows, h, f,
        _build.dtype_code(x.dtype),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "ffn")
    backend.count_launch("ffn")
    return out


class _FFNFn(torch.autograd.Function):
    """The FFN whose backward replays ``ffn_composed`` from the saved
    inputs (the ``_ffn_fused`` residual contract)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _ffn(x, w1, b1, w2, b2)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w1, b1, w2, b2 = ctx.saved_tensors
        need_x, need_w1, need_b1, need_w2, need_b2 = ctx.needs_input_grad
        dt, h = x.dtype, x.shape[-1]
        x2, g2 = x.reshape(-1, h), g.to(dt).reshape(-1, h)
        w1c, w2c = w1.to(dt), w2.to(dt)
        t = x2 @ w1c.t() + b1.to(dt)
        dx = dw1 = db1 = dw2 = db2 = None
        if need_w2:
            dw2 = (g2.t() @ F.gelu(t)).to(w2.dtype)
        if need_b2:
            db2 = g2.sum(0).to(b2.dtype)
        if need_x or need_w1 or need_b1:
            dt_ = torch.ops.aten.gelu_backward(g2 @ w2c, t)
            if need_x:
                dx = (dt_ @ w1c).view(x.shape)
            if need_w1:
                dw1 = (dt_.t() @ x2).to(w1.dtype)
            if need_b1:
                db1 = dt_.sum(0).to(b1.dtype)
        return dx, dw1, db1, dw2, db2


def ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
        w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """FFN over the last dim of x [..., H]; leading dims are rows.
    Differentiable in x and the parameters."""
    if backend.needs_grad(x, w1, b1, w2, b2):
        return _FFNFn.apply(x, w1, b1, w2, b2)
    return _ffn(x, w1, b1, w2, b2)
