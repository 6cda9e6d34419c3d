"""Int8 (w8a8) inference for the encoder's products: ``runtime.quantize=int8``.

Counterpart of ``wav2vecsegmenter_tpu/ops/quant.py``, the same scheme:

* weights: quantized once, when the engine is built (:func:`quantize_layers`),
  to int8 with one float32 scale per output channel (max |w| over the
  input dim, / 127, clamped at 1e-12);
* activations: quantized inside the forward, one scale per row (max |x|
  over the input dim, / 127, clamped at 1e-30), rounded half to even;
* the product: int8 x int8 -> int32 (``torch._int_mm``), then
  ``y * sx * qs`` in float32, in that order.

The JAX package computes the product as an XLA dot, outside any Pallas
kernel, so this module is plain PyTorch: no hand kernel.  On CUDA
``_int_mm`` takes more than 16 rows and inner and output widths that are
multiples of 8; a product outside those raises (there is no float
fallback).  Every encoder product of the segment and online paths has
B·T >= 999 rows and widths of 1024, 3072 or 4096.

Quantized are the transformer layers' products: the fused QKV (the three
weights quantized apiece, their scales concatenated), the attention output
and the FFN's w1 and w2.  LayerNorms, the attention core, the conv stack,
the positional conv, adapters and the SFC head stay in the compute dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# the symmetric int8 range: +-127 keeps the grid symmetric (no -128)
_QMAX = 127.0
_INV_QMAX = float(torch.tensor(1.0 / _QMAX, dtype=torch.float32))


class QLinear(NamedTuple):
    """A quantized linear layer: int8 ``qw`` [out, in] (``nn.Linear``
    layout), float32 ``qs`` [out], the float32 ``bias`` [out]."""
    qw: torch.Tensor
    qs: torch.Tensor
    bias: torch.Tensor


def quantize_linear(weight: torch.Tensor, bias: torch.Tensor) -> QLinear:
    """``nn.Linear`` weight [out, in] and bias -> :class:`QLinear`, one
    scale per output channel; ``qw`` is the JAX ``qw`` [in, out]
    transposed."""
    w = weight.detach().float()
    s = (w.abs().amax(dim=1, keepdim=True) / _QMAX).clamp_min(1e-12)
    qw = torch.clamp(torch.round(w / s), -_QMAX, _QMAX).to(torch.int8)
    return QLinear(qw, s.squeeze(1), bias.detach().float())


def dequantize_linear(q: QLinear) -> tuple[torch.Tensor, torch.Tensor]:
    """(weight [out, in] float32, bias): the inverse of
    :func:`quantize_linear` up to rounding."""
    return q.qw.float() * q.qs[:, None], q.bias


def is_quantized(layers) -> bool:
    """Whether ``layers`` is a table of :func:`quantize_layers`."""
    return bool(layers) and all(isinstance(q, QLinear)
                                for layer in layers for q in layer.values())


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [rows, in] (any float dtype) -> (int8 [rows, in], float32 row
    scales [rows, 1]); an all-zero row quantizes to zeros."""
    xf = x.float()
    # times the float32 reciprocal of 127, not divided by 127: XLA rewrites
    # the JAX division by a constant so inside the jitted forward
    sx = (xf.abs().amax(dim=-1, keepdim=True) * _INV_QMAX).clamp_min(1e-30)
    xq = torch.clamp(torch.round(xf / sx), -_QMAX, _QMAX).to(torch.int8)
    return xq, sx


def int8_mm(xq: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """int8 [rows, in] x int8 weights [out, in] -> int32 [rows, out]."""
    rows, k = xq.shape
    n = qw.shape[0]
    if xq.is_cuda and (rows <= 16 or k % 8 or n % 8):
        raise ValueError(
            f"int8 product [{rows}, {k}] x [{k}, {n}]: torch._int_mm on "
            "CUDA needs more than 16 rows and widths that are multiples "
            "of 8")
    # qw.t() of the contiguous [out, in] weight is the column-major
    # [in, out] operand _int_mm takes
    return torch._int_mm(xq, qw.t())


def int8_matmul(x: torch.Tensor, qw: torch.Tensor,
                qs: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ int8 weights [out, in] -> float32 [..., out]: the
    activations quantized per row, the int32 product scaled back by the
    row and then the column scales."""
    lead = x.shape[:-1]
    xq, sx = quantize_rows(x.reshape(-1, x.shape[-1]))
    y = int8_mm(xq, qw)
    return (y.float() * sx * qs).reshape(*lead, -1)


def int8_linear(x: torch.Tensor, q: QLinear, dt) -> torch.Tensor:
    """The quantized layer on x: the float32 product cast to ``dt``, then
    the bias added in ``dt`` (the JAX ``_lin``)."""
    return int8_matmul(x, q.qw, q.qs).to(dt) + q.bias.to(dt)


def quantize_layers(encoder) -> list[dict]:
    """One entry per encoder layer of an ``Encoder`` module: ``qkv`` (the
    q, k and v projections quantized apiece and concatenated), ``o``,
    ``w1``, ``w2``, each a :class:`QLinear`.  The module is not changed."""
    out = []
    for layer in encoder.layers:
        attn, ff = layer.attention, layer.feed_forward
        q, k, v = (quantize_linear(m.weight, m.bias)
                   for m in (attn.q_proj, attn.k_proj, attn.v_proj))
        out.append({
            "qkv": QLinear(*(torch.cat(parts) for parts in zip(q, k, v))),
            "o": quantize_linear(attn.out_proj.weight, attn.out_proj.bias),
            "w1": quantize_linear(ff.intermediate_dense.weight,
                                  ff.intermediate_dense.bias),
            "w2": quantize_linear(ff.output_dense.weight,
                                  ff.output_dense.bias)})
    return out
