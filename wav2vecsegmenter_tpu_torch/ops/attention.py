"""Multi-head self-attention over key-padded windows.

Counterpart of ``wav2vecsegmenter_tpu/ops/attention.py``:

* ``attention_packed(proj [B,T,3H], key_mask, num_heads, scale)`` replaces
  the Pallas ``_attn_fwd_packed_kernel`` (the encoder's attention, straight
  off the fused QKV projection);
* ``attention_bthd(q, k, v [B,T,H,D], key_mask, scale)`` replaces
  ``_attn_fwd_kernel`` (the SFC head's attention).

Both launch the one strided CUDA kernel of ``csrc/attention.cu`` on CUDA
tensors, reading the operands where they lie (no head transposes), and run
the plain versions on CPU tensors.  The source file says what bounds the
kernel on the H100 and how its design answers that.

Key padding: ``key_mask`` [B, T] bool, True = valid.  A padded key scores
``NEG_INF`` = -1e30 (not -inf), so a row whose keys are all masked gets a
finite uniform average; padded query rows carry finite garbage that callers
zero with the output mask.
"""

from __future__ import annotations

import torch

from . import _build, backend

NEG_INF = -1e30

backend.register_kernel("attention_packed")
backend.register_kernel("attention_bthd")


def attention_bthd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         key_mask: torch.Tensor | None,
                         scale: float) -> torch.Tensor:
    """Explicit einsums and softmax, float32 statistics.

    The rounding points are the kernels' (the TPU ones' and this
    package's): the unnormalised probabilities are cast to v's type before
    the PV product, which accumulates in float32, and the softmax division
    comes after it.  (``attention_xla_bthd`` rounds the normalised
    probabilities and the PV output instead; in bf16 that differs from the
    kernels by about a bf16 step per element, and the difference grows
    through the encoder's layers.)"""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if key_mask is not None:
        scores = scores + torch.where(key_mask[:, None, None, :], 0.0, NEG_INF)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    out = torch.einsum("bhqk,bkhd->bqhd", e.to(v.dtype).float(), v.float())
    return (out / e.sum(dim=-1).permute(0, 2, 1)[..., None]).to(q.dtype)


def _unpack_qkv(proj: torch.Tensor, num_heads: int):
    b, t, th = proj.shape
    d = th // 3 // num_heads
    qkv = proj.view(b, t, 3, num_heads, d)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # [B, T, H, D] views


def attention_packed_plain(proj: torch.Tensor, key_mask: torch.Tensor | None,
                           num_heads: int, scale: float) -> torch.Tensor:
    b, t, th = proj.shape
    q, k, v = _unpack_qkv(proj, num_heads)
    return attention_bthd_plain(q, k, v, key_mask, scale).reshape(b, t, th // 3)


def _launch(q, k, v, key_mask, scale, out, name: str) -> torch.Tensor:
    b, tq, heads, d = q.shape
    tk = k.shape[1]
    if d not in (64, 128):
        raise ValueError(f"attention kernel takes head dims 64 or 128, got {d}")
    if k.shape != (b, tk, heads, d) or v.shape != k.shape:
        raise ValueError("attention kernel: q/k/v shapes disagree")
    for a in (q, k, v, out):
        if a.stride(-1) != 1 or a.device != q.device or a.dtype != q.dtype:
            raise ValueError("attention kernel takes operands on one device, "
                             "of one type, with the head dim contiguous")
    mask_ptr = None
    if key_mask is not None:
        if key_mask.shape != (b, tk):
            raise ValueError("key_mask must be [B, T_k]")
        key_mask = key_mask.to(device=q.device, dtype=torch.bool).contiguous()
        mask_ptr = key_mask.data_ptr()
    lib = _build.library()
    status = lib.w2v_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
        b, tq, tk, heads, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        float(scale), _build.dtype_code(q.dtype),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, name)
    backend.count_launch(name)
    return out


def attention_bthd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   key_mask: torch.Tensor | None = None,
                   scale: float | None = None) -> torch.Tensor:
    """Self-attention on [B, T, H, D] operands (views allowed) -> [B, T, H, D]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not backend.use_kernel(q):
        return attention_bthd_plain(q, k, v, key_mask, scale)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    return _launch(q, k, v, key_mask, scale, out, "attention_bthd")


def attention_packed(proj: torch.Tensor, key_mask: torch.Tensor | None,
                     num_heads: int, scale: float | None = None) -> torch.Tensor:
    """Self-attention straight off the fused QKV projection -> [B, T, H]."""
    b, t, th = proj.shape
    h = th // 3
    if scale is None:
        scale = (h // num_heads) ** -0.5
    if not backend.use_kernel(proj):
        return attention_packed_plain(proj, key_mask, num_heads, scale)
    if not proj.is_contiguous():
        raise ValueError("packed attention kernel takes a contiguous [B,T,3H]")
    q, k, v = _unpack_qkv(proj, num_heads)
    out = torch.empty((b, t, h), dtype=proj.dtype, device=proj.device)
    _launch(q, k, v, key_mask, scale, out.view(b, t, num_heads, h // num_heads),
            "attention_packed")
    return out
