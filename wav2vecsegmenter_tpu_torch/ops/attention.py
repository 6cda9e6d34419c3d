"""Multi-head self-attention over key-padded windows.

Counterpart of ``wav2vecsegmenter_tpu/ops/attention.py``:

* ``attention_packed(proj [B,T,3H], key_mask, num_heads, scale)`` replaces
  the Pallas ``_attn_fwd_packed_kernel`` (the encoder's attention, straight
  off the fused QKV projection);
* ``attention_bthd(q, k, v [B,T,H,D], key_mask, scale)`` replaces
  ``_attn_fwd_kernel`` (the SFC head's attention, and the autoregressive
  segmenter's encoder and cross-attention, whose queries and keys differ
  in length).

Both launch the strided CUDA kernels of ``csrc/attention.cu`` on CUDA
tensors, reading the operands where they lie (no head transposes), and run
the plain versions on CPU tensors: bf16 on the tensor cores by ``wgmma``
(operands by TMA), float32 on the tensor cores by ``mma.sync`` in split
TF32 (three TF32 products a product, float32's accuracy; operands by
``cp.async``), so q, k and v need 16-byte-aligned starts and strides of
whole 16-byte units.  The source file says what bounds the kernels on the
H100 and how their designs answer that.  The
forward and the backward take head dims 64, 96 (the SFC head of a base
model: 768 / 8) and 128.

Where a gradient is needed, ``attention_qkv`` (the QKV projection viewed
[B, T, 3, H, D]) goes through ``_AttentionFn``, the
counterpart of the JAX custom VJP ``_fused_attention``: its forward is the
kernel above, its backward ``attention_bwd``, which replaces
``_attn_bwd_kernel`` (K10, ``csrc/attention_bwd.cu``: ``wgmma`` tensor
cores fed by TMA in bf16, split-TF32 ``mma.sync`` in float32) on CUDA
tensors and runs ``attention_bwd_plain`` on CPU tensors.  Under grad the
forward kernel also writes each query row's softmax statistics
(``attention_stats_plain`` is their plain version) and the Function hands
them and the output to the backward, which then needs no sweep of its own
for them.  The Function takes the
packed projection, so K10 writes dq, dk and dv straight into one
[B, T, 3, H, D] gradient.  The SFC head trains through ``attention_qkv``
and the encoder through ``attention_packed``, whose grad branch takes the
same Function on its projection viewed [B, T, 3, H, D] (its gradient is
then the packed [B, T, 3H] one as it lies; the launch keeps the counter
``attention_packed``).  Cross-attention (queries of another length than
the keys: the autoregressive decoder's queries over the encoder memory)
goes through ``attention_cross(q [B, Tq, H, D], kv [B, Tk, 2, H, D])``,
whose grad branch is ``_CrossAttentionFn``: the same forward and backward
kernels, K10 writing dq and a packed dkv.  While the span recorder is on
(``core.trace``) both Functions' backward is the span
``ops.attention.bwd``, which carries its forward call's shape (``b``,
``t_q``, ``t_k``, ``heads``, ``d``) and its key mask (``key_mask``: each
row's valid key count is its sum), so that a roofline can follow the op
whatever implements it.  ``attention_bthd``'s grad
branch stacks k and v into one copy for it and exists to keep the JAX
function's differentiable signature at every shape (its tests use it).

Key padding: ``key_mask`` [B, T] bool, True = valid.  A padded key scores
``NEG_INF`` = -1e30 (not -inf), so a row whose keys are all masked gets a
finite uniform average; padded query rows carry finite garbage that callers
zero with the output mask.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import trace
from . import _build, backend

NEG_INF = -1e30
LOG2E = 1.4426950408889634

backend.register_kernel("attention_packed")
backend.register_kernel("attention_bthd")
backend.register_kernel("attention_bwd")


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


def attention_stats_plain(q: torch.Tensor, k: torch.Tensor,
                          key_mask: torch.Tensor | None,
                          scale: float) -> torch.Tensor:
    """The softmax statistics the forward kernel writes under grad:
    [B, H, Tq, 2] float32, per query row its largest score in log2 units,
    m = max_j s_j with s_j = q.k_j * scale * log2 e + bias_j (bias_j 0 or
    -1e30, as the kernel adds it), and l = sum_j exp2(s_j - m), so that
    P_ij = exp2(s_ij - m_i) / l_i."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        scale * LOG2E)
    if key_mask is not None:
        s = s + torch.where(key_mask[:, None, None, :], 0.0, NEG_INF)
    m = s.amax(dim=-1)
    return torch.stack([m, torch.exp2(s - m[..., None]).sum(-1)], -1)


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


def _chunk_aligned(a: torch.Tensor) -> bool:
    """What the kernels' tile loads (TMA in bf16, ``cp.async`` in float32)
    need of an operand: a 16-byte-aligned start and (batch, time, head)
    strides of whole 16-byte units."""
    return a.data_ptr() % 16 == 0 and all(
        s * a.element_size() % 16 == 0 for s in a.stride()[:3])


def _launch(q, k, v, key_mask, scale, out, name: str,
            stats=None) -> torch.Tensor:
    """Launch the forward kernel into ``out``; ``stats``, when given, is a
    contiguous [B, H, Tq, 2] float32 tensor that gets each query row's
    (m, l) (``attention_stats_plain``)."""
    b, tq, heads, d = q.shape
    tk = k.shape[1]
    if d not in (64, 96, 128):
        raise ValueError(f"attention kernel takes head dims 64, 96 or 128, "
                         f"got {d}")
    if k.shape != (b, tk, heads, d) or v.shape != k.shape:
        raise ValueError("attention kernel: q/k/v shapes disagree")
    for a in (q, k, v, out):
        if a.stride(-1) != 1 or a.device != q.device or a.dtype != q.dtype:
            raise ValueError("attention kernel takes operands on one device, "
                             "of one type, with the head dim contiguous")
    if not all(_chunk_aligned(a) and (heads == 1 or a.stride(2) >= d)
               for a in (q, k, v)):
        raise ValueError("the attention kernel reads q, k and v in 16-byte "
                         "chunks: each needs a 16-byte-aligned start, "
                         "strides of whole 16-byte units and heads that do "
                         "not overlap")
    if stats is not None and (
            stats.shape != (b, heads, tq, 2) or stats.dtype != torch.float32
            or not stats.is_contiguous() or stats.device != q.device):
        raise ValueError("the forward's statistics go into a contiguous "
                         "[B, H, Tq, 2] float32 tensor on q's device")
    mask = _device_mask(key_mask, b, tk, q.device)
    lib = _build.library()
    status = lib.w2v_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        None if stats is None else stats.data_ptr(), b, tq, tk, heads, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        float(scale), _build.dtype_code(q.dtype),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, name)
    backend.count_launch(name)
    return out


def _device_mask(key_mask, b: int, tk: int, device):
    """The key mask as [B, T_k] bytes on the device (kept alive by the
    caller's reference until the launch is queued), or None."""
    if key_mask is None:
        return None
    if key_mask.shape != (b, tk):
        raise ValueError("key_mask must be [B, T_k]")
    return key_mask.to(device=device, dtype=torch.bool).contiguous()


def _attention_bthd(q, k, v, key_mask, scale, with_stats: bool = False,
                    name: str = "attention_bthd"):
    """The forward on the kernel or the plain path (the kernel's launch
    counted as ``name``); with ``with_stats`` -> (out, stats), stats the
    kernel's [B, H, Tq, 2] statistics, None on the plain path (the plain
    backward recomputes its own)."""
    if not backend.use_kernel(q):
        out = attention_bthd_plain(q, k, v, key_mask, scale)
        return (out, None) if with_stats else out
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    stats = None
    if with_stats:
        b, tq, heads, _ = q.shape
        stats = torch.empty((b, heads, tq, 2), dtype=torch.float32,
                            device=q.device)
    _launch(q, k, v, key_mask, scale, out, name, stats)
    return (out, stats) if with_stats else out


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_mask: torch.Tensor | None, do: torch.Tensor,
                        scale: float):
    """``_attn_bwd_kernel``'s arithmetic -> (dq, dk, dv) in q's type.

    P is recomputed in float32 from Q and K with the -1e30 key bias and
    normalised, then P and dS = P (dP - rowsum(dP P)) are cast to the
    input type before their products; the products accumulate in float32
    and dq, dk, dv are cast to the input type at the end.  This follows the
    JAX backward, which rounds the *normalised* P; the forward kernels round
    the unnormalised probabilities (``attention_bthd_plain``)."""
    dt = q.dtype
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.to(dt).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if key_mask is not None:
        s = s + torch.where(key_mask[:, None, None, :], 0.0, NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  key_mask: torch.Tensor | None, do: torch.Tensor,
                  scale: float, o: torch.Tensor | None = None,
                  stats: torch.Tensor | None = None, out=None):
    """(dq, dk, dv) of ``attention_bthd`` from the output gradient ``do``
    [B, T, H, D]; ``out``, when given, is the (dq, dk, dv) destination
    (views allowed, head dim contiguous).  The kernels take the forward's
    output ``o`` and statistics ``stats`` (``_attention_bthd`` with
    ``with_stats``); the plain version recomputes what it needs and takes
    neither."""
    if not backend.use_kernel(q):
        grads = attention_bwd_plain(q, k, v, key_mask, do, scale)
        if out is None:
            return grads
        for dst, src in zip(out, grads):
            dst.copy_(src)
        return out
    return _launch_bwd(q, k, v, key_mask, do, scale, o, stats, out)


def _launch_bwd(q, k, v, key_mask, do, scale, o, stats, out):
    b, tq, heads, d = q.shape
    tk = k.shape[1]
    if d not in (64, 96, 128):
        raise ValueError(f"attention backward kernel takes head dims 64, 96 "
                         f"or 128, got {d}")
    if k.shape != (b, tk, heads, d) or v.shape != k.shape \
            or do.shape != q.shape:
        raise ValueError("attention backward kernel: shapes disagree")
    if o is None or stats is None:
        raise ValueError("the attention backward kernel takes the forward's "
                         "output o and statistics stats")
    if o.shape != q.shape or o.dtype != q.dtype or o.device != q.device \
            or stats.shape != (b, heads, tq, 2) \
            or stats.dtype != torch.float32 \
            or not stats.is_contiguous() or stats.device != q.device:
        raise ValueError("o must be [B, Tq, H, D] in q's type and stats "
                         "a contiguous [B, H, Tq, 2] float32 tensor")
    if o.stride(-1) != 1 or o.data_ptr() % 4 \
            or any(st % 2 for st in o.stride()[:3]):
        o = o.contiguous()
    do = do.to(q.dtype)
    if do.stride(-1) != 1 or not _chunk_aligned(do):
        do = do.contiguous()
    if out is None:
        out = (torch.empty(q.shape, dtype=q.dtype, device=q.device),
               torch.empty(k.shape, dtype=q.dtype, device=q.device),
               torch.empty(k.shape, dtype=q.dtype, device=q.device))
    operands = (q, k, v, do, *out)
    for a in operands:
        if a.stride(-1) != 1 or a.device != q.device or a.dtype != q.dtype:
            raise ValueError("attention backward kernel takes operands on "
                             "one device, of one type, with the head dim "
                             "contiguous")
    if out[0].shape != q.shape or out[1].shape != k.shape \
            or out[2].shape != k.shape:
        raise ValueError("attention backward kernel: out shapes disagree")
    if not all(_chunk_aligned(a) and (heads == 1 or a.stride(2) >= d)
               for a in (q, k, v, do)):
        raise ValueError("the attention backward kernel reads q, k, v and "
                         "do in 16-byte chunks: each needs a 16-byte-aligned "
                         "start, strides of whole 16-byte units and heads "
                         "that do not overlap")
    mask = _device_mask(key_mask, b, tk, q.device)
    strides = (ctypes.c_longlong * 24)(
        *(st for a in (*operands, o) for st in a.stride()[:3]))
    # each query row's (m, 1/l, delta, 0), written by the pre-pass
    rows = torch.empty((b, heads, tq, 4), dtype=torch.float32,
                       device=q.device)
    status = _build.library().w2v_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(), do.data_ptr(),
        *(a.data_ptr() for a in out), o.data_ptr(), stats.data_ptr(),
        rows.data_ptr(),
        ctypes.addressof(strides), b, tq, tk, heads, d, float(scale),
        _build.dtype_code(q.dtype),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "attention_bwd")
    backend.count_launch("attention_bwd")
    return out


def _span_attrs(b: int, t_q: int, t_k: int, heads: int, d: int,
                key_mask) -> dict | None:
    """A call's shape for the span of its backward (``core.trace``), taken
    only while the recorder is on: ``key_mask`` is the call's own tensor
    (None: every key valid), held and not reduced, so that the span
    launches nothing."""
    if not trace.on():
        return None
    return {"b": b, "t_q": t_q, "t_k": t_k, "heads": heads, "d": d,
            "key_mask": key_mask}


def _backward_span(ctx):
    """The span ``ops.attention.bwd`` of a Function's backward, carrying
    the forward call's shape; none where the forward was not recorded."""
    if ctx.span_attrs is None:
        return trace.OFF
    return trace.span("ops.attention.bwd", **ctx.span_attrs)


class _AttentionFn(torch.autograd.Function):
    """Attention on the QKV projection viewed [B, T, 3, H, D], whose
    backward is ``attention_bwd`` (K10 on CUDA) writing one packed
    gradient.  The forward's output and, from the kernel, its statistics
    are saved for the backward."""

    @staticmethod
    def forward(ctx, qkv, key_mask, scale, name):
        out, stats = _attention_bthd(*qkv.unbind(2), key_mask, scale,
                                     with_stats=True, name=name)
        ctx.save_for_backward(qkv, key_mask, out, stats)
        ctx.scale = scale
        b, t, _, heads, d = qkv.shape
        ctx.span_attrs = _span_attrs(b, t, t, heads, d, key_mask)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        qkv, key_mask, out, stats = ctx.saved_tensors
        with _backward_span(ctx):
            dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
            attention_bwd(*qkv.unbind(2), key_mask, do, ctx.scale, out,
                          stats, out=dqkv.unbind(2))
        return dqkv, None, None, None


class _CrossAttentionFn(torch.autograd.Function):
    """Attention of q [B, Tq, H, D] over the packed K/V projection kv
    [B, Tk, 2, H, D] (k, v on dim 2), Tq and Tk free; the backward is
    ``attention_bwd`` writing dq and one packed dkv.  The forward's output
    and, from the kernel, its [B, H, Tq, 2] statistics are saved for the
    backward."""

    @staticmethod
    def forward(ctx, q, kv, key_mask, scale, name):
        out, stats = _attention_bthd(q, *kv.unbind(2), key_mask, scale,
                                     with_stats=True, name=name)
        ctx.save_for_backward(q, kv, key_mask, out, stats)
        ctx.scale = scale
        b, tq, heads, d = q.shape
        ctx.span_attrs = _span_attrs(b, tq, kv.shape[1], heads, d, key_mask)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, kv, key_mask, out, stats = ctx.saved_tensors
        with _backward_span(ctx):
            dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
            dkv = torch.empty(kv.shape, dtype=kv.dtype, device=kv.device)
            attention_bwd(q, *kv.unbind(2), key_mask, do, ctx.scale, out,
                          stats, out=(dq, *dkv.unbind(2)))
        return dq, dkv, None, None, None


def attention_cross(q: torch.Tensor, kv: torch.Tensor,
                    key_mask: torch.Tensor | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Attention of q [B, Tq, H, D] over keys and values packed as kv
    [B, Tk, 2, H, D] (the memory's K/V projection viewed so), key_mask
    [B, Tk] -> [B, Tq, H, D].  Differentiable in q and kv."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if backend.needs_grad(q, kv):
        return _CrossAttentionFn.apply(q, kv, key_mask, scale,
                                       "attention_bthd")
    return _attention_bthd(q, *kv.unbind(2), key_mask, scale)


def attention_qkv(qkv: torch.Tensor, key_mask: torch.Tensor | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """Self-attention on the QKV projection viewed [B, T, 3, H, D] (q, k, v
    on dim 2) -> [B, T, H, D].  Differentiable in qkv."""
    if scale is None:
        scale = qkv.shape[-1] ** -0.5
    if backend.needs_grad(qkv):
        return _AttentionFn.apply(qkv, key_mask, scale, "attention_bthd")
    return _attention_bthd(*qkv.unbind(2), key_mask, scale)


def attention_bthd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   key_mask: torch.Tensor | None = None,
                   scale: float | None = None) -> torch.Tensor:
    """Attention of q [B, Tq, H, D] over k, v [B, Tk, H, D] (views
    allowed) -> [B, Tq, H, D].  Differentiable in q, k and v at every Tq
    and Tk, through :func:`attention_cross` on one stacked copy of k and v
    (the QKV projection goes through :func:`attention_qkv`, and a packed
    K/V through :func:`attention_cross`, without a copy)."""
    if backend.needs_grad(q, k, v):
        return attention_cross(q, torch.stack((k, v), dim=2), key_mask,
                               scale)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _attention_bthd(q, k, v, key_mask, scale)


def attention_packed(proj: torch.Tensor, key_mask: torch.Tensor | None,
                     num_heads: int, scale: float | None = None) -> torch.Tensor:
    """Self-attention straight off the fused QKV projection -> [B, T, H].
    Differentiable in proj."""
    b, t, th = proj.shape
    h = th // 3
    if scale is None:
        scale = (h // num_heads) ** -0.5
    if backend.needs_grad(proj):
        qkv = proj.view(b, t, 3, num_heads, h // num_heads)
        return _AttentionFn.apply(qkv, key_mask, scale,
                                  "attention_packed").reshape(b, t, h)
    if not backend.use_kernel(proj):
        return attention_packed_plain(proj, key_mask, num_heads, scale)
    if not proj.is_contiguous():
        raise ValueError("packed attention kernel takes a contiguous [B,T,3H]")
    q, k, v = _unpack_qkv(proj, num_heads)
    out = torch.empty((b, t, h), dtype=proj.dtype, device=proj.device)
    _launch(q, k, v, key_mask, scale, out.view(b, t, num_heads, h // num_heads),
            "attention_packed")
    return out
