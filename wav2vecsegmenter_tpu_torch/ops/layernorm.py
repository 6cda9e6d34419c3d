"""Row LayerNorm and the fused conv epilogue (bias -> LayerNorm -> GELU).

Counterpart of ``wav2vecsegmenter_tpu/ops/layernorm.py``.  ``layer_norm``
replaces the Pallas ``_ln_kernel`` (every LayerNorm of the encoder, the
feature projection and the SFC head); ``bias_layer_norm_gelu`` replaces
``_bln_gelu_kernel`` (the LayerNorm-mode conv layers' epilogue).  Both run
the CUDA kernel of ``csrc/layernorm.cu`` on CUDA tensors and their plain
versions on CPU tensors; the source file says what bounds the kernel on the
H100 and how its design answers that.

Where a gradient is needed, ``layer_norm`` goes through ``_LayerNormFn``
(the counterpart of the JAX custom VJP ``_ln_2d``): its forward is the
above, its backward ``layer_norm_bwd``, which replaces ``_ln_bwd_kernel``
(K9, ``csrc/layernorm_bwd.cu``) on CUDA tensors and runs
``layer_norm_bwd_plain`` on CPU tensors; where autograd asks no gradient of
x (the SFC head's first LayerNorm reads the frozen backbone's output), it
computes no dx.  ``bias_layer_norm_gelu`` has no backward yet and refuses a
grad-requiring input on the kernel path.

Semantics (torch.nn.LayerNorm's): float32 mean and biased variance, eps
inside the rsqrt, float32 scale and bias, the result cast back to the input
type.  The epilogue adds the float32 conv bias in float32, as the TPU
kernel does, and uses the exact erf GELU.
"""

from __future__ import annotations

import functools

import torch

from . import _build, backend

EPS = 1e-5

backend.register_kernel("layer_norm")
backend.register_kernel("bias_layer_norm_gelu")
backend.register_kernel("layer_norm_bwd")
# the layer_norm_bwd launches that wrote no dx (counted beside them)
backend.register_kernel("layer_norm_bwd_no_dx")

MAX_H = 1024          # widest row the kernels take (one warp a row)


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = EPS) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def bias_layer_norm_gelu_plain(x: torch.Tensor, conv_bias: torch.Tensor,
                               scale: torch.Tensor, bias: torch.Tensor,
                               eps: float = EPS) -> torch.Tensor:
    y = layer_norm_plain(x.float() + conv_bias.float(), scale, bias, eps)
    return torch.nn.functional.gelu(y).to(x.dtype)


def _launch(x, conv_bias, scale, bias, eps, gelu: bool) -> torch.Tensor:
    h = x.shape[-1]
    if not x.is_contiguous():
        raise ValueError("layer norm kernel takes a contiguous input")
    if h > MAX_H:
        raise ValueError(f"layer norm kernel takes rows up to {MAX_H} wide, "
                         f"got {h}")
    params = [scale, bias] + ([conv_bias] if gelu else [])
    for p in params:
        if p.shape != (h,) or p.device != x.device:
            raise ValueError("layer norm parameters must be [h] on x's device")
    # the bf16 kernel reads x and writes out in 16-byte vectors
    if x.dtype == torch.bfloat16 and x.data_ptr() % 16:
        raise ValueError("layer norm kernel takes a 16-byte aligned bf16 "
                         "input")
    # parameters go in as float32 (a no-op for the float32 masters; the
    # encoder's bf16 copies widen exactly), 16-byte aligned for the bf16
    # kernel's vector loads (a view at another offset is copied)
    scale, bias = _aligned_f32(scale), _aligned_f32(bias)
    cb = _aligned_f32(conv_bias) if gelu else None
    out = torch.empty_like(x)
    # the current stream's handle without building a torch.cuda.Stream
    # (about 3 us a call on the card's host, against K1's ~20 us)
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    status = _build.library().w2v_layer_norm(
        x.data_ptr(), cb.data_ptr() if gelu else None, scale.data_ptr(),
        bias.data_ptr(), out.data_ptr(), x.numel() // h, h, float(eps),
        _build.dtype_code(x.dtype), int(gelu), stream)
    name = "bias_layer_norm_gelu" if gelu else "layer_norm"
    _build.check(status, name)
    backend.count_launch(name)
    return out


def _aligned_f32(p: torch.Tensor) -> torch.Tensor:
    p = p.float().contiguous()
    return p.clone() if p.data_ptr() % 16 else p


def layer_norm_bwd_plain(x: torch.Tensor, scale: torch.Tensor,
                         g: torch.Tensor, eps: float = EPS,
                         need_dx: bool = True):
    """The formula of ``_ln_bwd_kernel``: float32 statistics recomputed
    from x, ``dx = (g·γ − mean(g·γ) − x̂·mean(g·γ·x̂))·rstd`` in x's type
    (None unless ``need_dx``), ``dγ = Σ g·x̂`` and ``dβ = Σ g`` over the rows
    in float32."""
    h = x.shape[-1]
    x32, g32 = x.float(), g.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (x32 - mean) * rstd
    dx = None
    if need_dx:
        gs = g32 * scale.float()
        m1 = gs.mean(dim=-1, keepdim=True)
        m2 = (gs * xhat).mean(dim=-1, keepdim=True)
        dx = ((gs - m1 - xhat * m2) * rstd).to(x.dtype)
    return (dx, (g32 * xhat).reshape(-1, h).sum(0),
            g32.reshape(-1, h).sum(0))


def layer_norm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                   eps: float = EPS, need_dx: bool = True):
    """(dx in x's type, or None unless ``need_dx``; dscale float32; dbias
    float32) of a LayerNorm over the last dim, from its input x, its scale
    and the output gradient g."""
    if not backend.use_kernel(x):
        return layer_norm_bwd_plain(x, scale, g, eps, need_dx)
    return _launch_bwd(x, scale, g, eps, need_dx)


def _launch_bwd(x, scale, g, eps, need_dx):
    h = x.shape[-1]
    if h > MAX_H:
        raise ValueError(f"layer norm backward kernel takes rows up to "
                         f"{MAX_H} wide, got {h}")
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError("layer norm backward: g must match x")
    if scale.shape != (h,) or scale.device != x.device:
        raise ValueError("layer norm scale must be [h] on x's device")
    x, g = x.contiguous(), g.contiguous()
    # the bf16 kernel reads x and g and writes dx in 16-byte vectors
    if x.dtype == torch.bfloat16 and (x.data_ptr() % 16 or g.data_ptr() % 16):
        raise ValueError("layer norm backward kernel takes 16-byte aligned "
                         "bf16 inputs")
    scale = _aligned_f32(scale)
    rows = x.numel() // h
    code = _build.dtype_code(x.dtype)
    n_part = _bwd_partials(rows, h, code, need_dx)
    dx = torch.empty_like(x) if need_dx else None
    # one float32 allocation: dscale, dbias, then the [n_part, 2, h]
    # partial column sums the kernel adds across its CTAs
    work = torch.empty((n_part + 1) * 2 * h, dtype=torch.float32,
                       device=x.device)
    base = work.data_ptr()
    status = _build.library().w2v_layer_norm_bwd(
        x.data_ptr(), scale.data_ptr(), g.data_ptr(),
        dx.data_ptr() if need_dx else None, base, base + 4 * h,
        base + 8 * h, rows, h, n_part, float(eps), code,
        torch._C._cuda_getCurrentRawStream(x.get_device()))
    _build.check(status, "layer_norm_bwd")
    backend.count_launch("layer_norm_bwd")
    if not need_dx:
        backend.count_launch("layer_norm_bwd_no_dx")
    return dx, work[:h], work[h:2 * h]


@functools.lru_cache(maxsize=64)
def _bwd_partials(rows: int, h: int, code: int, need_dx: bool) -> int:
    """The partial rows (the grid) of K9's call at this shape: a function
    of the shape and the card, asked of the library once."""
    n = _build.library().w2v_layer_norm_bwd_partials(rows, h, code,
                                                     int(need_dx))
    if n <= 0:
        raise RuntimeError(f"layer norm backward kernel refused the shape "
                           f"[{rows}, {h}]")
    return n


def _layer_norm(x, scale, bias, eps):
    if not backend.use_kernel(x):
        return layer_norm_plain(x, scale, bias, eps)
    return _launch(x, None, scale, bias, eps, gelu=False)


class _LayerNormFn(torch.autograd.Function):
    """LayerNorm whose backward is ``layer_norm_bwd`` (K9 on CUDA)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps, ctx.bias_dtype = eps, bias.dtype
        return _layer_norm(x, scale, bias, eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd(x, scale, g, ctx.eps,
                                           ctx.needs_input_grad[0])
        return dx, dscale.to(scale.dtype), dbias.to(ctx.bias_dtype), None


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = EPS) -> torch.Tensor:
    """LayerNorm over the last dim; leading dims are rows.  Differentiable
    in x, scale and bias."""
    if backend.needs_grad(x, scale, bias):
        return _LayerNormFn.apply(x, scale, bias, eps)
    return _layer_norm(x, scale, bias, eps)


def bias_layer_norm_gelu(x: torch.Tensor, conv_bias: torch.Tensor,
                         scale: torch.Tensor, bias: torch.Tensor,
                         eps: float = EPS) -> torch.Tensor:
    """(x + conv_bias) -> LayerNorm(scale, bias) -> exact GELU, fused."""
    if not backend.use_kernel(x):
        return bias_layer_norm_gelu_plain(x, conv_bias, scale, bias, eps)
    backend.refuse_grad("bias_layer_norm_gelu", x, conv_bias, scale, bias)
    return _launch(x, conv_bias, scale, bias, eps, gelu=True)
