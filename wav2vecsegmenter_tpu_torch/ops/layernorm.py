"""Row LayerNorm and the fused conv epilogue (bias -> LayerNorm -> GELU).

Counterpart of ``wav2vecsegmenter_tpu/ops/layernorm.py``.  ``layer_norm``
replaces the Pallas ``_ln_kernel`` (every LayerNorm of the encoder, the
feature projection and the SFC head); ``bias_layer_norm_gelu`` replaces
``_bln_gelu_kernel`` (the LayerNorm-mode conv layers' epilogue).  Both run
the CUDA kernel of ``csrc/layernorm.cu`` on CUDA tensors and their plain
versions on CPU tensors; the source file says what bounds the kernel on the
H100 and how its design answers that.

Semantics (torch.nn.LayerNorm's): float32 mean and biased variance, eps
inside the rsqrt, float32 scale and bias, the result cast back to the input
type.  The epilogue adds the float32 conv bias in float32, as the TPU
kernel does, and uses the exact erf GELU.
"""

from __future__ import annotations

import torch

from . import _build, backend

EPS = 1e-5

backend.register_kernel("layer_norm")
backend.register_kernel("bias_layer_norm_gelu")


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
    if h > 1024:
        raise ValueError(f"layer norm kernel takes rows up to 1024 wide, got {h}")
    params = [scale, bias] + ([conv_bias] if gelu else [])
    for p in params:
        if p.shape != (h,) or p.device != x.device:
            raise ValueError("layer norm parameters must be [h] on x's device")
    # parameters go in as float32 (a no-op for the float32 masters; the
    # encoder's bf16 copies widen exactly)
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    cb = conv_bias.float().contiguous() if gelu else None
    out = torch.empty_like(x)
    lib = _build.library()
    status = lib.w2v_layer_norm(
        x.data_ptr(), cb.data_ptr() if gelu else None, scale.data_ptr(),
        bias.data_ptr(), out.data_ptr(), x.numel() // h, h, float(eps),
        _build.dtype_code(x.dtype), int(gelu),
        torch.cuda.current_stream(x.device).cuda_stream)
    name = "bias_layer_norm_gelu" if gelu else "layer_norm"
    _build.check(status, name)
    backend.count_launch(name)
    return out


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = EPS) -> torch.Tensor:
    """LayerNorm over the last dim; leading dims are rows."""
    if not backend.use_kernel(x):
        return layer_norm_plain(x, scale, bias, eps)
    return _launch(x, None, scale, bias, eps, gelu=False)


def bias_layer_norm_gelu(x: torch.Tensor, conv_bias: torch.Tensor,
                         scale: torch.Tensor, bias: torch.Tensor,
                         eps: float = EPS) -> torch.Tensor:
    """(x + conv_bias) -> LayerNorm(scale, bias) -> exact GELU, fused."""
    if not backend.use_kernel(x):
        return bias_layer_norm_gelu_plain(x, conv_bias, scale, bias, eps)
    return _launch(x, conv_bias, scale, bias, eps, gelu=True)
