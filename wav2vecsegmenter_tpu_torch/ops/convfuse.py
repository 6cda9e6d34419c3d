"""One LayerNorm-mode conv layer: conv -> + conv bias -> LayerNorm -> GELU.

Counterpart of ``wav2vecsegmenter_tpu/ops/convfuse.py``:
``conv_bias_ln_gelu`` replaces the Pallas kernels ``_kernel_2tap_wide``
(K6), ``_kernel_2tap`` (K8, the same function) and ``_kernel_1tap`` (K7).
On CUDA tensors it runs a kernel of ``csrc/convfuse.cu``:

* ``conv_bias_ln_gelu`` (launch counter of that name), conv layers 1-6: in
  bf16 a ``wgmma`` + TMA kernel in clusters of two CTAs, each owning 128
  rows x 256 channels, the A operand loaded by TMA from x as it lies (the
  stride fold: one map for taps [0, s), one for [s, k)) and multicast to
  the pair, the LayerNorm statistics merged through distributed shared
  memory, the output stored by TMA; in float32 scalar FMAs over the input
  read in place as an overlapping strided view (row r is
  ``x[b, r*s : r*s + k]`` flattened, K = k*C);
* ``conv_audio_ln_gelu``: a narrow product (k*C <= 16, the raw-audio layer
  0): in bf16 the taps on the tensor cores (``mma.sync``, K padded to 16)
  from a staged span of samples, in float32 scalar taps.

Both end in the same block with the LayerNorm and GELU.  On CPU tensors
the plain version runs.

Semantics: x [B, T, C], weight [O, C, k] (torch ``Conv1d`` layout, cast to
x's type per call), VALID, stride s -> [B, T', O], T' = (T - k)//s + 1.
The products accumulate in float32 and stay float32 through the bias,
LayerNorm and GELU, rounded once at the end, as ``_kernel_2tap_wide`` does;
the plain version rounds there too.  (The JAX ``_xla_ref`` rounds the
product to x's type before the epilogue.)
"""

from __future__ import annotations

import os

import torch

from . import _build, backend
from .layernorm import EPS, bias_layer_norm_gelu_plain

AUDIO_MAX_K = 16  # widest product (k*C) of conv_audio_ln_gelu

backend.register_kernel("conv_bias_ln_gelu")
backend.register_kernel("conv_audio_ln_gelu")


def convfuse_enabled() -> bool:
    """Route the LayerNorm-mode conv layers through ``conv_bias_ln_gelu``
    (default).  ``W2VSEG_CONVFUSE=0`` restores the GEMM + fused epilogue
    path of the JAX package's A/B arm; read at call time."""
    return os.environ.get("W2VSEG_CONVFUSE", "1") == "1"


def _geometry(x: torch.Tensor, weight: torch.Tensor, stride: int):
    b, t, c = x.shape
    o, c_w, k = weight.shape
    if c_w != c:
        raise ValueError(f"conv weight takes {c_w} input channels, x has {c}")
    t_out = (t - k) // stride + 1
    if t_out < 1:
        raise ValueError(f"conv input of {t} frames is shorter than k={k}")
    return b, t, c, o, k, t_out


def _gemm_weight(weight: torch.Tensor, dtype) -> torch.Tensor:
    """[O, C, k] -> [O, k*C] in ``dtype``: column j*C + c multiplies input
    element c of tap j, as the rows of the strided view run."""
    o, c, k = weight.shape
    return weight.to(dtype).permute(0, 2, 1).reshape(o, k * c)


def conv_bias_ln_gelu_plain(x: torch.Tensor, weight: torch.Tensor,
                            conv_bias: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, stride: int,
                            eps: float = EPS) -> torch.Tensor:
    """The kernels' arithmetic in plain PyTorch: a float32 product of the
    operands in x's type (exact for bf16), float32 epilogue, one rounding."""
    b, t, c, o, k, t_out = _geometry(x, weight, stride)
    # x read as [B, T', k*C] GEMM rows: an overlapping view, no copy
    rows = x.contiguous().as_strided((b, t_out, k * c),
                                     (t * c, stride * c, 1))
    acc = rows.float() @ _gemm_weight(weight, x.dtype).float().t()
    return bias_layer_norm_gelu_plain(acc, conv_bias, scale, bias,
                                      eps).to(x.dtype)


def conv_bias_ln_gelu(x: torch.Tensor, weight: torch.Tensor,
                      conv_bias: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, stride: int,
                      eps: float = EPS) -> torch.Tensor:
    """One conv layer with its bias -> LayerNorm -> GELU epilogue, fused."""
    if not backend.use_kernel(x):
        return conv_bias_ln_gelu_plain(x, weight, conv_bias, scale, bias,
                                       stride, eps)
    backend.refuse_grad("conv_bias_ln_gelu", x, weight, conv_bias, scale,
                        bias)
    b, t, c, o, k, t_out = _geometry(x, weight, stride)
    if not x.is_contiguous():
        raise ValueError("conv kernel takes a contiguous [B, T, C] input")
    if x.dtype == torch.bfloat16 and x.data_ptr() % 16:
        raise ValueError("the bf16 conv kernels read x by TMA: its storage "
                         "must start on a 16-byte boundary")
    for p in (weight, conv_bias, scale, bias):
        if p.device != x.device:
            raise ValueError("conv parameters must be on x's device")
    if conv_bias.shape != (o,) or scale.shape != (o,) or bias.shape != (o,):
        raise ValueError("conv bias and LayerNorm parameters must be [O]")
    w = _gemm_weight(weight, x.dtype).contiguous()
    params = [p.float().contiguous() for p in (conv_bias, scale, bias)]
    out = torch.empty((b, t_out, o), dtype=x.dtype, device=x.device)
    narrow = k * c <= AUDIO_MAX_K
    name = "conv_audio_ln_gelu" if narrow else "conv_bias_ln_gelu"
    lib = _build.library()
    launch = lib.w2v_conv_audio_ln_gelu if narrow else lib.w2v_conv_ln_gelu
    status = launch(
        x.data_ptr(), w.data_ptr(), *(p.data_ptr() for p in params),
        out.data_ptr(), b, t, c, k, stride, t_out, o, float(eps),
        _build.dtype_code(x.dtype),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, name)
    backend.count_launch(name)
    return out
