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
  memory, the output stored by TMA; in float32 ``wgmma`` in split TF32
  (the weight split into TF32 hi and lo parts once a call, in scratch this
  wrapper allocates) fed by ``cp.async`` from the input read in place as
  an overlapping strided view (row r is ``x[b, r*s : r*s + k]`` flattened,
  K = k*C), in clusters of four CTAs of 128 channels that merge the
  LayerNorm statistics through distributed shared memory;
* ``conv_audio_ln_gelu``: a narrow product (k*C <= 16, the raw-audio layer
  0): in bf16 the taps on the tensor cores (``mma.sync``, K padded to 16)
  from a staged span of samples; in float32 a persistent kernel whose
  warps take two rows at a time, scalar taps on the weight held in shared
  memory, each row stored as four 512-byte warp stores of 16 bytes a lane.

Both end in the same block with the LayerNorm and GELU.  On CPU tensors
the plain version runs.

Semantics: x [B, T, C], weight [O, C, k] (torch ``Conv1d`` layout, cast to
x's type per call), VALID, stride s -> [B, T', O], T' = (T - k)//s + 1.
The products accumulate in float32 and stay float32 through the bias,
LayerNorm and GELU, rounded once at the end, as ``_kernel_2tap_wide`` does;
the plain version rounds there too.  (The JAX ``_xla_ref`` rounds the
product to x's type before the epilogue.)  The narrow kernel takes
k*C <= 16 and a row step s*C <= 64 in bf16, <= 16 in float32; a wider
step on CUDA raises ``ValueError``.

Where a gradient is needed, ``conv_bias_ln_gelu`` goes through
``_ConvLnGeluFn``, the counterpart of the JAX custom VJP ``_fused``: its
forward is the above, its backward replays ``conv_bias_ln_gelu_composed``
(``_xla_ref``'s dtype-native composition: the stride-folded GEMM of
:func:`strided_conv1d_as_matmul` rounded to x's type, then
``bias_layer_norm_gelu_composed``) under autograd.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from . import _build, backend
from .layernorm import (EPS, bias_layer_norm_gelu_composed,
                        bias_layer_norm_gelu_plain)

AUDIO_MAX_K = 16  # widest product (k*C) of conv_audio_ln_gelu
# widest row step (s*C) of conv_audio_ln_gelu, by dtype
AUDIO_MAX_STEP = {torch.bfloat16: 64, torch.float32: 16}

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


def strided_conv1d_as_matmul(x: torch.Tensor, w: torch.Tensor, stride: int,
                             dt) -> torch.Tensor:
    """VALID strided conv as one GEMM over a stride-folded view.

    x [B, T, C], w [O, C, k] (torch layout) -> [B, T', O], T' = (T-k)//s + 1.
    Folding the stride into channels, ``y[b, i, j*C + c] = x[b, i*s + j, c]``,
    turns tap p into the shifted view ``y[:, p:p+T']``; the taps concatenate
    into one operand of depth ceil(k/s)*s*C against the weight rows of
    kernel positions p*s + j (zero rows past k).  One GEMM accumulates every
    tap in float32 and rounds once, as the JAX version's f32 tap sum does.
    """
    b, t, c = x.shape
    o, _, k = w.shape
    t_out = (t - k) // stride + 1
    n_taps = -(-k // stride)
    t_need = (n_taps + t_out - 1) * stride
    if t_need > t:
        x = F.pad(x, (0, 0, 0, t_need - t))
    elif t_need < t:
        x = x[:, :t_need]
    y = x.reshape(b, n_taps + t_out - 1, stride * c).to(dt)
    z = y if n_taps == 1 else torch.cat(
        [y[:, p:p + t_out] for p in range(n_taps)], dim=-1)
    w_full = w.to(dt).permute(2, 1, 0).reshape(k * c, o)
    if n_taps * stride > k:
        w_full = F.pad(w_full, (0, 0, 0, (n_taps * stride - k) * c))
    return z @ w_full


def conv_bias_ln_gelu_composed(x: torch.Tensor, weight: torch.Tensor,
                               conv_bias: torch.Tensor, scale: torch.Tensor,
                               bias: torch.Tensor, stride: int,
                               eps: float = EPS) -> torch.Tensor:
    """``_xla_ref``'s composition in x's type: the product rounded to x's
    type, then the epilogue of ``bias_layer_norm_gelu_composed``.  The
    backward of ``_ConvLnGeluFn`` replays it."""
    return bias_layer_norm_gelu_composed(
        strided_conv1d_as_matmul(x, weight, stride, x.dtype), conv_bias,
        scale, bias, eps)


def _conv_bias_ln_gelu(x, weight, conv_bias, scale, bias, stride, eps):
    if not backend.use_kernel(x):
        return conv_bias_ln_gelu_plain(x, weight, conv_bias, scale, bias,
                                       stride, eps)
    return _launch(x, weight, conv_bias, scale, bias, stride, eps)


class _ConvLnGeluFn(torch.autograd.Function):
    """One fused conv layer whose backward replays
    ``conv_bias_ln_gelu_composed``."""

    @staticmethod
    def forward(ctx, x, weight, conv_bias, scale, bias, stride, eps):
        ctx.save_for_backward(x, weight, conv_bias, scale, bias)
        ctx.stride, ctx.eps = stride, eps
        return _conv_bias_ln_gelu(x, weight, conv_bias, scale, bias, stride,
                                  eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return backend.replay_vjp(
            lambda *a: conv_bias_ln_gelu_composed(*a, ctx.stride, ctx.eps),
            ctx.saved_tensors, ctx.needs_input_grad[:5], g) + (None, None)


def conv_bias_ln_gelu(x: torch.Tensor, weight: torch.Tensor,
                      conv_bias: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, stride: int,
                      eps: float = EPS) -> torch.Tensor:
    """One conv layer with its bias -> LayerNorm -> GELU epilogue, fused.
    Differentiable in x and the parameters."""
    if backend.needs_grad(x, weight, conv_bias, scale, bias):
        return _ConvLnGeluFn.apply(x, weight, conv_bias, scale, bias, stride,
                                   eps)
    return _conv_bias_ln_gelu(x, weight, conv_bias, scale, bias, stride, eps)


def _launch(x, weight, conv_bias, scale, bias, stride, eps) -> torch.Tensor:
    b, t, c, o, k, t_out = _geometry(x, weight, stride)
    if not x.is_contiguous():
        raise ValueError("conv kernel takes a contiguous [B, T, C] input")
    narrow = k * c <= AUDIO_MAX_K
    if narrow and stride * c > AUDIO_MAX_STEP.get(x.dtype, stride * c):
        raise ValueError(
            f"the narrow conv kernel takes a row step s*C up to "
            f"{AUDIO_MAX_STEP[x.dtype]} in {x.dtype}, not {stride * c}")
    if x.data_ptr() % 16 and (x.dtype == torch.bfloat16 or not narrow):
        raise ValueError("the bf16 conv kernels read x by TMA, the float32 "
                         "conv layers by cp.async: its storage must start "
                         "on a 16-byte boundary")
    for p in (weight, conv_bias, scale, bias):
        if p.device != x.device:
            raise ValueError("conv parameters must be on x's device")
    if conv_bias.shape != (o,) or scale.shape != (o,) or bias.shape != (o,):
        raise ValueError("conv bias and LayerNorm parameters must be [O]")
    w = _gemm_weight(weight, x.dtype).contiguous()
    params = [p.float().contiguous() for p in (conv_bias, scale, bias)]
    out = torch.empty((b, t_out, o), dtype=x.dtype, device=x.device)
    name = "conv_audio_ln_gelu" if narrow else "conv_bias_ln_gelu"
    lib = _build.library()
    pointers = [x.data_ptr(), w.data_ptr(), *(p.data_ptr() for p in params),
                out.data_ptr()]
    if narrow:
        launch = lib.w2v_conv_audio_ln_gelu
    else:
        launch = lib.w2v_conv_ln_gelu
        # float32: the weight's TF32 hi and lo parts, written by the call
        split = (torch.empty(2 * w.numel(), dtype=torch.float32,
                             device=x.device)
                 if x.dtype == torch.float32 else None)
        pointers.append(None if split is None else split.data_ptr())
    status = launch(
        *pointers, b, t, c, k, stride, t_out, o, float(eps),
        _build.dtype_code(x.dtype),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, name)
    backend.count_launch(name)
    return out
