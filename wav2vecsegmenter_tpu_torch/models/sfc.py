"""Segmentation frame classifier (SFC) head.

Counterpart of ``wav2vecsegmenter_tpu/models/sfc.py``: N pre-LN transformer
layers (torch ``TransformerEncoderLayer`` with norm_first, GELU, 8 heads,
FFN 2048) -> LayerNorm -> Linear(H -> V).  The bce head (V = 1) squeezes
its one class; the multi-class heads (a vocabulary's V, 4 or 36) return
[B, T, V], as the JAX ``sfc_forward`` does.  Padding enters as a key mask
(True = valid frame).  Submodule names follow the reference classifier's
state_dict keys.

The forward is differentiable: its LayerNorms and attention go through the
autograd Functions of ``ops`` (backward kernels K9 and K10 on CUDA).  With
a generator it runs in train mode, with dropout at the head's input, after
the attention output, after the GELU and after the second linear, as the
JAX ``sfc_forward`` does with ``deterministic=False``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import backend
from ..ops.attention import attention_qkv
from ..ops.layernorm import layer_norm
from ..ops.rowdot import row_dot
from ..ops.shmap import shard_attention, shard_ffn, tp_cols
from .wav2vec2 import _lin, dropout

EPS = 1e-5


class SelfAttention(nn.Module):
    def __init__(self, d_model, device=None):
        super().__init__()
        self.in_proj_weight = nn.Parameter(
            torch.zeros(3 * d_model, d_model, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model, device=device))
        self.out_proj = nn.Linear(d_model, d_model, device=device)


class SFCLayer(nn.Module):
    def __init__(self, d_model, ffn_dim, device=None):
        super().__init__()
        self.self_attn = SelfAttention(d_model, device)
        self.linear1 = nn.Linear(d_model, ffn_dim, device=device)
        self.linear2 = nn.Linear(ffn_dim, d_model, device=device)
        self.norm1 = nn.LayerNorm(d_model, device=device)
        self.norm2 = nn.LayerNorm(d_model, device=device)


class Transformer(nn.Module):
    def __init__(self, d_model, n_layers, ffn_dim, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            SFCLayer(d_model, ffn_dim, device) for _ in range(n_layers))


class SegmentationFrameClassifier(nn.Module):
    def __init__(self, d_model: int = 1024, n_layers: int = 1,
                 n_heads: int = 8, ffn_dim: int = 2048, vocab_size: int = 1,
                 device=None):
        super().__init__()
        self.vocab_size = vocab_size
        self.n_heads = n_heads
        self.transformer = Transformer(d_model, n_layers, ffn_dim, device)
        self.layer_norm = nn.LayerNorm(d_model, device=device)
        self.output_layer = nn.Linear(d_model, vocab_size, device=device)

    def forward(self, x, out_mask, compute_dtype=torch.float32,
                dropout_rate: float = 0.0, generator=None):
        return sfc_forward(self, x, out_mask, compute_dtype, dropout_rate,
                           generator)


def sfc_forward(head: SegmentationFrameClassifier, x: torch.Tensor,
                out_mask: torch.Tensor, compute_dtype=torch.float32,
                dropout_rate: float = 0.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """x [B, T, H] hidden states, out_mask [B, T] -> logits [B, T] float32
    (V = 1) or [B, T, V] float32.  A generator selects train mode: dropout
    at ``dropout_rate``."""
    dt = compute_dtype
    h = dropout(x.to(dt), dropout_rate, generator).contiguous()
    for layer in head.transformer.layers:
        h = encoder_layer(layer, h, out_mask, head.n_heads, dt, dropout_rate,
                          generator)
    h = layer_norm(h, head.layer_norm.weight, head.layer_norm.bias, EPS)
    logits = output_layer(head.output_layer, h, dt).float()
    return logits[..., 0] if logits.shape[-1] == 1 else logits


def output_layer(lin: nn.Linear, h: torch.Tensor, dt) -> torch.Tensor:
    """The head's output layer over h [B, T, H] in ``dt``: [B, T, V].  The
    bce head (V = 1) at inference goes through ``ops.rowdot.row_dot``, on
    the card a row-local kernel whose logit does not hang on the batch
    (ROADMAP C18); under grad, and at V > 1, ``_lin``."""
    if lin.out_features == 1 and not backend.needs_grad(h, lin.weight,
                                                        lin.bias):
        return row_dot(h, lin.weight.to(dt)[0], lin.bias.to(dt))[..., None]
    return _lin(lin, h, dt)


def encoder_layer(layer: SFCLayer, h: torch.Tensor, key_mask: torch.Tensor,
                  n_heads: int, dt, dropout_rate: float = 0.0,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """One pre-LN layer over h [B, T, H] in ``dt``: LayerNorm (K1) -> QKV
    GEMM -> attention keyed by ``key_mask`` (K4) -> output projection ->
    dropout -> residual; LayerNorm -> linear1 -> exact GELU -> dropout ->
    linear2 -> dropout -> residual (the dropouts at ``dropout_rate``, drawn
    from ``generator``; none without one).  A block split over a mesh's
    model axis (``tp_mesh`` on the attention or the layer) runs the rank's
    heads or F columns, summed over 'model' (``ops.shmap``)."""
    hn = layer_norm(h, layer.norm1.weight, layer.norm1.bias, EPS)
    a = self_attention(layer.self_attn, hn, key_mask, n_heads, dt)
    h = h + dropout(a, dropout_rate, generator)
    hn = layer_norm(h, layer.norm2.weight, layer.norm2.bias, EPS)
    f = feed_forward(layer, hn, dt, dropout_rate, generator)
    return h + dropout(f, dropout_rate, generator)


def self_attention(sa: SelfAttention, hn: torch.Tensor,
                   key_mask: torch.Tensor, n_heads: int, dt) -> torch.Tensor:
    """The packed QKV GEMM, K4 and the output projection, on the rank's
    heads where ``sa`` is split."""
    mesh = getattr(sa, "tp_mesh", None)
    heads = n_heads // (1 if mesh is None else mesh.n_model)
    b, t, d_model = hn.shape
    dh = d_model // n_heads

    def heads_out(x):
        qkv = x @ sa.in_proj_weight.to(dt).t() + sa.in_proj_bias.to(dt)
        a = attention_qkv(qkv.view(b, t, 3, heads, dh), key_mask,
                          dh ** -0.5)
        return a.reshape(b, t, heads * dh) @ sa.out_proj.weight.to(dt).t()

    return shard_attention(heads_out, hn, mesh, sa.out_proj.bias.to(dt))


def feed_forward(layer, hn: torch.Tensor, dt, dropout_rate: float = 0.0,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """linear1 -> exact GELU -> dropout -> linear2 of a head layer (an
    ``SFCLayer`` or a decoder layer), on the rank's F columns where the
    layer is split."""
    mesh = getattr(layer, "tp_mesh", None)

    def composed(x, w1, b1, w2, b2):
        f = dropout(F.gelu(x @ w1.to(dt).t() + b1.to(dt)), dropout_rate,
                    generator, tp_cols(mesh))
        return f @ w2.to(dt).t() + b2.to(dt)

    return shard_ffn(composed, hn, layer.linear1.weight, layer.linear1.bias,
                     layer.linear2.weight, layer.linear2.bias, mesh)
