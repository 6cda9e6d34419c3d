"""wav2vec 2.0 encoder, both geometries of the JAX package.

Counterpart of ``wav2vecsegmenter_tpu/models/wav2vec2.py``.  The large
models (xls-r-300m, lv60: ``feat_extract_norm="layer"``, stable-LN
encoder) in the JAX package's default configuration: each conv layer is
one fused kernel (``ops.convfuse``: the product, conv bias, LayerNorm and
GELU) and the encoder FFN is the fused ``ops.ffn``.  The JAX package's A/B
flags select the other arm, read at call time: ``W2VSEG_CONVFUSE=0`` runs
each conv layer as a GEMM over a stride-folded view followed by the fused
bias -> LayerNorm -> GELU kernel, ``W2VSEG_FFNFUSE=0`` the FFN as two GEMMs
around an exact GELU.  The truncated encoder's final LayerNorm is not
applied (the reference replaces it with Identity).

The base models (``facebook/wav2vec2-base(-960h)``: ``feat_extract_norm=
"group"``, no conv bias, a post-LN encoder) run as the JAX package runs
them: each conv layer is the stride-folded product and an exact GELU, and
layer 0 adds a float32 GroupNorm over time between them (groups ==
channels: ``_group_norm_time``); no conv kernel runs, since their gates
need a LayerNorm and a conv bias.  The encoder layer is post-LN,
``h = LN1(h + attn(h)); h = LN2(h + ffn(h))``, on the same kernels (K3, K1,
K5).  Its ``encoder.layer_norm`` (the HF pre-layers LayerNorm, the JAX
``encoder_pre_ln``) is held so that checkpoints load strictly, and is not
applied: the reference's truncation replaces it with Identity too.  As in
the JAX package, a post-LN layer applies no FFN adapter.  Both geometries
train alike: the post-LN body and the group-norm stack under autograd
(the stack's backward is plain autograd, as no Pallas kernel takes it in
the JAX package), LNA's splits as ``requires_grad``; an unapplied
``encoder.layer_norm`` or adapter that a split trains gets a zero
gradient and moves by weight decay alone, as the JAX leaves do.

Submodule names follow the HF ``Wav2Vec2Model`` state_dict keys, so a
reference checkpoint loads with ``load_state_dict`` and no renaming.  The
modules only hold parameters (float32 masters); the forward functions below
cast weights to the compute dtype at use, as the JAX code does.  LayerNorm
parameters stay float32 everywhere.

The forward takes an optional ``torch.Generator``: with one, it runs in
train mode, as the JAX forward does with ``deterministic=False``: dropout
after the feature projection (``feat_proj_dropout``), after the positional
conv and after each attention and FFN sub-block (``hidden_dropout``), and
SpecAugment time masking, which replaces masked frames with
``masked_spec_embed``.  Attention-probability dropout stays off, as in the
JAX package's default (``apply_attention_prob_dropout``, off under its
fused attention).  The fused FFN stays on in train mode;
with ``activation_dropout`` above 0 (not xls-r-300m's) the FFN leaves it
for the separate GEMMs with the dropout between them.  Masks are drawn with
``torch.rand`` from the generator, so they follow the JAX distributions,
not its bits.

The forward is differentiable, for LNA fine-tuning: every kernel it runs
sits behind an autograd Function (``ops``).  Freezing is
``requires_grad``: a frozen weight gets no weight-gradient product, while
activations still backprop through frozen layers (the JAX
``n_frozen_layers`` / ``freeze_ffn``).  ``freeze_feature_encoder`` runs the
conv stack and the feature projection under ``torch.no_grad()`` (the JAX
``stop_gradient`` after the projection), which skips their backward.
With ``cfg.ffn_adapter`` the layers from ``adapter_from`` on carry an FFN
adapter (``ffn_adapter.{down_proj,up_proj}``, the reference's names):
``relu(hn·down + b)·up + b``, times ``adapter_scale``, added to the FFN
output before the residual; which layers carry one is structure, not a
parameter (the JAX ``flag`` leaf).

Under ``runtime.quantize=int8`` the inference engine passes the encoder's
int8 layers (``ops.quant.quantize_layers``) down as ``quantized``: each
layer's QKV, attention output and FFN products run int8 x int8, and the
FFN takes the separate products around the GELU instead of the fused
kernel, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core import trace
from ..ops.attention import attention_packed
from ..ops.convfuse import (conv_bias_ln_gelu, convfuse_enabled,
                            strided_conv1d_as_matmul)
from ..ops.ffn import ffn, ffnfuse_enabled
from ..ops.layernorm import bias_layer_norm_gelu, layer_norm
from ..ops.quant import int8_linear
from ..ops.shmap import rand_rows, shard_attention, shard_ffn, tp_cols


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    hidden_size: int = 1024
    num_layers: int = 24            # transformer layers kept (post-truncation)
    num_heads: int = 16
    ffn_dim: int = 4096
    conv_dim: tuple = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: tuple = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = True
    feat_extract_norm: str = "layer"    # 'layer' (large/xls-r) | 'group' (base)
    do_stable_layer_norm: bool = True
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    apply_attention_prob_dropout: bool = False
    activation_dropout: float = 0.0
    feat_proj_dropout: float = 0.1
    layer_norm_eps: float = 1e-5
    ffn_adapter: bool = False
    adapter_dim: int = 512
    adapter_scale: float = 4.0
    apply_spec_augment: bool = True
    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    mask_time_min_masks: int = 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


# architecture presets for the checkpoints the reference uses
PRESETS: dict[str, dict] = {
    "facebook/wav2vec2-xls-r-300m": dict(
        hidden_size=1024, num_layers=24, num_heads=16, ffn_dim=4096,
        feat_extract_norm="layer", do_stable_layer_norm=True, conv_bias=True,
        feat_proj_dropout=0.1, activation_dropout=0.0,
    ),
    "facebook/wav2vec2-large-960h-lv60-self": dict(
        hidden_size=1024, num_layers=24, num_heads=16, ffn_dim=4096,
        feat_extract_norm="layer", do_stable_layer_norm=True, conv_bias=True,
        feat_proj_dropout=0.1, activation_dropout=0.1,
    ),
    "facebook/wav2vec2-base-960h": dict(
        hidden_size=768, num_layers=12, num_heads=12, ffn_dim=3072,
        feat_extract_norm="group", do_stable_layer_norm=False, conv_bias=False,
        feat_proj_dropout=0.1, activation_dropout=0.1,
    ),
    "facebook/wav2vec2-base": dict(
        hidden_size=768, num_layers=12, num_heads=12, ffn_dim=3072,
        feat_extract_norm="group", do_stable_layer_norm=False, conv_bias=False,
        feat_proj_dropout=0.1, activation_dropout=0.1,
    ),
}


def _preset_from_local_config(model_name: str) -> dict | None:
    """The architecture from a local HF model dir's config.json."""
    import json
    import os

    path = os.path.join(model_name, "config.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        c = json.load(f)
    return dict(
        hidden_size=int(c["hidden_size"]),
        num_layers=int(c["num_hidden_layers"]),
        num_heads=int(c["num_attention_heads"]),
        ffn_dim=int(c["intermediate_size"]),
        feat_extract_norm=c.get("feat_extract_norm", "layer"),
        do_stable_layer_norm=bool(c.get("do_stable_layer_norm", True)),
        conv_bias=bool(c.get("conv_bias", True)),
        feat_proj_dropout=float(c.get("feat_proj_dropout", 0.1)),
        activation_dropout=float(c.get("activation_dropout", 0.0)),
    )


def config_for(model_name: str, keep_layers: int | None = None,
               ffn_adapter: bool = False) -> Wav2Vec2Config:
    preset = PRESETS.get(model_name) or _preset_from_local_config(model_name)
    if preset is None:
        raise ValueError(
            f"Unknown wav2vec2 model '{model_name}'. Known presets: "
            f"{sorted(PRESETS)}; or pass a local HF model directory "
            f"containing config.json.")
    kwargs = dict(preset)
    if keep_layers is not None:
        kwargs["num_layers"] = min(keep_layers, kwargs["num_layers"])
    kwargs["ffn_adapter"] = ffn_adapter
    return Wav2Vec2Config(**kwargs)


# --------------------------------------------------------------------------
# modules (parameter holders named after the HF state_dict keys)
# --------------------------------------------------------------------------

class ConvLayer(nn.Module):
    """One conv layer: the conv (with a bias where ``conv_bias``) and its
    norm under ``layer_norm``: a LayerNorm (``norm="layer"``, HF
    ``Wav2Vec2LayerNormConvLayer``), a GroupNorm with a group a channel
    (``"group"``, HF ``Wav2Vec2GroupNormConvLayer``) or none (HF
    ``Wav2Vec2NoLayerNormConvLayer``)."""

    def __init__(self, c_in, c_out, k, s, conv_bias: bool = True,
                 norm: str | None = "layer", device=None):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, k, s, bias=conv_bias,
                              device=device)
        if norm == "layer":
            self.layer_norm = nn.LayerNorm(c_out, device=device)
        elif norm == "group":
            self.layer_norm = nn.GroupNorm(c_out, c_out, device=device)
        else:
            self.layer_norm = None


class FeatureExtractor(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, device=None):
        super().__init__()
        dims = (1,) + tuple(cfg.conv_dim)
        group = cfg.feat_extract_norm == "group"
        self.conv_layers = nn.ModuleList(
            ConvLayer(dims[i], dims[i + 1], cfg.conv_kernel[i],
                      cfg.conv_stride[i], cfg.conv_bias,
                      ("group" if i == 0 else None) if group else "layer",
                      device)
            for i in range(len(cfg.conv_dim)))


class FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, device=None):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], device=device)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size,
                                    device=device)


class WeightNormConv(nn.Module):
    """Grouped conv weights in weight-norm form: w = g * v / ||v||."""

    def __init__(self, h, groups, k, device=None):
        super().__init__()
        self.weight_g = nn.Parameter(torch.ones(1, 1, k, device=device))
        self.weight_v = nn.Parameter(
            torch.zeros(h, h // groups, k, device=device))
        self.bias = nn.Parameter(torch.zeros(h, device=device))


class PositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, device=None):
        super().__init__()
        self.conv = WeightNormConv(cfg.hidden_size,
                                   cfg.num_conv_pos_embedding_groups,
                                   cfg.num_conv_pos_embeddings, device)


class Attention(nn.Module):
    def __init__(self, h, device=None):
        super().__init__()
        self.q_proj = nn.Linear(h, h, device=device)
        self.k_proj = nn.Linear(h, h, device=device)
        self.v_proj = nn.Linear(h, h, device=device)
        self.out_proj = nn.Linear(h, h, device=device)


class FeedForward(nn.Module):
    def __init__(self, h, f, device=None):
        super().__init__()
        self.intermediate_dense = nn.Linear(h, f, device=device)
        self.output_dense = nn.Linear(f, h, device=device)


class Adapter(nn.Module):
    def __init__(self, h, dim, device=None):
        super().__init__()
        self.down_proj = nn.Linear(h, dim, device=device)
        self.up_proj = nn.Linear(dim, h, device=device)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, adapter: bool = False,
                 device=None):
        super().__init__()
        h = cfg.hidden_size
        self.attention = Attention(h, device)
        self.layer_norm = nn.LayerNorm(h, device=device)
        self.feed_forward = FeedForward(h, cfg.ffn_dim, device)
        self.final_layer_norm = nn.LayerNorm(h, device=device)
        self.ffn_adapter = (Adapter(h, cfg.adapter_dim, device) if adapter
                            else None)


class Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, adapter_from: int = 0,
                 device=None):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(cfg, device)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, cfg.ffn_adapter and i >= adapter_from, device)
            for i in range(cfg.num_layers))


class Wav2Vec2Model(nn.Module):
    """The truncated backbone: conv stack, projection, pos conv, layers;
    with ``cfg.ffn_adapter``, FFN adapters in layers ``adapter_from`` on;
    with ``final_layer_norm``, the parameters of the final encoder
    LayerNorm (``SHASWithSSL`` applies it; on a post-LN backbone it holds
    them elsewhere, ``_ForCTC.final_layer_norm``).  A post-LN backbone holds
    its pre-layers ``encoder.layer_norm``, which the forward does not
    apply."""

    def __init__(self, cfg: Wav2Vec2Config, device=None,
                 adapter_from: int = 0, final_layer_norm: bool = False):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = FeatureExtractor(cfg, device)
        self.feature_projection = FeatureProjection(cfg, device)
        self.encoder = Encoder(cfg, adapter_from, device)
        if final_layer_norm or not cfg.do_stable_layer_norm:
            # HF ``encoder.layer_norm``: the untruncated stable-LN model's
            # final LayerNorm, which the forward leaves to the caller, or
            # the post-LN model's pre-layers one, which the truncation
            # drops
            self.encoder.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                                   device=device)
        # SpecAugment's learned mask vector: a training-only parameter, kept
        # so that reference checkpoints load strictly
        self.masked_spec_embed = nn.Parameter(
            torch.zeros(cfg.hidden_size, device=device))

    def forward(self, audio, in_lengths, compute_dtype=torch.float32,
                generator=None, freeze_feature_encoder: bool = False,
                residual_dtype=None, f32_last_k: int = 0, quantized=None):
        return wav2vec2_forward(self, audio, in_lengths, compute_dtype,
                                generator, freeze_feature_encoder,
                                residual_dtype, f32_last_k, quantized)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _lin(lin: nn.Linear, x: torch.Tensor, dt) -> torch.Tensor:
    return x @ lin.weight.to(dt).t() + lin.bias.to(dt)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None, cols=None) -> torch.Tensor:
    """Inverted dropout with a mask drawn from ``generator`` (JAX
    ``_dropout``: keep with probability 1 - rate, scale by 1/(1 - rate));
    the identity without a generator or at rate 0.  On a mesh the mask is
    this rank's part of the global batch's (``ops.shmap.rand_rows``;
    ``cols`` for a split block's activation)."""
    if generator is None or rate == 0.0:
        return x
    keep = rand_rows(x.shape, generator, x.device, cols) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0)


def sample_time_mask(generator: torch.Generator, b: int, t: int,
                     prob: float, length: int,
                     frame_lengths: torch.Tensor | None = None,
                     min_masks: int = 2) -> torch.Tensor:
    """SpecAugment time mask [b, t] bool, as JAX ``sample_time_mask`` (HF
    ``_compute_mask_indices``): one probabilistic-rounding epsilon per call;
    per row ``num = max(floor(prob*len/length + eps), min_masks)``, set to
    ``t // length`` where num spans would exceed t, then clamped to the
    ``len - length + 1`` candidate starts; starts drawn uniformly without
    replacement (argsort of uniform keys), so spans lie inside the row's
    valid length."""
    dev = generator.device
    valid = (frame_lengths.long().to(dev) if frame_lengths is not None
             else torch.full((b,), t, device=dev))
    eps = torch.rand((), generator=generator, device=dev)
    n_starts = (valid - (length - 1)).clamp_min(0)
    num = torch.floor(prob * valid.float() / length + eps).long()
    num = num.clamp_min(min_masks)
    num = torch.where(num * length > t, t // length, num)
    num = torch.minimum(num, n_starts)
    k_max = max(1, t // length)
    keys = rand_rows((b, t), generator, dev)
    pos = torch.arange(t, device=dev)
    keys = torch.where(pos[None, :] < n_starts[:, None], keys, torch.inf)
    starts = keys.argsort(dim=-1)[:, :k_max, None]
    active = torch.arange(k_max, device=dev)[None, :] < num[:, None]
    cover = (pos >= starts) & (pos < starts + length) & active[:, :, None]
    return cover.any(dim=1)


def _group_norm_time(x: torch.Tensor, gn: nn.GroupNorm,
                     eps: float) -> torch.Tensor:
    """GroupNorm with a group a channel over x [B, T, C]: each channel
    normalised over time in float32 (the mean, then the biased variance of
    x - mean, then rsqrt), scaled, shifted and cast back to x's type, as
    the JAX group route (HF ``Wav2Vec2GroupNormConvLayer``).  Every row of
    the window counts, a short window's zero-padded tail too."""
    x32 = x.float()
    mean = x32.mean(dim=1, keepdim=True)
    var = (x32 - mean).square().mean(dim=1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps) * gn.weight
            + gn.bias).to(x.dtype)


def feature_extractor_unfused(fe: FeatureExtractor, audio: torch.Tensor,
                              cfg: Wav2Vec2Config, dt) -> torch.Tensor:
    """A conv stack that no conv kernel takes (their gates need a
    LayerNorm and a conv bias): the base models' group-norm stack, or a
    LayerNorm stack without conv bias.  Each layer is the stride-folded
    product, its conv bias where it has one, its norm where it has one
    (the GroupNorm over time of :func:`_group_norm_time`, or K1) and an
    exact GELU, as the JAX package's unfused branch."""
    x = audio[:, :, None].to(dt)
    for i, layer in enumerate(fe.conv_layers):
        x = strided_conv1d_as_matmul(x, layer.conv.weight,
                                     cfg.conv_stride[i], dt)
        norm = layer.layer_norm
        if layer.conv.bias is not None:
            x = x + layer.conv.bias.to(dt)
        if isinstance(norm, nn.GroupNorm):
            x = _group_norm_time(x, norm, cfg.layer_norm_eps)
        elif norm is not None:
            x = layer_norm(x, norm.weight, norm.bias, cfg.layer_norm_eps)
        x = F.gelu(x)
    return x


def feature_extractor(fe: FeatureExtractor, audio: torch.Tensor,
                      cfg: Wav2Vec2Config, dt) -> torch.Tensor:
    """audio [B, L] -> features [B, T, conv_dim[-1]] (exact T rows; the TPU
    version's 8-aligned row padding is not rebuilt).

    A layer takes the fused kernel where the JAX package's does
    (``wav2vec2.feature_extractor``): the wide layers (s*C a multiple of
    128, at most two stride-folded taps: layers 1-6) and the raw-audio
    layer (s*C <= 64: layer 0).  The group-norm stack of the base models
    goes to :func:`feature_extractor_unfused`."""
    if cfg.feat_extract_norm != "layer" or not cfg.conv_bias:
        return feature_extractor_unfused(fe, audio, cfg, dt)
    x = audio[:, :, None].to(dt)
    fused = convfuse_enabled()
    for i, layer in enumerate(fe.conv_layers):
        k, s, c = cfg.conv_kernel[i], cfg.conv_stride[i], x.shape[-1]
        ln = layer.layer_norm
        if fused and ((s * c) % 128 == 0 and -(-k // s) <= 2 or s * c <= 64):
            x = conv_bias_ln_gelu(x, layer.conv.weight, layer.conv.bias,
                                  ln.weight, ln.bias, s, cfg.layer_norm_eps)
            continue
        x = strided_conv1d_as_matmul(x, layer.conv.weight, s, dt)
        x = bias_layer_norm_gelu(x, layer.conv.bias, ln.weight, ln.bias,
                                 cfg.layer_norm_eps)
    return x


def pos_conv_weight(conv: WeightNormConv) -> torch.Tensor:
    """Weight-norm reconstruction, norm over (out, in/groups) per kernel
    position (torch weight_norm dim=2)."""
    v = conv.weight_v
    norm = torch.sqrt(torch.sum(v.square(), dim=(0, 1), keepdim=True))
    return conv.weight_g * v / norm


def positional_conv(pe: PositionalConvEmbedding, x: torch.Tensor,
                    cfg: Wav2Vec2Config, dt) -> torch.Tensor:
    """Grouped conv positional embedding [B, T, H] -> [B, T, H].  While
    the span recorder is on (``core.trace``) its backward is the span
    ``models.pos_conv.bwd``: the GELU's, the bias's, the conv's and the
    weight norm's gradients."""
    return trace.backward_span("models.pos_conv.bwd", _positional_conv, x,
                               pe, cfg, dt)


def _positional_conv(x: torch.Tensor, pe: PositionalConvEmbedding,
                     cfg: Wav2Vec2Config, dt) -> torch.Tensor:
    k = cfg.num_conv_pos_embeddings
    w = pos_conv_weight(pe.conv).to(dt)  # [H, H/groups, k]
    y = F.conv1d(x.to(dt).transpose(1, 2), w, padding=k // 2,
                 groups=cfg.num_conv_pos_embedding_groups)
    y = y.transpose(1, 2) + pe.conv.bias.to(dt)
    if k % 2 == 0:  # even kernel: drop the last step
        y = y[:, :-1]
    return F.gelu(y).contiguous()


def _mha(attn: Attention, x: torch.Tensor, key_mask: torch.Tensor,
         num_heads: int, dt, quant: dict | None = None) -> torch.Tensor:
    """One fused [H, 3H] QKV GEMM, then attention straight off its output;
    with ``quant`` (the layer's ``ops.quant.quantize_layers`` entry) both
    products run int8.  A block split over a mesh's model axis
    (``tp_mesh``) runs its heads: the QKV of the rank's q/k/v rows, K3 on
    them, its columns of the output projection, summed over 'model'
    (``ops.shmap.shard_attention``)."""
    scale = (x.shape[-1] // num_heads) ** -0.5
    if quant is not None:
        out = attention_packed(int8_linear(x, quant["qkv"], dt), key_mask,
                               num_heads, scale)
        return int8_linear(out, quant["o"], dt)
    mesh = getattr(attn, "tp_mesh", None)
    heads = num_heads // (1 if mesh is None else mesh.n_model)

    def heads_out(x):
        w = torch.cat([attn.q_proj.weight, attn.k_proj.weight,
                       attn.v_proj.weight]).to(dt)
        bias = torch.cat([attn.q_proj.bias, attn.k_proj.bias,
                          attn.v_proj.bias]).to(dt)
        out = attention_packed(x @ w.t() + bias, key_mask, heads, scale)
        return out @ attn.out_proj.weight.to(dt).t()

    return shard_attention(heads_out, x, mesh, attn.out_proj.bias.to(dt))


def _ffn(ff: FeedForward, x: torch.Tensor, cfg: Wav2Vec2Config, dt,
         generator=None, quant: dict | None = None) -> torch.Tensor:
    """The fused ``ops.ffn`` or, under ``W2VSEG_FFNFUSE=0`` or in train
    mode with activation dropout, w1 -> exact GELU (rounded to dt, as
    ``ffn_xla``) -> dropout -> w2.  With ``quant`` the two products run
    int8 around the GELU, and the fused kernel does not run (the JAX
    ``_ffn_block``'s gate)."""
    if quant is not None:
        return int8_linear(F.gelu(int8_linear(x, quant["w1"], dt)),
                           quant["w2"], dt)
    w1, w2 = ff.intermediate_dense, ff.output_dense
    mesh = getattr(ff, "tp_mesh", None)
    act_drop = cfg.activation_dropout if generator is not None else 0.0
    if ffnfuse_enabled() and act_drop == 0.0:
        return shard_ffn(ffn, x, w1.weight, w1.bias, w2.weight, w2.bias,
                         mesh)

    def composed(x, w1w, b1, w2w, b2):
        f = dropout(F.gelu(x @ w1w.to(dt).t() + b1.to(dt)), act_drop,
                    generator, tp_cols(mesh))
        return f @ w2w.to(dt).t() + b2.to(dt)

    return shard_ffn(composed, x, w1.weight, w1.bias, w2.weight, w2.bias,
                     mesh)


def _adapter(ad: Adapter, hn: torch.Tensor, dt) -> torch.Tensor:
    """An FFN adapter, relu(hn·down + b)·up + b; split over a mesh's
    model axis as the FFN is (down column-, up row-parallel)."""
    mesh = getattr(ad, "tp_mesh", None)

    def down_up(x, wd, bd, wu, bu):
        return F.relu(x @ wd.to(dt).t() + bd.to(dt)) @ wu.to(dt).t() \
            + bu.to(dt)

    return shard_ffn(down_up, hn, ad.down_proj.weight, ad.down_proj.bias,
                     ad.up_proj.weight, ad.up_proj.bias, mesh)


def encoder(enc: Encoder, x: torch.Tensor, frame_mask: torch.Tensor,
            cfg: Wav2Vec2Config, dt, generator=None, residual_dtype=None,
            f32_last_k: int = 0, quantized: list | None = None
            ) -> torch.Tensor:
    """Transformer over [B, T, H], pre-LN (``cfg.do_stable_layer_norm``)
    or post-LN (the base models: ``h = LN1(h + attn(h)); h = LN2(h +
    ffn(h))``, no adapter, the pre-layers ``encoder.layer_norm`` not
    applied: the JAX ``layer_body``); padded frames are zeroed once,
    before the positional conv, and carry finite values after that.  With
    a generator, hidden dropout after the positional conv and after each
    sub-block; an FFN adapter's output joins the FFN's after its dropout.

    The precision ladder's knobs (``runtime.precision``), as the JAX
    ``encoder``'s: ``residual_dtype`` carries the residual stream, and so
    each LayerNorm (K1 at that dtype), at a wider dtype than ``dt``; each
    LayerNorm's output is cast to its sub-block's dtype, and the attention
    and FFN outputs to the residual dtype before the adds.
    ``f32_last_k`` runs the last k layers in float32: there K1, K3 and K5
    take their float32 routes (the JAX K5 is bf16-only, so the JAX
    package runs ``ffn_xla`` in those layers).  It is an inference knob:
    with a generator it raises.  Every cast is the identity where the
    dtypes agree, so the default path launches what it did without them.

    ``quantized`` (``runtime.quantize=int8``: ``ops.quant.quantize_layers``
    of this encoder) runs each layer's four products int8; in the last k
    layers of ``f32_last_k`` their outputs stay float32.  Inference only.
    """
    eps = cfg.layer_norm_eps
    res_dt = residual_dtype or dt
    first_f32 = len(enc.layers) - max(0, min(f32_last_k, len(enc.layers)))
    if first_f32 < len(enc.layers) and generator is not None:
        raise ValueError("f32_last_k is an inference-precision knob; it "
                         "does not run in train mode")
    if quantized is not None and generator is not None:
        raise ValueError("int8 quantization is an inference mode; it does "
                         "not run in train mode")
    x = torch.where(frame_mask[:, :, None], x, 0)
    h = (x + positional_conv(enc.pos_conv_embed, x, cfg, dt)).to(res_dt)
    h = dropout(h, cfg.hidden_dropout, generator)
    for i, layer in enumerate(enc.layers):
        ldt = torch.float32 if i >= first_f32 else dt
        quant = None if quantized is None else quantized[i]
        if not cfg.do_stable_layer_norm:
            a = _mha(layer.attention, h.to(ldt), frame_mask, cfg.num_heads,
                     ldt, quant)
            h = layer_norm(h + dropout(a, cfg.hidden_dropout,
                                       generator).to(res_dt),
                           layer.layer_norm.weight, layer.layer_norm.bias,
                           eps)
            f = dropout(_ffn(layer.feed_forward, h.to(ldt), cfg, ldt,
                             generator, quant), cfg.hidden_dropout, generator)
            h = layer_norm(h + f.to(res_dt), layer.final_layer_norm.weight,
                           layer.final_layer_norm.bias, eps)
            continue
        hn = layer_norm(h, layer.layer_norm.weight, layer.layer_norm.bias,
                        eps).to(ldt)
        a = _mha(layer.attention, hn, frame_mask, cfg.num_heads, ldt, quant)
        h = h + dropout(a, cfg.hidden_dropout, generator).to(res_dt)
        hn = layer_norm(h, layer.final_layer_norm.weight,
                        layer.final_layer_norm.bias, eps).to(ldt)
        f = dropout(_ffn(layer.feed_forward, hn, cfg, ldt, generator, quant),
                    cfg.hidden_dropout, generator)
        if layer.ffn_adapter is not None:
            f = f + _adapter(layer.ffn_adapter, hn, ldt) * cfg.adapter_scale
        h = h + f.to(res_dt)
    return h


def frame_lengths(in_lengths: torch.Tensor,
                  cfg: Wav2Vec2Config) -> torch.Tensor:
    """Exact conv-stack output lengths (HF _get_feat_extract_output_lengths)."""
    fl = in_lengths.long()
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        fl = torch.div(fl - k, s, rounding_mode="floor") + 1
    return fl


def wav2vec2_forward(model: Wav2Vec2Model, audio: torch.Tensor,
                     in_lengths: torch.Tensor,
                     compute_dtype=torch.float32,
                     generator: torch.Generator | None = None,
                     freeze_feature_encoder: bool = False,
                     residual_dtype=None, f32_last_k: int = 0,
                     quantized: list | None = None):
    """audio [B, L] normalized, in_lengths [B] valid samples ->
    (hidden [B, T, H] float32, frame_mask [B, T] bool).  A ``generator``
    selects train mode (dropout and SpecAugment, drawn from it);
    ``freeze_feature_encoder`` runs the conv stack and the feature
    projection without a graph; ``residual_dtype`` and ``f32_last_k`` are
    the precision ladder's, ``quantized`` the int8 layers
    (:func:`encoder`)."""
    cfg = model.cfg
    with torch.set_grad_enabled(torch.is_grad_enabled()
                                and not freeze_feature_encoder):
        feats = feature_extractor(model.feature_extractor, audio, cfg,
                                  compute_dtype)
        fp = model.feature_projection
        feats = layer_norm(feats, fp.layer_norm.weight, fp.layer_norm.bias,
                           cfg.layer_norm_eps)
        x = _lin(fp.projection, feats, compute_dtype)
    t = feats.shape[1]
    fl = frame_lengths(in_lengths.to(feats.device), cfg)
    frame_mask = torch.arange(t, device=feats.device)[None, :] < fl[:, None]
    x = dropout(x, cfg.feat_proj_dropout, generator)
    if (generator is not None and cfg.apply_spec_augment
            and cfg.mask_time_prob > 0):
        tmask = sample_time_mask(generator, x.shape[0], t, cfg.mask_time_prob,
                                 cfg.mask_time_length, fl,
                                 cfg.mask_time_min_masks) & frame_mask
        x = torch.where(tmask[:, :, None],
                        model.masked_spec_embed.to(x.dtype), x)
    h = encoder(model.encoder, x, frame_mask, cfg, compute_dtype, generator,
                residual_dtype, f32_last_k, quantized)
    return h.float(), frame_mask


def init_from_numpy(model: nn.Module, seed: int) -> None:
    """Seeded random weights drawn with numpy, in state_dict order: linear
    and conv weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)), conv
    biases and LayerNorm biases 0, LayerNorm scales 1, the positional conv
    direction N(0, 0.02) with its gain set to the direction's norm.
    GroupNorm scales and biases as LayerNorm ones."""
    import numpy as np

    rng = np.random.RandomState(seed)
    named = dict(model.named_modules())
    with torch.no_grad():
        for name, p in model.named_parameters():
            owner_name, _, leaf = name.rpartition(".")
            owner = named[owner_name]
            if isinstance(owner, (nn.LayerNorm, nn.GroupNorm)):
                p.fill_(1.0 if leaf == "weight" else 0.0)
                continue
            if isinstance(owner, WeightNormConv):
                if leaf == "weight_v":
                    p.copy_(torch.from_numpy(
                        rng.randn(*p.shape).astype(np.float32) * 0.02))
                elif leaf == "bias":
                    p.zero_()
                continue  # weight_g follows weight_v below
            if isinstance(owner, nn.Conv1d) and leaf == "bias":
                p.zero_()
                continue
            if isinstance(owner, (nn.Linear, nn.Conv1d)):
                w = owner.weight
                fan_in = w.shape[1] * (w.shape[2] if w.dim() == 3 else 1)
            else:  # the SFC's in_proj_* and masked_spec_embed
                w = getattr(owner, "in_proj_weight", p)
                fan_in = w.shape[-1]
            bound = 1.0 / math.sqrt(fan_in)
            p.copy_(torch.from_numpy(
                rng.uniform(-bound, bound, p.shape).astype(np.float32)))
        for m in model.modules():
            if isinstance(m, WeightNormConv):
                m.weight_g.copy_(torch.sqrt(torch.sum(
                    m.weight_v.square(), dim=(0, 1), keepdim=True)))
