"""The plain reference of the SHAS model: wav2vec 2.0 with the stable
LayerNorm encoder (the large models: xls-r-300m) and the SFC head, in
float32, written from the published description (HF ``Wav2Vec2Model``,
reference lib/models.py) with plain PyTorch operations and no kernels.

It reads the parameters by their state_dict names from a dict of tensors
that the benchmark made, and imports nothing of the program.  Departures
from the HF model, as the product runs it: the encoder is truncated to
``wav2vec_keep_layers`` and its final LayerNorm is not applied (the
reference replaces it with Identity); layerdrop and attention-probability
dropout are off.

In train mode (a ``torch.Generator``) dropout and SpecAugment draw their
masks from the generator in the program's documented convention: one
``torch.rand`` of the activation's shape per dropout, in the order of the
forward, keep where u < 1 - rate, scale by 1 / (1 - rate); SpecAugment
draws one uniform for the rounding and a [B, T] uniform key per frame,
and takes the lowest keys among a row's candidate starts.  A generator
seeded alike then gives the same masks on both sides, so that training
can be compared step by step.

``quant=True`` computes every product, linear and conv, in float8 e4m3,
as the control of the training cells' comparison (the nearest precision
below the configuration's bf16): each row of the input (its last dim) and
each output channel of the weight scaled to the e4m3 range by its largest
magnitude and rounded (the gradient passes straight through the
rounding).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BB = "wav2vec_model.model."
HEAD = "seg_model."


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """x with each row (last dim) scaled to the e4m3 range (448 at its
    largest magnitude) and rounded to float8 e4m3; the gradient passes
    through unchanged."""
    scale = x.detach().abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 448
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x.detach())


def dropout(x: torch.Tensor, rate: float, gen) -> torch.Tensor:
    if gen is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def conv_lengths(lengths: torch.Tensor, m: dict) -> torch.Tensor:
    n = lengths.long()
    for k, s in zip(m["conv_kernel"], m["conv_stride"]):
        n = torch.div(n - k, s, rounding_mode="floor") + 1
    return n


def time_mask(gen, b: int, t: int, valid: torch.Tensor, m: dict):
    """SpecAugment's time mask [b, t] (HF ``_compute_mask_indices``):
    per row max(floor(prob * len / length + eps), min_masks) spans of
    ``mask_time_length`` frames, fewer where they would not fit, their
    starts drawn without replacement among the row's candidates."""
    prob, length = m["mask_time_prob"], m["mask_time_length"]
    dev = valid.device
    eps = torch.rand((), generator=gen, device=dev)
    n_starts = (valid - (length - 1)).clamp_min(0)
    num = torch.floor(prob * valid.float() / length + eps).long()
    num = num.clamp_min(m["mask_time_min_masks"])
    num = torch.where(num * length > t, t // length, num)
    num = torch.minimum(num, n_starts)
    k_max = max(1, t // length)
    keys = torch.rand((b, t), generator=gen, device=dev)
    pos = torch.arange(t, device=dev)
    keys = torch.where(pos[None, :] < n_starts[:, None], keys, torch.inf)
    starts = keys.argsort(dim=-1)[:, :k_max, None]
    active = torch.arange(k_max, device=dev)[None, :] < num[:, None]
    cover = (pos >= starts) & (pos < starts + length) & active[:, :, None]
    return cover.any(dim=1)


class Reference:
    """The model over ``params`` ({state_dict name: float32 tensor}) and a
    configuration file of ``benchmark/configs``."""

    def __init__(self, params: dict, cfg: dict, quant: bool = False):
        self.p = params
        self.m = cfg["model"]
        self.task = cfg["task"]
        self.quant = fake_fp8 if quant else None

    def lin(self, x, w, b=None):
        if self.quant:
            x, w = self.quant(x), self.quant(w)
        y = x @ w.t()
        return y if b is None else y + b

    def conv(self, x, w, b, **kw):
        """F.conv1d, its input and weight (each output channel a row)
        rounded first under ``quant``."""
        if self.quant:
            x = self.quant(x)
            w = self.quant(w.reshape(w.shape[0], -1)).reshape(w.shape)
        return F.conv1d(x, w, b, **kw)

    def ln(self, x, prefix):
        return F.layer_norm(x, x.shape[-1:], self.p[prefix + "weight"],
                            self.p[prefix + "bias"], self.m["layer_norm_eps"])

    @staticmethod
    def attention(q, k, v, key_mask, heads):
        """Softmax attention over the valid keys; q, k, v [B, T, H]."""
        b, t, h = q.shape
        d = h // heads

        def split(x):
            return x.view(b, t, heads, d).transpose(1, 2)

        s = split(q) @ split(k).transpose(-1, -2) * d ** -0.5
        s = s.masked_fill(~key_mask[:, None, None, :],
                          torch.finfo(s.dtype).min)
        o = torch.softmax(s, dim=-1) @ split(v)
        return o.transpose(1, 2).reshape(b, t, h)

    def conv_stack(self, audio):
        """audio [B, L] normalized -> features [B, T, C]."""
        x = audio[:, None, :]
        for i, s in enumerate(self.m["conv_stride"]):
            pre = f"{BB}feature_extractor.conv_layers.{i}."
            x = self.conv(x, self.p[pre + "conv.weight"],
                          self.p[pre + "conv.bias"], stride=s)
            x = F.gelu(self.ln(x.transpose(1, 2),
                               pre + "layer_norm.").transpose(1, 2))
        return x.transpose(1, 2)

    def backbone(self, audio, in_lengths, gen=None, grad_below=False):
        """(hidden [B, T, H], frame mask [B, T]); the conv stack and the
        feature projection run without a graph unless ``grad_below``."""
        m, p = self.m, self.p
        with torch.set_grad_enabled(torch.is_grad_enabled() and grad_below):
            feats = self.ln(self.conv_stack(audio),
                            BB + "feature_projection.layer_norm.")
            x = self.lin(feats, p[BB + "feature_projection.projection.weight"],
                         p[BB + "feature_projection.projection.bias"])
        t = feats.shape[1]
        valid = conv_lengths(in_lengths, m)
        frame_mask = torch.arange(t, device=x.device)[None, :] < valid[:, None]
        x = dropout(x, m["feat_proj_dropout"], gen)
        if gen is not None and m["apply_spec_augment"] \
                and m["mask_time_prob"] > 0:
            tm = time_mask(gen, x.shape[0], t, valid, m) & frame_mask
            x = torch.where(tm[:, :, None], p[BB + "masked_spec_embed"], x)
        x = torch.where(frame_mask[:, :, None], x, 0.0)
        pre = BB + "encoder.pos_conv_embed.conv."
        v = p[pre + "weight_v"]
        w = p[pre + "weight_g"] * v / torch.sqrt(
            v.square().sum(dim=(0, 1), keepdim=True))
        k = m["num_conv_pos_embeddings"]
        y = self.conv(x.transpose(1, 2), w, p[pre + "bias"], padding=k // 2,
                      groups=m["num_conv_pos_embedding_groups"])
        if k % 2 == 0:
            y = y[:, :, :-1]
        h = dropout(x + F.gelu(y).transpose(1, 2), m["hidden_dropout"], gen)
        for i in range(self.task["wav2vec_keep_layers"]):
            pre = f"{BB}encoder.layers.{i}."
            hn = self.ln(h, pre + "layer_norm.")
            q, kk, vv = (self.lin(hn, p[f"{pre}attention.{n}_proj.weight"],
                                  p[f"{pre}attention.{n}_proj.bias"])
                         for n in ("q", "k", "v"))
            a = self.attention(q, kk, vv, frame_mask, m["num_attention_heads"])
            a = self.lin(a, p[pre + "attention.out_proj.weight"],
                         p[pre + "attention.out_proj.bias"])
            h = h + dropout(a, m["hidden_dropout"], gen)
            hn = self.ln(h, pre + "final_layer_norm.")
            f = F.gelu(self.lin(hn, p[pre + "feed_forward.intermediate_dense.weight"],
                                p[pre + "feed_forward.intermediate_dense.bias"]))
            f = self.lin(f, p[pre + "feed_forward.output_dense.weight"],
                         p[pre + "feed_forward.output_dense.bias"])
            h = h + dropout(f, m["hidden_dropout"], gen)
        return h, frame_mask

    def head(self, x, out_mask, gen=None):
        """The SFC head: x [B, T, H], key mask ``out_mask`` -> logits [B, T]."""
        p, rate = self.p, (self.task["init_dropout"] if gen is not None
                           else 0.0)
        h = dropout(x, rate, gen)
        hid = h.shape[-1]
        for i in range(self.task["n_transformer_enc_layers"]):
            pre = f"{HEAD}transformer.layers.{i}."
            hn = self.ln(h, pre + "norm1.")
            qkv = self.lin(hn, p[pre + "self_attn.in_proj_weight"],
                           p[pre + "self_attn.in_proj_bias"])
            a = self.attention(qkv[..., :hid], qkv[..., hid:2 * hid],
                               qkv[..., 2 * hid:], out_mask,
                               self.task["n_transformer_enc_heads"])
            a = self.lin(a, p[pre + "self_attn.out_proj.weight"],
                         p[pre + "self_attn.out_proj.bias"])
            h = h + dropout(a, rate, gen)
            hn = self.ln(h, pre + "norm2.")
            f = dropout(F.gelu(self.lin(hn, p[pre + "linear1.weight"],
                                        p[pre + "linear1.bias"])), rate, gen)
            f = self.lin(f, p[pre + "linear2.weight"], p[pre + "linear2.bias"])
            h = h + dropout(f, rate, gen)
        h = self.ln(h, HEAD + "layer_norm.")
        return self.lin(h, p[HEAD + "output_layer.weight"],
                        p[HEAD + "output_layer.bias"])[..., 0]

    def logits(self, audio, in_lengths, out_mask, gen=None,
               backbone_grad=False):
        """Frame logits [B, T_out]: the backbone's hidden states cut or
        zero-padded to ``out_mask``'s width, then the head."""
        with torch.set_grad_enabled(torch.is_grad_enabled() and backbone_grad):
            h, _ = self.backbone(audio, in_lengths, gen)
        t_out = out_mask.shape[1]
        h = h[:, :t_out] if h.shape[1] >= t_out else F.pad(
            h, (0, 0, 0, t_out - h.shape[1]))
        return self.head(h, out_mask, gen)
