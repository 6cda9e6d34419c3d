"""Autoregressive segmenter: wav2vec2 backbone + transformer encoder-decoder
over a 4-token vocabulary (``task=arseg``).

Counterpart of ``wav2vecsegmenter_tpu/models/autoreg.py``
(``AutoRegSegmenterImpl``; reference lib/models.py:11-140): the truncated
backbone, then a pre-LN encoder of ``n_transformer_enc_layers`` layers over
its frames, a pre-LN decoder of ``n_transformer_dec_layers`` layers with
causal self-attention over the frame tokens and cross-attention onto the
encoder's output (the memory), the token embedding scaled by sqrt(d) (no
positional encoding and no dropout on it, as the reference's commented-out
PE), and an output projection to the vocabulary.  One LayerNorm is shared:
it closes the encoder and, again, the decoder (reference
lib/models.py:101,123,138).

Module names: the backbone under ``wav2vec_model.model`` (the HF keys, as
in ``SHAS``); the head under ``seg_model``: ``encoder.layers.{i}`` with
``nn.TransformerEncoderLayer``'s names (``self_attn.in_proj_weight``,
``self_attn.out_proj``, ``linear1``, ``linear2``, ``norm1``, ``norm2``),
``decoder.layers.{i}`` with ``nn.TransformerDecoderLayer``'s
(``self_attn``, ``multihead_attn``, ``linear1``, ``linear2``, ``norm1``-
``norm3``), ``embedding``, the shared ``norm`` and ``output_layer``.  The
reference's own wrapper names are not known here
(``checkpoints/convert.py``).

Where the kernels run: every LayerNorm on K1 (its backward K9); the
encoder's self-attention on K4 keyed by the backbone's frame mask; the
decoder's cross-attention on K4 at Tq = T_tgt and Tk = T_mem keyed by the
memory's frame mask (its backward K10, ``ops.attention.attention_cross``);
on a base backbone (768 channels, 8 heads) both run at head dim 96.
The decoder's causal self-attention is plain PyTorch, as the JAX package
computes it in XLA: float32 scores, -1e30 where a key lies in the future
or ``tgt_mask`` is False (a fully masked row then averages uniformly),
softmax, then the cast.  The FFNs are two linears around an exact GELU,
as the JAX ``_ffn_block`` (not K5).  The forward takes ``src_mask``
nowhere: the JAX ``apply`` accepts it and never reads it.

``greedy_decode`` is the inference path (``infer.pipeline``): one token a
frame, KV-cached; the per-step attention is plain, in the compute dtype,
as the JAX decode's einsums are, and its LayerNorms are K1 on [B, d] rows.

The backbone runs without a graph unless ``finetune_wav2vec`` (the JAX
``stop_gradient``); the JAX apply takes no precision-ladder knobs, so
``precision_ladder`` is False and the engine refuses the ladder's middle
arms (the JAX engine ignores them: ROADMAP C17).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import NEG_INF, attention_cross
from ..ops.layernorm import layer_norm
from ..ops.shmap import copy_to_model, reduce_from_model, shard_attention
from .sfc import EPS, SelfAttention, Transformer, encoder_layer, feed_forward
from .shas import _Backbone, _Trainable
from .wav2vec2 import (Wav2Vec2Config, Wav2Vec2Model, _lin, config_for,
                       dropout)

# nn.TransformerEncoderLayer / DecoderLayer's default dropout, which the
# reference leaves as it is (JAX ``_LAYER_DROPOUT``)
LAYER_DROPOUT = 0.1
FFN_DIM = 2048


class DecoderLayer(nn.Module):
    def __init__(self, d_model, ffn_dim, device=None):
        super().__init__()
        self.self_attn = SelfAttention(d_model, device)
        self.multihead_attn = SelfAttention(d_model, device)
        self.linear1 = nn.Linear(d_model, ffn_dim, device=device)
        self.linear2 = nn.Linear(ffn_dim, d_model, device=device)
        self.norm1 = nn.LayerNorm(d_model, device=device)
        self.norm2 = nn.LayerNorm(d_model, device=device)
        self.norm3 = nn.LayerNorm(d_model, device=device)


class Decoder(nn.Module):
    def __init__(self, d_model, n_layers, ffn_dim, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, ffn_dim, device) for _ in range(n_layers))


class EncoderDecoder(nn.Module):
    def __init__(self, d_model: int, n_enc_layers: int, n_enc_heads: int,
                 n_dec_layers: int, n_dec_heads: int, vocab_size: int,
                 ffn_dim: int = FFN_DIM, device=None):
        super().__init__()
        self.n_enc_heads = n_enc_heads
        self.n_dec_heads = n_dec_heads
        self.encoder = Transformer(d_model, n_enc_layers, ffn_dim, device)
        self.decoder = Decoder(d_model, n_dec_layers, ffn_dim, device)
        self.embedding = nn.Embedding(vocab_size, d_model, device=device)
        self.norm = nn.LayerNorm(d_model, device=device)
        self.output_layer = nn.Linear(d_model, vocab_size, device=device)


def _ln(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, norm.weight, norm.bias, EPS)


def _heads(attn: SelfAttention, n_heads: int):
    """(the attention's mesh or None, the rank's head count)."""
    mesh = getattr(attn, "tp_mesh", None)
    return mesh, n_heads // (1 if mesh is None else mesh.n_model)


def _causal_attention(attn: SelfAttention, y: torch.Tensor,
                      tgt_mask: torch.Tensor, n_heads: int, dt
                      ) -> torch.Tensor:
    """The decoder's causal self-attention, plain (JAX ``_attn_block`` with
    ``causal``): float32 scores of q * scale (rounded to ``dt``) against k,
    -1e30 on future keys and keys off ``tgt_mask``, softmax cast to ``dt``
    before the PV product.  Split over a mesh's model axis, on the rank's
    heads."""
    b, t, d = y.shape
    dh = d // n_heads
    mesh, heads = _heads(attn, n_heads)

    def heads_out(y):
        qkv = (y @ attn.in_proj_weight.to(dt).t() + attn.in_proj_bias.to(dt))
        q, k, v = qkv.view(b, t, 3, heads, dh).unbind(2)
        s = torch.einsum("bqhd,bkhd->bhqk", (q * dh ** -0.5).float(),
                         k.float())
        causal = torch.ones(t, t, dtype=torch.bool, device=y.device).tril()
        s = torch.where(causal, s, NEG_INF)
        s = torch.where(tgt_mask[:, None, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1).to(dt)
        out = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, t, heads * dh)
        return out @ attn.out_proj.weight.to(dt).t()

    return shard_attention(heads_out, y, mesh, attn.out_proj.bias.to(dt))


def _cross_attention(attn: SelfAttention, y: torch.Tensor,
                     memory: torch.Tensor, key_mask: torch.Tensor,
                     n_heads: int, dt) -> torch.Tensor:
    """Queries of y [B, T_tgt, d] over the memory [B, T_mem, d] on K4, its
    K/V projection packed [B, T_mem, 2, H, D]; split over a mesh's model
    axis, on the rank's heads (both y and the memory enter the split)."""
    b, tq, d = y.shape
    dh = d // n_heads
    mesh, heads = _heads(attn, n_heads)
    w, bias = attn.in_proj_weight.to(dt), attn.in_proj_bias.to(dt)
    dl = heads * dh

    def heads_out(y, memory):
        q = (y @ w[:dl].t() + bias[:dl]).view(b, tq, heads, dh)
        kv = (memory @ w[dl:].t() + bias[dl:]).view(b, memory.shape[1], 2,
                                                    heads, dh)
        out = attention_cross(q, kv, key_mask, dh ** -0.5)
        return out.reshape(b, tq, dl) @ attn.out_proj.weight.to(dt).t()

    if mesh is None:
        return heads_out(y, memory) + attn.out_proj.bias.to(dt)
    return reduce_from_model(heads_out(copy_to_model(y, mesh),
                                       copy_to_model(memory, mesh)),
                             mesh) + attn.out_proj.bias.to(dt)


class AutoRegSegmenter(_Trainable):
    """Encoder-decoder segmenter (JAX ``AutoRegSegmenterImpl``); the
    constructor takes the reference's Hydra surface
    (``conf/task/arseg.yaml``) plus an optional ``w2v_cfg`` that replaces
    the preset's architecture."""

    precision_ladder = False

    def __init__(
        self,
        wav2vec_model_name: str = "facebook/wav2vec2-xls-r-300m",
        wav2vec_keep_layers: int = 15,
        finetune_wav2vec: bool = False,
        wav2vec_ft_layers: int | None = None,
        finetune_w2v_feat_enc: bool = False,
        n_transformer_enc_layers: int = 1,
        n_transformer_enc_heads: int = 8,
        n_transformer_dec_layers: int = 4,
        n_transformer_dec_heads: int = 8,
        init_dropout: float = 0.1,
        vocab_size: int = 4,
        *,
        w2v_cfg: Wav2Vec2Config | None = None,
        device=None,
    ) -> None:
        super().__init__()
        self.wav2vec_model_name = wav2vec_model_name
        self.finetune_wav2vec = bool(finetune_wav2vec)
        self.init_dropout = init_dropout
        self.vocab_size = vocab_size
        self.w2v_cfg = w2v_cfg or config_for(wav2vec_model_name,
                                             wav2vec_keep_layers)
        self.keep_layers = self.w2v_cfg.num_layers
        self.wav2vec_model = _Backbone(Wav2Vec2Model(self.w2v_cfg, device))
        self.seg_model = EncoderDecoder(
            self.w2v_cfg.hidden_size, n_transformer_enc_layers,
            n_transformer_enc_heads, n_transformer_dec_layers,
            n_transformer_dec_heads, vocab_size, device=device)

    @property
    def backbone(self) -> Wav2Vec2Model:
        return self.wav2vec_model.model

    @property
    def save_full_state(self) -> bool:
        return self.finetune_wav2vec

    def _trains(self, name: str) -> bool:
        """The JAX ``trainable_mask``: the head, and the whole backbone
        under ``finetune_wav2vec`` (``masked_spec_embed`` where SpecAugment
        is on: the JAX tree has the leaf only then)."""
        if name.startswith("seg_model."):
            return True
        if name.endswith("masked_spec_embed"):
            return self.finetune_wav2vec and self.w2v_cfg.apply_spec_augment
        return self.finetune_wav2vec

    def _encode(self, audio, in_lengths, dt, generator=None,
                quantized=None):
        """Backbone -> ``init_dropout`` -> encoder -> shared LayerNorm:
        (memory [B, T_mem, d] in ``dt``, frame_mask [B, T_mem])."""
        with torch.set_grad_enabled(self.finetune_wav2vec
                                    and torch.is_grad_enabled()):
            h, frame_mask = self.backbone(audio, in_lengths, dt, generator,
                                          quantized=quantized)
        seg = self.seg_model
        rate = LAYER_DROPOUT if generator is not None else 0.0
        x = dropout(h.to(dt), self.init_dropout, generator).contiguous()
        for layer in seg.encoder.layers:
            x = encoder_layer(layer, x, frame_mask, seg.n_enc_heads, dt, rate,
                              generator)
        return _ln(seg.norm, x), frame_mask

    def _decode(self, memory, frame_mask, target_in, tgt_mask, dt,
                generator=None) -> torch.Tensor:
        seg = self.seg_model
        d = memory.shape[-1]
        heads = seg.n_dec_heads
        y = (F.embedding(target_in.long(), seg.embedding.weight)
             * math.sqrt(d)).to(dt)

        def drop(x):
            return dropout(x, LAYER_DROPOUT, generator)

        for layer in seg.decoder.layers:
            a = _causal_attention(layer.self_attn, _ln(layer.norm1, y),
                                  tgt_mask, heads, dt)
            y = y + drop(a)
            a = _cross_attention(layer.multihead_attn, _ln(layer.norm2, y),
                                 memory, frame_mask, heads, dt)
            y = y + drop(a)
            f = feed_forward(layer, _ln(layer.norm3, y), dt, LAYER_DROPOUT,
                             generator)
            y = y + drop(f)
        return _lin(seg.output_layer, _ln(seg.norm, y), dt).float()

    def forward(self, audio: torch.Tensor, in_lengths: torch.Tensor,
                target_in: torch.Tensor, tgt_mask: torch.Tensor,
                compute_dtype=torch.float32) -> torch.Tensor:
        """Teacher-forced logits: audio [B, L] normalized, in_lengths [B],
        target_in [B, T_tgt] token ids, tgt_mask [B, T_tgt] (True = a valid
        key) -> [B, T_tgt, V] float32."""
        memory, frame_mask = self._encode(audio, in_lengths, compute_dtype)
        return self._decode(memory, frame_mask, target_in, tgt_mask,
                            compute_dtype)

    def train_forward(self, audio, in_lengths, target_in, tgt_mask,
                      generator: torch.Generator,
                      compute_dtype=torch.float32) -> torch.Tensor:
        """The training forward: the backbone in train mode, ``init_dropout``
        on its output and ``LAYER_DROPOUT`` after each attention, inside
        and after each FFN, all drawn from ``generator``."""
        memory, frame_mask = self._encode(audio, in_lengths, compute_dtype,
                                          generator)
        return self._decode(memory, frame_mask, target_in, tgt_mask,
                            compute_dtype, generator)

    def greedy_decode(self, audio: torch.Tensor, in_lengths: torch.Tensor,
                      t_out: int, compute_dtype=torch.float32,
                      quantized: list | None = None,
                      boundary_id: int = 0, nonboundary_id: int = 1,
                      sep_id: int = 3):
        """KV-cached greedy decode of one token a frame (JAX
        ``greedy_decode``) -> (probs [B, t_out], logits [B, t_out, V]
        float32, tokens [B, t_out]).

        The memory and each layer's cross K/V are computed once.  Step i
        feeds the token decoded at i - 1 (``<SEP>`` at i = 0), writes its
        self-attention K/V into a layer's preallocated [2, B, H, t_out, D]
        cache at i and scores the whole cache, -1e30 past i, so that every
        step has the same shapes.  A decoder split over a mesh's model axis
        runs the rank's heads and F columns, its row-parallel products
        summed over 'model'.  The next token is ``<NB>`` where its logit
        exceeds ``<B>``'s, else ``<B>`` (a tie goes to ``<B>``, as
        ``jnp.argmax`` breaks it); ``probs`` is softmax([l_B, l_NB])[1],
        the in-segment probability.  ``quantized`` holds the backbone
        encoder's int8 layers (``runtime.quantize=int8``)."""
        dt = compute_dtype
        memory, frame_mask = self._encode(audio, in_lengths, dt,
                                          quantized=quantized)
        seg = self.seg_model
        b, _, d = memory.shape
        heads = seg.n_dec_heads
        dh = d // heads
        scale = dh ** -0.5
        dev = memory.device
        layers = []
        for layer in seg.decoder.layers:
            sa, ca = layer.self_attn, layer.multihead_attn
            sa_mesh, sa_heads = _heads(sa, heads)
            ca_mesh, ca_heads = _heads(ca, heads)
            cw, cb = ca.in_proj_weight.to(dt), ca.in_proj_bias.to(dt)
            dl = ca_heads * dh
            kv = (memory @ cw[dl:].t() + cb[dl:]).view(b, -1, 2, ca_heads,
                                                       dh)
            layers.append({
                "layer": layer, "sa": (sa_mesh, sa_heads),
                "ca": (ca_mesh, ca_heads),
                "ff": getattr(layer, "tp_mesh", None),
                "qkv": (sa.in_proj_weight.to(dt).t(),
                        sa.in_proj_bias.to(dt)),
                "o": (sa.out_proj.weight.to(dt).t(), sa.out_proj.bias.to(dt)),
                "cq": (cw[:dl].t(), cb[:dl]),
                "co": (ca.out_proj.weight.to(dt).t(), ca.out_proj.bias.to(dt)),
                # [B, H, T_mem, D]
                "ck": kv[:, :, 0].transpose(1, 2).contiguous(),
                "cv": kv[:, :, 1].transpose(1, 2).contiguous(),
                "w1": (layer.linear1.weight.to(dt).t(),
                       layer.linear1.bias.to(dt)),
                "w2": (layer.linear2.weight.to(dt).t(),
                       layer.linear2.bias.to(dt)),
            })
        out_w = (seg.output_layer.weight.to(dt).t(),
                 seg.output_layer.bias.to(dt))
        emb = (seg.embedding.weight * math.sqrt(d)).to(dt)
        cache = [torch.zeros((2, b, p["sa"][1], t_out, dh), dtype=dt,
                             device=dev) for p in layers]
        pos = torch.arange(t_out, device=dev)
        cross_ok = frame_mask[:, None, :]
        logits = torch.empty((b, t_out, self.vocab_size),
                             dtype=torch.float32, device=dev)
        tokens = torch.empty((b, t_out), dtype=torch.long, device=dev)
        tok = torch.full((b,), sep_id, dtype=torch.long, device=dev)

        def lin(x, wb):
            return x @ wb[0] + wb[1]

        def lin_split(x, wb, mesh):
            """A row-parallel product: the rank's partial, summed over
            'model', then the bias."""
            return reduce_from_model(x @ wb[0], mesh) + wb[1]

        for i in range(t_out):
            y = emb[tok]
            ok = pos <= i
            for li, p in enumerate(layers):
                layer, c = p["layer"], cache[li]
                (sa_mesh, sa_h), (ca_mesh, ca_h) = p["sa"], p["ca"]
                q, k, v = lin(_ln(layer.norm1, y), p["qkv"]).view(
                    b, 3, sa_h, dh).unbind(1)
                c[0, :, :, i] = k
                c[1, :, :, i] = v
                s = torch.einsum("bhd,bhkd->bhk", q * scale, c[0])
                s = torch.softmax(torch.where(ok, s, NEG_INF), dim=-1)
                a = torch.einsum("bhk,bhkd->bhd", s, c[1])
                y = y + lin_split(a.reshape(b, sa_h * dh), p["o"], sa_mesh)
                q = lin(_ln(layer.norm2, y), p["cq"]).view(b, ca_h, dh)
                s = torch.einsum("bhd,bhkd->bhk", q * scale, p["ck"])
                s = torch.softmax(torch.where(cross_ok, s, NEG_INF), dim=-1)
                a = torch.einsum("bhk,bhkd->bhd", s, p["cv"])
                y = y + lin_split(a.reshape(b, ca_h * dh), p["co"], ca_mesh)
                f = F.gelu(lin(_ln(layer.norm3, y), p["w1"]))
                y = y + lin_split(f, p["w2"], p["ff"])
            step = lin(_ln(seg.norm, y), out_w).float()
            tok = torch.where(step[:, nonboundary_id] > step[:, boundary_id],
                              nonboundary_id, boundary_id)
            logits[:, i] = step
            tokens[:, i] = tok
        pair = torch.stack((logits[..., boundary_id],
                            logits[..., nonboundary_id]), dim=-1)
        return torch.softmax(pair, dim=-1)[..., 1], logits, tokens
