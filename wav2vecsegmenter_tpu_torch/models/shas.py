"""SHAS segmentation model: wav2vec2 backbone + SFC head.

Counterpart of ``wav2vecsegmenter_tpu/models/shas.py``.  The constructor
takes the same kwargs (the reference Hydra surface, ``conf/task/shas.yaml``),
plus an optional ``w2v_cfg`` that replaces the preset's architecture.
Submodules are named ``wav2vec_model.model`` and ``seg_model`` after the
reference checkpoint's full layout, so ``load_state_dict`` takes it as is.

Training covers both arms of the reference's ``finetune_wav2vec``:

* ``False`` (the product's default task, ``conf/task/shas.yaml``): a
  frozen backbone, run in train mode under ``torch.no_grad()`` (the JAX
  ``stop_gradient`` on its output), and a trained SFC head;
* ``True`` (LNA fine-tuning, reference lib/models.py:335-365): the
  backbone under grad, with the JAX ``trainable_mask``'s split as
  ``trainable_parameters``: the head, ``pos_conv``, ``masked_spec_embed``
  where SpecAugment is on, the LayerNorms and attention of the top
  ``wav2vec_ft_layers`` layers, their FFNs with ``finetune_w2v_ffn``, their
  FFN adapters with ``ffn_adapter``, and the conv stack and feature
  projection with ``finetune_w2v_feat_enc`` (without it they run without
  a graph).  ``set_requires_grad`` freezes everything else.

``save_full_state`` says which checkpoint layout a training run writes:
the full model under LNA, the head alone otherwise (reference
train.py:596-613).
"""

from __future__ import annotations

import torch
from torch import nn

from .sfc import SegmentationFrameClassifier
from .wav2vec2 import Wav2Vec2Config, Wav2Vec2Model, config_for


class _Backbone(nn.Module):
    """Holds the backbone under the reference's ``wav2vec_model.model``."""

    def __init__(self, cfg: Wav2Vec2Config, device=None,
                 adapter_from: int = 0):
        super().__init__()
        self.model = Wav2Vec2Model(cfg, device, adapter_from)


class SHAS(nn.Module):
    """Binary segmentation-frame classifier (reference lib/models.py:172-235)."""

    def __init__(
        self,
        wav2vec_model_name: str = "facebook/wav2vec2-xls-r-300m",
        wav2vec_keep_layers: int = 15,
        finetune_wav2vec: bool = False,
        wav2vec_ft_layers: int = 99,
        finetune_w2v_feat_enc: bool = False,
        finetune_w2v_ffn: bool = False,
        ffn_adapter: bool = False,
        n_transformer_enc_layers: int = 1,
        n_transformer_enc_heads: int = 8,
        init_dropout: float = 0.1,
        vocab_size: int = 1,
        *,
        w2v_cfg: Wav2Vec2Config | None = None,
        device=None,
    ) -> None:
        super().__init__()
        self.wav2vec_model_name = wav2vec_model_name
        self.finetune_wav2vec = bool(finetune_wav2vec)
        self.finetune_w2v_feat_enc = bool(finetune_w2v_feat_enc)
        self.finetune_w2v_ffn = bool(finetune_w2v_ffn)
        self.init_dropout = init_dropout
        self.w2v_cfg = w2v_cfg or config_for(
            wav2vec_model_name, wav2vec_keep_layers,
            ffn_adapter=bool(finetune_wav2vec and ffn_adapter))
        self.keep_layers = self.w2v_cfg.num_layers
        # the first fine-tuned layer; adapters live from it on (reference
        # HFWav2Vec2WithAdapter, lib/models.py:443-461)
        self.first_ft_layer = max(0, self.keep_layers - wav2vec_ft_layers)
        self.wav2vec_model = _Backbone(self.w2v_cfg, device,
                                       self.first_ft_layer)
        self.seg_model = SegmentationFrameClassifier(
            self.w2v_cfg.hidden_size, n_transformer_enc_layers,
            n_transformer_enc_heads, vocab_size=vocab_size, device=device)

    def forward(self, audio: torch.Tensor, in_lengths: torch.Tensor,
                out_mask: torch.Tensor, compute_dtype=torch.float32,
                head_dtype=None, residual_dtype=None,
                f32_last_k: int = 0, quantized: list | None = None
                ) -> torch.Tensor:
        """audio [B, L] normalized, in_lengths [B], out_mask [B, T_out] ->
        frame logits [B, T_out] float32.

        The conv stack's true frame count can differ by one from the
        49.95 Hz estimate behind out_mask (reference lib/models.py:222-232):
        the hidden states are cut or zero-padded to T_out.

        ``head_dtype`` / ``residual_dtype`` / ``f32_last_k`` are the
        precision ladder's knobs (``infer.pipeline.resolve_precision``): the
        SFC head's dtype, the encoder's residual-stream and LayerNorm
        dtype, and the number of final encoder layers run in float32.  As
        in the JAX package, ``f32_last_k`` raises on a model whose LNA
        split freezes layers or FFNs.  ``quantized`` holds the encoder's
        int8 layers (``runtime.quantize=int8``, ``ops.quant``).
        """
        if f32_last_k and self.finetune_wav2vec and (
                self.first_ft_layer or not self.finetune_w2v_ffn):
            raise ValueError("f32_last_k is an inference-precision knob; it "
                             "does not compose with LNA freeze splits")
        h, _ = self.wav2vec_model.model(audio, in_lengths, compute_dtype,
                                        residual_dtype=residual_dtype,
                                        f32_last_k=f32_last_k,
                                        quantized=quantized)
        return self.seg_model(_fit(h, out_mask.shape[1]), out_mask,
                              head_dtype or compute_dtype)

    @property
    def save_full_state(self) -> bool:
        """A training run saves the full model (else the head alone)."""
        return self.finetune_wav2vec

    def _trains(self, name: str) -> bool:
        """Whether the parameter ``name`` (a ``named_parameters`` key) is
        in the trainable set: the JAX ``trainable_mask``'s 1 leaves."""
        if name.startswith("seg_model."):
            return True
        if not self.finetune_wav2vec:
            return False
        name = name[len("wav2vec_model.model."):]
        if name.startswith(("feature_extractor.", "feature_projection.")):
            return self.finetune_w2v_feat_enc
        if name == "masked_spec_embed":
            # the JAX tree has the leaf only where SpecAugment is on
            return self.w2v_cfg.apply_spec_augment
        if name.startswith("encoder.pos_conv_embed."):
            return True
        layer, _, rest = name[len("encoder.layers."):].partition(".")
        if int(layer) < self.first_ft_layer:
            return False
        return self.finetune_w2v_ffn or not rest.startswith("feed_forward.")

    def trainable_parameters(self) -> list[nn.Parameter]:
        """The trainable set, in ``named_parameters`` order."""
        return [p for n, p in self.named_parameters() if self._trains(n)]

    def set_requires_grad(self) -> list[nn.Parameter]:
        """Freeze every parameter outside the trainable set (requires_grad
        False, so that it gets no weight-gradient product) and return the
        trainable set."""
        for name, p in self.named_parameters():
            p.requires_grad_(self._trains(name))
        return self.trainable_parameters()

    def train_forward(self, audio: torch.Tensor, in_lengths: torch.Tensor,
                      out_mask: torch.Tensor, generator: torch.Generator,
                      compute_dtype=torch.float32) -> torch.Tensor:
        """The training forward: dropout and SpecAugment drawn from
        ``generator``; the backbone under grad only under
        ``finetune_wav2vec`` -> frame logits [B, T_out] float32."""
        with torch.set_grad_enabled(self.finetune_wav2vec
                                    and torch.is_grad_enabled()):
            h, _ = self.wav2vec_model.model(
                audio, in_lengths, compute_dtype, generator,
                freeze_feature_encoder=not self.finetune_w2v_feat_enc)
        return self.seg_model(_fit(h, out_mask.shape[1]), out_mask,
                              compute_dtype, self.init_dropout, generator)


def _fit(h: torch.Tensor, t_out: int) -> torch.Tensor:
    """Cut or zero-pad the hidden states [B, T_conv, H] to T_out frames."""
    t_conv = h.shape[1]
    if t_conv > t_out:
        return h[:, :t_out]
    if t_conv < t_out:
        return torch.nn.functional.pad(h, (0, 0, 0, t_out - t_conv))
    return h
