"""SHAS segmentation model: wav2vec2 backbone + SFC head.

Counterpart of ``wav2vecsegmenter_tpu/models/shas.py``.  The constructor
takes the same kwargs (the reference Hydra surface, ``conf/task/shas.yaml``),
plus an optional ``w2v_cfg`` that replaces the preset's architecture.
Submodules are named ``wav2vec_model.model`` and ``seg_model`` after the
reference checkpoint's full layout, so ``load_state_dict`` takes it as is.

Training covers the product's default task only (``conf/task/shas.yaml``,
``finetune_wav2vec: false``): a frozen backbone and a trained SFC head.
``train_forward`` runs the backbone in train mode under ``torch.no_grad()``
(the JAX ``stop_gradient`` on its output) and the head in train mode;
``trainable_parameters`` is the head's parameters, the counterpart of the
JAX ``trainable_mask``.  Both raise ``NotImplementedError`` under
``finetune_wav2vec=True``: fine-tuning the backbone (LNA) is a later slice.
The fine-tuning flags are accepted for inference, where they do not change
the forward.
"""

from __future__ import annotations

import torch
from torch import nn

from .sfc import SegmentationFrameClassifier
from .wav2vec2 import Wav2Vec2Config, Wav2Vec2Model, config_for


def refuse_finetune(finetune_wav2vec: bool) -> None:
    """Raise for a training run that would fine-tune the backbone."""
    if finetune_wav2vec:
        raise NotImplementedError(
            "training with finetune_wav2vec=True (LNA fine-tuning of the "
            "backbone) is not ported yet; the port trains the SFC head on "
            "a frozen backbone")


class _Backbone(nn.Module):
    """Holds the backbone under the reference's ``wav2vec_model.model``."""

    def __init__(self, cfg: Wav2Vec2Config, device=None):
        super().__init__()
        self.model = Wav2Vec2Model(cfg, device)


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
        self.init_dropout = init_dropout
        self.w2v_cfg = w2v_cfg or config_for(
            wav2vec_model_name, wav2vec_keep_layers,
            ffn_adapter=bool(finetune_wav2vec and ffn_adapter))
        self.keep_layers = self.w2v_cfg.num_layers
        self.wav2vec_model = _Backbone(self.w2v_cfg, device)
        self.seg_model = SegmentationFrameClassifier(
            self.w2v_cfg.hidden_size, n_transformer_enc_layers,
            n_transformer_enc_heads, vocab_size=vocab_size, device=device)

    def forward(self, audio: torch.Tensor, in_lengths: torch.Tensor,
                out_mask: torch.Tensor, compute_dtype=torch.float32,
                head_dtype=None) -> torch.Tensor:
        """audio [B, L] normalized, in_lengths [B], out_mask [B, T_out] ->
        frame logits [B, T_out] float32.

        The conv stack's true frame count can differ by one from the
        49.95 Hz estimate behind out_mask (reference lib/models.py:222-232):
        the hidden states are cut or zero-padded to T_out.
        """
        h, _ = self.wav2vec_model.model(audio, in_lengths, compute_dtype)
        return self.seg_model(_fit(h, out_mask.shape[1]), out_mask,
                              head_dtype or compute_dtype)

    def trainable_parameters(self) -> list[nn.Parameter]:
        """The frozen-backbone trainable set: the SFC head's parameters."""
        refuse_finetune(self.finetune_wav2vec)
        return list(self.seg_model.parameters())

    def train_forward(self, audio: torch.Tensor, in_lengths: torch.Tensor,
                      out_mask: torch.Tensor, generator: torch.Generator,
                      compute_dtype=torch.float32) -> torch.Tensor:
        """The training forward: dropout and SpecAugment drawn from
        ``generator``; no gradient reaches the backbone -> frame logits
        [B, T_out] float32."""
        refuse_finetune(self.finetune_wav2vec)
        with torch.no_grad():
            h, _ = self.wav2vec_model.model(audio, in_lengths, compute_dtype,
                                            generator)
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
