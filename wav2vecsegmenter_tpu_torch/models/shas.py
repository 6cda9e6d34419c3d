"""SHAS segmentation model: wav2vec2 backbone + SFC head.

Counterpart of ``wav2vecsegmenter_tpu/models/shas.py``.  The constructor
takes the same kwargs (the reference Hydra surface, ``conf/task/shas.yaml``),
plus an optional ``w2v_cfg`` that replaces the preset's architecture.
Submodules are named ``wav2vec_model.model`` and ``seg_model`` after the
reference checkpoint's full layout, so ``load_state_dict`` takes it as is.
Inference only: the fine-tuning flags are accepted and do not change the
forward.
"""

from __future__ import annotations

import torch
from torch import nn

from .sfc import SegmentationFrameClassifier
from .wav2vec2 import Wav2Vec2Config, Wav2Vec2Model, config_for


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
        t_out, t_conv = out_mask.shape[1], h.shape[1]
        if t_conv > t_out:
            h = h[:, :t_out]
        elif t_conv < t_out:
            h = torch.nn.functional.pad(h, (0, 0, 0, t_out - t_conv))
        return self.seg_model(h, out_mask, head_dtype or compute_dtype)
