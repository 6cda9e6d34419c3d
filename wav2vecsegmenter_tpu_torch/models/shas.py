"""SHAS segmentation models: wav2vec2 backbone + SFC head.

Counterpart of ``wav2vecsegmenter_tpu/models/shas.py``: ``SHAS`` (the
binary head, or a multi-class head over a vocabulary) and ``SHASWithSSL``
(a CTC backbone and a multi-class head, ``task=shas_ssl`` /
``task=shas_ctc``).  The constructor
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
  where SpecAugment is on, a post-LN backbone's unapplied pre-layers
  ``encoder.layer_norm`` (the JAX ``encoder_pre_ln``: a zero gradient,
  moved by weight decay alone), the LayerNorms and attention of the top
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

from ..ops.layernorm import layer_norm
from .sfc import SegmentationFrameClassifier
from .wav2vec2 import Wav2Vec2Config, Wav2Vec2Model, _lin, config_for


class _Backbone(nn.Module):
    """Holds the backbone under the reference's ``wav2vec_model.model``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model


class _Trainable(nn.Module):
    """The trainable split of a model whose ``_trains(name)`` says which
    parameters the JAX ``trainable_mask`` trains."""

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


class SHAS(_Trainable):
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
        self.vocab_size = vocab_size
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
        self.wav2vec_model = _Backbone(Wav2Vec2Model(
            self.w2v_cfg, device, self.first_ft_layer))
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
    def backbone(self) -> Wav2Vec2Model:
        return self.wav2vec_model.model

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
        if name.startswith(("encoder.pos_conv_embed.", "encoder.layer_norm.")):
            return True
        layer, _, rest = name[len("encoder.layers."):].partition(".")
        if int(layer) < self.first_ft_layer:
            return False
        return self.finetune_w2v_ffn or not rest.startswith("feed_forward.")

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


class _ForCTC(nn.Module):
    """HF ``Wav2Vec2ForCTC``'s layout: the backbone with its final encoder
    LayerNorm under ``wav2vec2``, the CTC head ``lm_head``.

    A post-LN backbone's ``wav2vec2.encoder.layer_norm`` is its pre-layers
    LayerNorm, which the forward does not apply; the final LayerNorm that
    ``SHASWithSSL`` applies is then a parameter of its own,
    ``final_layer_norm`` (the JAX tree's ``final_ln`` beside
    ``wav2vec.encoder_pre_ln``).  An HF snapshot or a reference file has
    the one key ``wav2vec2.encoder.layer_norm``, and the loaders fill both
    from it, as the JAX loader does (``checkpoints.convert``)."""

    def __init__(self, cfg: Wav2Vec2Config, ctc_vocab_size: int,
                 device=None):
        super().__init__()
        self.wav2vec2 = Wav2Vec2Model(cfg, device, final_layer_norm=True)
        self.lm_head = nn.Linear(cfg.hidden_size, ctc_vocab_size,
                                 device=device)
        if not cfg.do_stable_layer_norm:
            self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                                 device=device)

    @property
    def final_ln(self) -> nn.LayerNorm:
        """The final LayerNorm the SSL forward applies."""
        if self.wav2vec2.cfg.do_stable_layer_norm:
            return self.wav2vec2.encoder.layer_norm
        return self.final_layer_norm


class SHASWithSSL(_Trainable):
    """CTC backbone + multi-class SFC head (reference lib/models.py:238-276;
    JAX ``models/shas.py`` ``SHASWithSSL``).

    The backbone is the whole wav2vec2 stack (``wav2vec_keep_layers=None``;
    24 layers for lv60-self; ``task=shas_ctc`` keeps 15) with its final
    encoder LayerNorm (K1) and a CTC ``lm_head``; the SFC head reads the
    post-LayerNorm states fitted to T_out.  The forward returns
    ``(ctc_logits [B, T_conv, ctc_vocab_size], frame_logits [B, T_out,
    vocab_size])``, float32.

    The head always trains; the backbone, the final LayerNorm and
    ``lm_head`` train only under ``finetune_wav2vec`` (then all of them,
    as the JAX ``trainable_mask``), else the backbone runs without a graph
    (the JAX ``stop_gradient``).  ``wav2vec_ft_layers`` and
    ``finetune_w2v_feat_enc`` are accepted for the reference's surface and,
    as in the JAX package, split nothing.  On a base-model backbone
    (post-LN, group-norm conv stack) the applied final LayerNorm is
    ``_ForCTC.final_layer_norm`` and the unapplied pre-layers
    ``encoder.layer_norm`` trains with the backbone (by weight decay alone).

    The JAX ``SHASWithSSL.apply`` takes no precision-ladder knobs, so
    ``precision_ladder`` is False: the engine refuses the ladder's middle
    arms (bf16 and float32 run); int8 (``quantized``) runs.  Module names
    follow the reference's SSL state_dict (``wav2vec_model.model.wav2vec2.
    *``, ``wav2vec_model.model.lm_head.*``, ``seg_model.*``).
    """

    precision_ladder = False

    def __init__(
        self,
        wav2vec_model_name: str = "facebook/wav2vec2-large-960h-lv60-self",
        finetune_wav2vec: bool = False,
        wav2vec_ft_layers: int | None = None,
        finetune_w2v_feat_enc: bool = True,
        n_transformer_enc_layers: int = 1,
        n_transformer_enc_heads: int = 8,
        init_dropout: float = 0.1,
        vocab_size: int = 36,
        ctc_vocab_size: int = 32,
        wav2vec_keep_layers: int | None = None,
        *,
        w2v_cfg: Wav2Vec2Config | None = None,
        device=None,
    ) -> None:
        super().__init__()
        self.wav2vec_model_name = wav2vec_model_name
        self.finetune_wav2vec = bool(finetune_wav2vec)
        self.init_dropout = init_dropout
        self.vocab_size = vocab_size
        self.ctc_vocab_size = ctc_vocab_size
        self.w2v_cfg = w2v_cfg or config_for(wav2vec_model_name,
                                             wav2vec_keep_layers)
        self.keep_layers = self.w2v_cfg.num_layers
        self.wav2vec_model = _Backbone(_ForCTC(self.w2v_cfg, ctc_vocab_size,
                                               device))
        self.seg_model = SegmentationFrameClassifier(
            self.w2v_cfg.hidden_size, n_transformer_enc_layers,
            n_transformer_enc_heads, vocab_size=vocab_size, device=device)

    @property
    def backbone(self) -> Wav2Vec2Model:
        return self.wav2vec_model.model.wav2vec2

    @property
    def save_full_state(self) -> bool:
        return self.finetune_wav2vec

    def forward(self, audio: torch.Tensor, in_lengths: torch.Tensor,
                out_mask: torch.Tensor, compute_dtype=torch.float32,
                quantized: list | None = None):
        """audio [B, L] normalized, in_lengths [B], out_mask [B, T_out] ->
        (ctc_logits, frame_logits); ``quantized`` holds the encoder's int8
        layers."""
        return self._forward(audio, in_lengths, out_mask, compute_dtype,
                             quantized=quantized)

    def train_forward(self, audio, in_lengths, out_mask,
                      generator: torch.Generator, compute_dtype=torch.float32):
        """The training forward: dropout and SpecAugment drawn from
        ``generator``; the backbone under grad only under
        ``finetune_wav2vec``."""
        return self._forward(audio, in_lengths, out_mask, compute_dtype,
                             generator)

    def _forward(self, audio, in_lengths, out_mask, dt, generator=None,
                 quantized=None):
        ctc = self.wav2vec_model.model
        w2v = ctc.wav2vec2
        with torch.set_grad_enabled(self.finetune_wav2vec
                                    and torch.is_grad_enabled()):
            h, _ = w2v(audio, in_lengths, dt, generator, quantized=quantized)
        # HF Wav2Vec2ForCTC: the final encoder LayerNorm, then lm_head, on
        # the float32 hidden states
        ln = ctc.final_ln
        h = layer_norm(h, ln.weight, ln.bias, self.w2v_cfg.layer_norm_eps)
        ctc_logits = _lin(ctc.lm_head, h, torch.float32)
        frame_logits = self.seg_model(
            _fit(h, out_mask.shape[1]), out_mask, dt, self.init_dropout,
            generator)
        return ctc_logits, frame_logits

    def _trains(self, name: str) -> bool:
        if name.startswith("seg_model."):
            return True
        if name.endswith(".masked_spec_embed"):
            # the JAX tree has the leaf only where SpecAugment is on
            return self.finetune_wav2vec and self.w2v_cfg.apply_spec_augment
        return self.finetune_wav2vec


def _fit(h: torch.Tensor, t_out: int) -> torch.Tensor:
    """Cut or zero-pad the hidden states [B, T_conv, H] to T_out frames."""
    t_conv = h.shape[1]
    if t_conv > t_out:
        return h[:, :t_out]
    if t_conv < t_out:
        return torch.nn.functional.pad(h, (0, 0, 0, t_out - t_conv))
    return h
