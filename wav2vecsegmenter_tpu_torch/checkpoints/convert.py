"""Weights into the port: JAX parameter trees and reference checkpoints.

* :func:`state_dict_from_jax_params` turns the JAX package's parameter tree
  (numpy leaves; linear weights [in, out], conv weights [k, in, out],
  layers stacked on a leading axis) into this package's state_dict — how
  weights carry across for the parity tests; ``SHAS``'s tree
  ``{wav2vec, seg}`` and ``SHASWithSSL``'s ``{wav2vec, final_ln, lm_head,
  seg}``.
* :func:`load_reference_checkpoint` loads a reference ``.pt`` in both
  layouts (reference train.py:596-613): the full model
  (``wav2vec_model.model.*`` + ``seg_model.*``, with the FFN adapters of
  an LNA run's fine-tuned layers) or the SFC head only, whose backbone
  then comes from a local HF snapshot of the pretrained model (which has
  no adapters: a model with them keeps theirs).  ``SHASWithSSL``'s full
  layout nests the backbone as HF ``Wav2Vec2ForCTC`` does
  (``wav2vec_model.model.wav2vec2.*``, its final encoder LayerNorm, and
  ``wav2vec_model.model.lm_head.*``); its head-only file takes all three
  from a local ForCTC snapshot (JAX ``checkpoints/io.py:104-130``).
  Module names follow those keys, so loading is ``load_state_dict`` as
  is.  On a post-LN backbone (the base models) the ForCTC key
  ``wav2vec2.encoder.layer_norm`` is the unapplied pre-layers LayerNorm
  (the JAX ``wav2vec.encoder_pre_ln``) and the applied final LayerNorm
  (the JAX ``final_ln``) has a key of its own,
  ``wav2vec_model.model.final_layer_norm.*``, which the port's files
  carry; a file without it (an HF snapshot, a reference ``.pt``) fills it
  from the one key, as the JAX loader fills both leaves from it
  (:func:`_fill_final_ln`).  The JAX package reads a port file's one key
  into both leaves, so it does not see a ``final_layer_norm`` trained
  apart from the pre-layers one.

The autoregressive segmenter (``models.autoreg.AutoRegSegmenter``) has
the port's own layout: the backbone under ``wav2vec_model.model.*`` as
above, the head under ``seg_model.*`` named after torch's
``nn.TransformerEncoderLayer`` / ``nn.TransformerDecoderLayer``
(``encoder.layers.{i}.{self_attn,linear1,linear2,norm1,norm2}``,
``decoder.layers.{i}.{self_attn,multihead_attn,linear1,linear2,norm1,
norm2,norm3}``, attention as ``in_proj_weight`` / ``in_proj_bias`` /
``out_proj``), then ``embedding``, the shared ``norm`` and
``output_layer``.  The reference's own wrapper attribute names are not in
this repository, so a reference arseg ``.pt`` is not read yet; the port's
files are, in both layouts (the full model under ``finetune_wav2vec``,
the head alone otherwise, its backbone from a local snapshot or
``allow_random_wav2vec``).
"""

from __future__ import annotations

import logging
import os
import re
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger(__name__)

# SpecAugment's learned vector is unused at inference; files without it load
_OPTIONAL_KEYS = ("masked_spec_embed",)
# a pretrained HF snapshot has no FFN adapters: they start from the init
_ADAPTER = ".ffn_adapter."


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _wav2vec_sd(p: dict, prefix: str) -> dict:
    sd = {}
    for i, layer in enumerate(p["feature_extractor"]["convs"]):
        base = f"{prefix}feature_extractor.conv_layers.{i}"
        sd[f"{base}.conv.weight"] = _t(np.transpose(layer["w"], (2, 1, 0)))
        if "b" in layer:
            sd[f"{base}.conv.bias"] = _t(layer["b"])
        norm = layer.get("ln") or layer.get("gn")  # the base models: "gn"
        if norm is not None:
            sd[f"{base}.layer_norm.weight"] = _t(norm["scale"])
            sd[f"{base}.layer_norm.bias"] = _t(norm["bias"])
    fp = p["feature_projection"]
    sd[f"{prefix}feature_projection.layer_norm.weight"] = _t(fp["ln"]["scale"])
    sd[f"{prefix}feature_projection.layer_norm.bias"] = _t(fp["ln"]["bias"])
    sd[f"{prefix}feature_projection.projection.weight"] = _t(
        np.asarray(fp["proj"]["w"]).T)
    sd[f"{prefix}feature_projection.projection.bias"] = _t(fp["proj"]["b"])
    pc = p["pos_conv"]
    sd[f"{prefix}encoder.pos_conv_embed.conv.weight_g"] = _t(pc["w_g"])
    sd[f"{prefix}encoder.pos_conv_embed.conv.weight_v"] = _t(pc["w_v"])
    sd[f"{prefix}encoder.pos_conv_embed.conv.bias"] = _t(pc["b"])
    if "encoder_pre_ln" in p:  # a post-LN backbone's, never applied
        sd[f"{prefix}encoder.layer_norm.weight"] = _t(
            p["encoder_pre_ln"]["scale"])
        sd[f"{prefix}encoder.layer_norm.bias"] = _t(
            p["encoder_pre_ln"]["bias"])
    if "masked_spec_embed" in p:
        sd[f"{prefix}masked_spec_embed"] = _t(p["masked_spec_embed"])
    layers = p["layers"]
    for i in range(np.asarray(layers["ln1"]["scale"]).shape[0]):
        base = f"{prefix}encoder.layers.{i}"
        for name, key in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                          ("out_proj", "o")):
            lin = layers["attn"][key]
            sd[f"{base}.attention.{name}.weight"] = _t(np.asarray(lin["w"])[i].T)
            sd[f"{base}.attention.{name}.bias"] = _t(np.asarray(lin["b"])[i])
        for name, key in (("layer_norm", "ln1"), ("final_layer_norm", "ln2")):
            sd[f"{base}.{name}.weight"] = _t(np.asarray(layers[key]["scale"])[i])
            sd[f"{base}.{name}.bias"] = _t(np.asarray(layers[key]["bias"])[i])
        for name, key in (("intermediate_dense", "w1"), ("output_dense", "w2")):
            lin = layers["ffn"][key]
            sd[f"{base}.feed_forward.{name}.weight"] = _t(
                np.asarray(lin["w"])[i].T)
            sd[f"{base}.feed_forward.{name}.bias"] = _t(np.asarray(lin["b"])[i])
        adapter = layers.get("adapter")
        if adapter is not None and float(np.asarray(adapter["flag"])[i]) > 0:
            for name, key in (("down_proj", "down"), ("up_proj", "up")):
                lin = adapter[key]
                sd[f"{base}.ffn_adapter.{name}.weight"] = _t(
                    np.asarray(lin["w"])[i].T)
                sd[f"{base}.ffn_adapter.{name}.bias"] = _t(
                    np.asarray(lin["b"])[i])
    return sd


def _attn_sd(attn: dict, i: int, base: str) -> dict:
    """Layer ``i`` of a stacked attention tree (separate q, k, v, o
    linears) -> torch's packed ``in_proj_*`` and ``out_proj``."""
    return {
        f"{base}.in_proj_weight": _t(np.concatenate(
            [np.asarray(attn[x]["w"])[i].T for x in "qkv"], axis=0)),
        f"{base}.in_proj_bias": _t(np.concatenate(
            [np.asarray(attn[x]["b"])[i] for x in "qkv"])),
        f"{base}.out_proj.weight": _t(np.asarray(attn["o"]["w"])[i].T),
        f"{base}.out_proj.bias": _t(np.asarray(attn["o"]["b"])[i]),
    }


def _layers_sd(layers: dict | None, base: str, attns: dict,
               norms: dict) -> dict:
    """A stacked tree of pre-LN transformer layers -> ``{base}.{i}.*`` with
    torch's names: ``attns`` and ``norms`` map them to the tree's keys; the
    FFN is ``linear1`` / ``linear2`` (``w1`` / ``w2``)."""
    sd = {}
    n = 0 if layers is None else np.asarray(layers["ln1"]["scale"]).shape[0]
    for i in range(n):
        for name, key in attns.items():
            sd.update(_attn_sd(layers[key], i, f"{base}.{i}.{name}"))
        for name, key in norms.items():
            sd[f"{base}.{i}.{name}.weight"] = _t(
                np.asarray(layers[key]["scale"])[i])
            sd[f"{base}.{i}.{name}.bias"] = _t(
                np.asarray(layers[key]["bias"])[i])
        for name, key in (("linear1", "w1"), ("linear2", "w2")):
            lin = layers["ffn"][key]
            sd[f"{base}.{i}.{name}.weight"] = _t(np.asarray(lin["w"])[i].T)
            sd[f"{base}.{i}.{name}.bias"] = _t(np.asarray(lin["b"])[i])
    return sd


def _head_out_sd(ln: dict, out: dict, prefix: str, ln_name: str) -> dict:
    return {f"{prefix}{ln_name}.weight": _t(ln["scale"]),
            f"{prefix}{ln_name}.bias": _t(ln["bias"]),
            f"{prefix}output_layer.weight": _t(np.asarray(out["w"]).T),
            f"{prefix}output_layer.bias": _t(out["b"])}


def _sfc_sd(p: dict, prefix: str) -> dict:
    sd = _layers_sd(p.get("layers"), f"{prefix}transformer.layers",
                    {"self_attn": "attn"}, {"norm1": "ln1", "norm2": "ln2"})
    sd.update(_head_out_sd(p["final_ln"], p["out"], prefix, "layer_norm"))
    return sd


def _autoreg_sd(p: dict, prefix: str) -> dict:
    """The JAX autoregressive head ``{encoder, decoder (stacked), tok_emb,
    shared_ln, out}`` -> ``EncoderDecoder``'s state_dict."""
    sd = _layers_sd(p["encoder"], f"{prefix}encoder.layers",
                    {"self_attn": "attn"}, {"norm1": "ln1", "norm2": "ln2"})
    sd.update(_layers_sd(
        p["decoder"], f"{prefix}decoder.layers",
        {"self_attn": "self_attn", "multihead_attn": "cross_attn"},
        {"norm1": "ln1", "norm2": "ln2", "norm3": "ln3"}))
    sd[f"{prefix}embedding.weight"] = _t(p["tok_emb"])
    sd.update(_head_out_sd(p["shared_ln"], p["out"], prefix, "norm"))
    return sd


def state_dict_from_jax_params(np_tree: dict, model) -> dict:
    """JAX SHAS params ({'wav2vec': ..., 'seg': ...}), SHASWithSSL params
    ({'wav2vec', 'final_ln', 'lm_head', 'seg'}) or autoregressive params
    ({'wav2vec', 'seg': {'encoder', 'decoder', 'tok_emb', ...}}), numpy
    leaves -> the state_dict of ``model`` (the port's counterpart)."""
    if "lm_head" in np_tree:
        ctc = "wav2vec_model.model."
        sd = _wav2vec_sd(np_tree["wav2vec"], f"{ctc}wav2vec2.")
        ln = np_tree["final_ln"]
        # a post-LN tree's encoder_pre_ln holds wav2vec2.encoder.layer_norm
        final = ("final_layer_norm" if "encoder_pre_ln" in np_tree["wav2vec"]
                 else "wav2vec2.encoder.layer_norm")
        sd[f"{ctc}{final}.weight"] = _t(ln["scale"])
        sd[f"{ctc}{final}.bias"] = _t(ln["bias"])
        sd[f"{ctc}lm_head.weight"] = _t(np.asarray(np_tree["lm_head"]["w"]).T)
        sd[f"{ctc}lm_head.bias"] = _t(np_tree["lm_head"]["b"])
    else:
        sd = _wav2vec_sd(np_tree["wav2vec"], "wav2vec_model.model.")
    head = _autoreg_sd if "tok_emb" in np_tree["seg"] else _sfc_sd
    sd.update(head(np_tree["seg"], "seg_model."))
    for key, value in model.state_dict().items():
        if key.endswith(_OPTIONAL_KEYS):
            sd.setdefault(key, value.detach().cpu().clone())
    return sd


def _unapplied_keys(module: torch.nn.Module) -> set:
    """The keys of ``module``'s post-LN backbones' pre-layers
    ``encoder.layer_norm``: the forward never applies it, and a reference
    checkpoint lacks it (the reference's truncation replaced it with
    Identity; the JAX converter takes it where it is there)."""
    from ..models.wav2vec2 import Wav2Vec2Model

    return {f"{name}{'.' if name else ''}encoder.layer_norm.{leaf}"
            for name, m in module.named_modules()
            if isinstance(m, Wav2Vec2Model) and not m.cfg.do_stable_layer_norm
            for leaf in ("weight", "bias")}


def _fill_final_ln(module: torch.nn.Module, sd: dict) -> dict:
    """``sd`` with the post-LN ``_ForCTC.final_layer_norm`` keys of
    ``module`` filled from ``wav2vec2.encoder.layer_norm`` where only that
    one key is there (an HF ForCTC snapshot, a reference file): the JAX
    loader reads it into both ``final_ln`` and ``encoder_pre_ln``."""
    from ..models.shas import _ForCTC

    sd = dict(sd)
    for name, m in module.named_modules():
        if isinstance(m, _ForCTC) and hasattr(m, "final_layer_norm"):
            p = f"{name}{'.' if name else ''}"
            for leaf in ("weight", "bias"):
                src = f"{p}wav2vec2.encoder.layer_norm.{leaf}"
                if src in sd:
                    sd.setdefault(f"{p}final_layer_norm.{leaf}", sd[src])
    return sd


def _load_strict(module: torch.nn.Module, sd: dict,
                 adapters_optional: bool = False) -> None:
    """load_state_dict(strict=True), except that the optional keys (and,
    with ``adapters_optional``, the FFN adapters, and a post-LN backbone's
    unapplied ``encoder.layer_norm``) may be absent from ``sd``; a post-LN
    SSL backbone's final LayerNorm comes from ``wav2vec2.encoder.layer_norm``
    where the file has no key of its own for it."""
    sd = _fill_final_ln(module, sd)
    missing, unexpected = module.load_state_dict(sd, strict=False)
    unapplied = _unapplied_keys(module)
    missing = [k for k in missing if not k.endswith(_OPTIONAL_KEYS)
               and not (adapters_optional and _ADAPTER in k)
               and k not in unapplied]
    if missing or unexpected:
        raise KeyError(f"checkpoint does not fit the model: missing "
                       f"{missing}, unexpected {unexpected}")


def _rename_weight_norm(sd: dict) -> dict:
    """Newer HF/torch weight-norm names -> weight_g / weight_v."""
    out = {}
    for k, v in sd.items():
        k = k.replace("conv.parametrizations.weight.original0", "conv.weight_g")
        k = k.replace("conv.parametrizations.weight.original1", "conv.weight_v")
        out[k] = v
    return out


def is_full_layout(sd: dict) -> bool:
    """True if the checkpoint carries wav2vec weights (full layout)."""
    return any(k.startswith("wav2vec_model.") for k in sd)


def hf_local_snapshot(model_name: str) -> Path | None:
    """A locally cached or downloaded HF model dir with weights, or None
    (no network)."""
    hf_home = os.environ.get("HF_HOME",
                             os.path.expanduser("~/.cache/huggingface"))
    repo = Path(hf_home) / "hub" / ("models--" + model_name.replace("/", "--"))
    candidates = sorted((repo / "snapshots").glob("*")) if repo.exists() else []
    candidates.append(Path(model_name))
    for c in candidates:
        if c.is_dir() and ((c / "pytorch_model.bin").exists()
                           or (c / "model.safetensors").exists()):
            return c
    return None


def backbone_state_dict(model_dir: Path, num_layers: int,
                        ctc: bool = False, post_ln: bool = False) -> dict:
    """HF Wav2Vec2Model / ForCTC weights -> the backbone's state_dict,
    truncated to ``num_layers`` encoder layers (the final encoder LayerNorm,
    quantizer and heads are dropped, as the reference truncation does;
    ``post_ln``, a base model's, keeps its pre-layers ``encoder.layer_norm``,
    which the backbone holds and does not apply).
    With ``ctc``, a ForCTC snapshot -> the ``_ForCTC`` state_dict of
    ``SHASWithSSL``: the backbone under ``wav2vec2.`` with its final
    encoder LayerNorm, and ``lm_head``."""
    if (model_dir / "model.safetensors").exists():
        from safetensors.torch import load_file

        sd = load_file(str(model_dir / "model.safetensors"))
    else:
        sd = torch.load(str(model_dir / "pytorch_model.bin"),
                        map_location="cpu", weights_only=True)
    prefix = "wav2vec2." if any(k.startswith("wav2vec2.") for k in sd) else ""
    keep = re.compile(r"^(feature_extractor\.|feature_projection\."
                      r"|encoder\.pos_conv_embed\.|masked_spec_embed$"
                      r"|encoder\.layers\.(\d+)\."
                      + (r"|encoder\.layer_norm\." if ctc or post_ln
                         else "") + ")")
    sd = _rename_weight_norm(sd)
    out = {}
    for k, v in sd.items():
        if not k.startswith(prefix):
            continue
        k = k[len(prefix):]
        m = keep.match(k)
        if m and (m.group(2) is None or int(m.group(2)) < num_layers):
            out[k] = v
    if not ctc:
        return out
    out = {f"wav2vec2.{k}": v for k, v in out.items()}
    out.update({k: v for k, v in sd.items() if k.startswith("lm_head.")})
    return out


def load_pretrained_backbone(model) -> bool:
    """Load ``model``'s backbone (``SHASWithSSL``'s: with its final encoder
    LayerNorm and ``lm_head``) from a local HF snapshot of
    ``model.wav2vec_model_name``; False (nothing loaded) without one."""
    snap = hf_local_snapshot(model.wav2vec_model_name)
    if snap is None:
        return False
    logger.info("Loading wav2vec2 weights from %s", snap)
    ctc = hasattr(model, "ctc_vocab_size")
    _load_strict(model.wav2vec_model.model,
                 backbone_state_dict(
                     snap, model.keep_layers, ctc,
                     not model.w2v_cfg.do_stable_layer_norm),
                 adapters_optional=True)
    return True


def load_reference_checkpoint(path, model, allow_random_wav2vec: bool = False):
    """Load a reference ``.pt`` (either layout) into ``model`` in place.

    A seg-only file takes the backbone (for ``SHASWithSSL`` also the final
    encoder LayerNorm and ``lm_head``) from a local HF snapshot of
    ``model.wav2vec_model_name``; without one it raises unless
    ``allow_random_wav2vec``, which keeps a seeded random backbone."""
    ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    sd = _rename_weight_norm(sd)
    if is_full_layout(sd):
        _load_strict(model, sd)
        return model
    _load_strict(model.seg_model, sd)
    if load_pretrained_backbone(model):
        return model
    if allow_random_wav2vec:
        from ..models.wav2vec2 import init_from_numpy

        logger.warning("No local weights for %s — using a RANDOM wav2vec2 "
                       "backbone (allow_random_wav2vec).",
                       model.wav2vec_model_name)
        init_from_numpy(model.wav2vec_model.model, seed=0)
    else:
        raise FileNotFoundError(
            f"No local HF weights found for '{model.wav2vec_model_name}'. "
            "Place the model under $HF_HOME/hub or pass a local directory.")
    return model
