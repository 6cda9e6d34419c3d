"""The program under test, built from a configuration file of
``benchmark/configs`` through the port's own entry points
(``cli.common.build_model``, the model's ``load_state_dict``), with the
benchmark's seeded weights."""

from __future__ import annotations

from . import weights


def w2v_cfg(cfg: dict):
    """The port's ``Wav2Vec2Config`` of the configuration's backbone, cut
    to the task's kept layers."""
    from wav2vecsegmenter_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    m, t = cfg["model"], cfg["task"]
    return Wav2Vec2Config(
        hidden_size=m["hidden_size"],
        num_layers=min(t["wav2vec_keep_layers"], m["num_hidden_layers"]),
        num_heads=m["num_attention_heads"], ffn_dim=m["intermediate_size"],
        conv_dim=tuple(m["conv_dim"]), conv_kernel=tuple(m["conv_kernel"]),
        conv_stride=tuple(m["conv_stride"]), conv_bias=m["conv_bias"],
        feat_extract_norm=m["feat_extract_norm"],
        do_stable_layer_norm=m["do_stable_layer_norm"],
        num_conv_pos_embeddings=m["num_conv_pos_embeddings"],
        num_conv_pos_embedding_groups=m["num_conv_pos_embedding_groups"],
        hidden_dropout=m["hidden_dropout"],
        attention_dropout=m["attention_dropout"],
        activation_dropout=m["activation_dropout"],
        feat_proj_dropout=m["feat_proj_dropout"],
        layer_norm_eps=m["layer_norm_eps"],
        ffn_adapter=bool(t["finetune_wav2vec"] and t["ffn_adapter"]),
        apply_spec_augment=m["apply_spec_augment"],
        mask_time_prob=m["mask_time_prob"],
        mask_time_length=m["mask_time_length"],
        mask_time_min_masks=m["mask_time_min_masks"])


def build(cfg: dict, seed: int, device):
    """(model, compute dtype, state dict): the task's SHAS built by
    ``cli.common.build_model`` on ``device``, the kernel mode of the
    configuration set, the seeded weights (``weights``) loaded by its
    ``load_state_dict``.  The state dict's tensors stay as drawn: the
    reference reads the same ones."""
    from wav2vecsegmenter_tpu_torch.cli.common import (build_model,
                                                       runtime_device_dtype)
    from wav2vecsegmenter_tpu_torch.ops import backend

    rt = cfg["runtime"]
    backend.set_kernels(rt["kernels"])
    device, dtype = runtime_device_dtype(str(device), rt["compute_dtype"])
    node = {k: v for k, v in cfg["task"].items() if k != "head_ffn_dim"}
    node["_target_"] = "lib.models.SHAS"
    node["w2v_cfg"] = w2v_cfg(cfg)
    model, _ = build_model({"model": node}, device)
    sd = weights.state_dict_from_seed(model, seed, device,
                                      cfg["assumed"]["output_gain"],
                                      cfg["assumed"]["ln_outliers"])
    model.load_state_dict(sd)
    if model.seg_model.transformer.layers[0].linear1.out_features \
            != cfg["task"]["head_ffn_dim"]:
        raise ValueError("the head's FFN width differs from the configuration")
    return model, dtype, sd
