"""Seeded random weights, made on the device in a few large calls.

The distribution is that of the port's ``models.wav2vec2.init_from_numpy``
(which draws leaf by leaf on the host): linear and conv weights, linear
biases and the head's packed projection U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
conv biases and LayerNorm biases 0, LayerNorm scales 1, the positional
conv's direction N(0, 0.02) with its gain set to the direction's norm.
The head's output layer is scaled by ``output_gain`` (the configuration
file's ``assumed``), so that the untrained head's probabilities cross the
segmentation threshold within a talk, as chip_smoke.py's slice does.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def _fan_in(model: nn.Module, name: str, p: torch.Tensor) -> int:
    owner = model.get_submodule(name.rpartition(".")[0])
    if isinstance(owner, (nn.Linear, nn.Conv1d)):
        w = owner.weight
        return w.shape[1] * (w.shape[2] if w.dim() == 3 else 1)
    w = getattr(owner, "in_proj_weight", p)   # the head's packed QKV
    return w.shape[-1]


def _kind(model: nn.Module, name: str) -> str:
    owner_name, _, leaf = name.rpartition(".")
    owner = model.get_submodule(owner_name)
    if isinstance(owner, (nn.LayerNorm, nn.GroupNorm)):
        return "one" if leaf == "weight" else "zero"
    if leaf in ("weight_v", "weight_g"):
        return leaf
    if owner_name.endswith("pos_conv_embed.conv") and leaf == "bias":
        return "zero"
    if isinstance(owner, nn.Conv1d) and leaf == "bias":
        return "zero"
    return "uniform"


def state_dict_from_seed(model: nn.Module, seed: int, device,
                         output_gain: float, outliers: dict) -> dict:
    """{name: float32 tensor on ``device``} for every parameter of
    ``model`` (whose own tensors are not touched), from ``seed``: one
    uniform draw and one normal draw for all leaves; ``outliers`` as
    :func:`_outliers`."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    params = list(model.named_parameters())
    kinds = {n: _kind(model, n) for n, _ in params}
    n_uni = sum(p.numel() for n, p in params if kinds[n] == "uniform")
    n_norm = sum(p.numel() for n, p in params if kinds[n] == "weight_v")
    uni = torch.rand(n_uni, generator=g, device=device).mul_(2).sub_(1)
    norm = torch.randn(n_norm, generator=g, device=device).mul_(0.02)
    out, at_u, at_n = {}, 0, 0
    for name, p in params:
        kind = kinds[name]
        if kind == "uniform":
            t = uni[at_u:at_u + p.numel()].view(p.shape)
            t.mul_(1 / math.sqrt(_fan_in(model, name, p)))
            at_u += p.numel()
        elif kind == "weight_v":
            t = norm[at_n:at_n + p.numel()].view(p.shape)
            at_n += p.numel()
        elif kind == "one":
            t = torch.ones(p.shape, device=device)
        else:  # zero; weight_g below
            t = torch.zeros(p.shape, device=device)
        out[name] = t
    for name, t in out.items():
        if kinds[name] == "weight_g":
            v = out[name[:-1] + "v"]
            t.copy_(torch.sqrt(v.square().sum(dim=(0, 1), keepdim=True)))
    for name in out:
        if name.endswith("output_layer.weight"):
            out[name].mul_(output_gain)
    _outliers(out, outliers, g, device)
    return out


# each encoder LayerNorm and the weights that read its output
CONSUMERS = {"layer_norm": ("attention.q_proj", "attention.k_proj",
                            "attention.v_proj"),
             "final_layer_norm": ("feed_forward.intermediate_dense",)}


def _outliers(out: dict, outliers: dict, g, device) -> None:
    """Outlier dimensions, as trained transformers have them (Dettmers et
    al. 2022, LLM.int8()): in every encoder layer a seeded ``share`` of the
    channels of each LayerNorm's scale set to ``gain``, and the same input
    columns of the weights that read its output divided by ``gain``.  The
    model computes the same function, and a product's input rows hold a
    few values ``gain`` times the rest, which is what makes per-row int8
    or fp8 scaling lose precision where bf16 does not."""
    gain = float(outliers["gain"])
    for name in list(out):
        if ".encoder.layers." not in name:
            continue
        prefix, norm, leaf = name.rsplit(".", 2)
        if leaf != "weight" or norm not in CONSUMERS:
            continue
        pick = torch.rand(out[name].shape, generator=g, device=device) \
            < outliers["share"]
        out[name].masked_fill_(pick, gain)
        for consumer in CONSUMERS[norm]:
            out[f"{prefix}.{consumer}.weight"][:, pick] /= gain
