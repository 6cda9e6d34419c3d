"""Operations and bytes of the wav2vec2 + SFC family, from shapes.

A multiply-add counts as two operations.  The counts are what the
algorithm needs for its inputs: attention over the valid keys and queries
of each row, the products of every row the model runs.  Element-wise work
(LayerNorms, GELU, softmax, adds) is not counted: it is bound by bytes,
and the step's share of the peak counts products only, as MFU does.

``cfg`` is a configuration file of ``benchmark/configs`` (its ``model``
and ``task`` nodes).
"""

from __future__ import annotations


def conv_lengths(samples: int, cfg: dict) -> list[int]:
    """Frames after each conv layer (HF ``_get_feat_extract_output_lengths``)."""
    out, n = [], int(samples)
    for k, s in zip(cfg["model"]["conv_kernel"], cfg["model"]["conv_stride"]):
        n = (n - k) // s + 1
        out.append(n)
    return out


def conv_stack_flops(samples: int, cfg: dict) -> float:
    m = cfg["model"]
    c_in, total = 1, 0.0
    for t, c, k in zip(conv_lengths(samples, cfg), m["conv_dim"],
                       m["conv_kernel"]):
        total += 2.0 * t * c * c_in * k
        c_in = c
    return total


def encoder_layer_flops(t: int, h: int, f: int) -> dict:
    """The products of one pre-LN encoder layer over t frames: the fused
    QKV, the attention core (QK^T and PV over all t keys), the output
    projection and the FFN's two GEMMs."""
    return {"qkv": 2.0 * t * h * 3 * h, "attn": 4.0 * t * t * h,
            "out": 2.0 * t * h * h, "ffn": 4.0 * t * h * f}


def window_forward_flops(samples: int, cfg: dict) -> float:
    """One window's forward: conv stack, feature projection, positional
    conv, the kept encoder layers and the SFC head."""
    m, task = cfg["model"], cfg["task"]
    t = conv_lengths(samples, cfg)[-1]
    h = m["hidden_size"]
    pos = 2.0 * t * h * (h // m["num_conv_pos_embedding_groups"]) \
        * m["num_conv_pos_embeddings"]
    proj = 2.0 * t * m["conv_dim"][-1] * h
    layers = task["wav2vec_keep_layers"] * sum(
        encoder_layer_flops(t, h, m["intermediate_size"]).values())
    return conv_stack_flops(samples, cfg) + proj + pos + layers \
        + head_flops(t, cfg)


def head_flops(t: int, cfg: dict) -> float:
    h, task = cfg["model"]["hidden_size"], cfg["task"]
    per = sum(encoder_layer_flops(t, h, task["head_ffn_dim"]).values())
    return task["n_transformer_enc_layers"] * per + 2.0 * t * h


def train_step_flops(batch: int, samples: int, cfg: dict) -> float:
    """One micro-step at ``batch`` windows of ``samples``: the forward,
    and the backward the trained parameters need.  A product whose weight
    trains costs twice its forward in the backward (the input's gradient
    and the weight's), a frozen one on the path to a trained weight once
    (the input's gradient), the attention core twice (dQ, dK, dV and dP);
    nothing below the lowest trained weight runs backward.  Under LNA
    (``finetune_wav2vec``) the attention and the positional conv of every
    kept layer train and the FFNs are frozen; the conv stack and the
    feature projection run without a graph.  Without it only the head
    trains."""
    m, task = cfg["model"], cfg["task"]
    t = conv_lengths(samples, cfg)[-1]
    h = m["hidden_size"]
    fwd = window_forward_flops(samples, cfg)
    head = head_flops(t, cfg)
    bwd = 2.0 * head
    if task["finetune_wav2vec"]:
        layer = encoder_layer_flops(t, h, m["intermediate_size"])
        trained = layer["qkv"] + layer["out"]
        per = 2.0 * trained + 2.0 * layer["attn"] + layer["ffn"]
        pos = 2.0 * t * h * (h // m["num_conv_pos_embedding_groups"]) \
            * m["num_conv_pos_embeddings"]
        bwd += task["wav2vec_keep_layers"] * per + pos   # pos conv: dW only
    return batch * (fwd + bwd)


def attention_cost(valid: list[int], heads: int, d: int,
                   backward: bool = False) -> tuple[float, float]:
    """(operations, bytes) of one attention call (bf16) over rows whose
    valid lengths are ``valid``: QK^T and PV over valid queries and keys,
    q, k, v read and o written once; its backward dV, dP, dQ and dK, and
    q, k, v, o, dO read and dQ, dK, dV written."""
    pairs = sum(n * n for n in valid)
    rows = sum(valid)
    if backward:
        return 8.0 * pairs * heads * d, 2.0 * 8 * rows * heads * d
    return 4.0 * pairs * heads * d, 2.0 * 4 * rows * heads * d
