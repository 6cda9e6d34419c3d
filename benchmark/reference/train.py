"""The reference of a training run's first updates, in float32: the
epoch's windows and batches worked out again from the corpus and the
loader's seed, the masked BCE loss, the trained set of the task, and
AdamW with ``update_freq`` accumulation and the cosine schedule
(reference train.py:321-480)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import data
from .model import BB, Reference


class Epoch:
    """One epoch of the random training loader over ``listed`` talks,
    the distinct talks in turn (lib/dataset.py:147-257, 671-734): the
    epoch's seed drawn from the loader's seed, every talk's random grid in
    list order, the windows shuffled, batches of ``batch_size``."""

    def __init__(self, talks: list[dict], listed: int, segment_length: float,
                 batch_size: int, loader_seed: int):
        seed = int(np.random.RandomState(loader_seed).randint(0, 2**31 - 1))
        rng = np.random.RandomState(seed)
        labels = []
        for talk in talks:
            v = np.zeros(talk["samples"], np.uint8)
            for s, e in talk["bursts"]:
                v[s:e] = 1
            labels.append(v)
        self.talks, self.windows = talks, []
        n_pos = n_all = 0
        for k in range(listed):
            f = k % len(talks)
            starts, ends = data.random_grid(talks[f]["samples"],
                                            segment_length, rng)
            for s, e in zip(starts, ends):
                spans = data.window_spans(labels[f][s:e])
                self.windows.append((f, int(s), int(e), spans))
                n_pos += sum(b - a for a, b in spans)
                n_all += int(data.to_out(e - s))
        self.pos_weight = 1.0 - n_pos / max(1, n_all)
        order = np.arange(len(self.windows))
        np.random.RandomState(seed).shuffle(order)
        self.order = order
        self.batch_size = batch_size
        self.bucket = int(data.secs_in(segment_length))
        self._pcm: dict = {}

    def __len__(self) -> int:
        return -(-len(self.windows) // self.batch_size)

    def batch(self, i: int) -> dict:
        win = []
        for j in self.order[i * self.batch_size:(i + 1) * self.batch_size]:
            f, s, e, spans = self.windows[j]
            if f not in self._pcm:
                self._pcm[f] = data.read_wav(self.talks[f]["path"])
            win.append((self._pcm[f][s:e], data.target(spans, e - s),
                        *data.out_span(s, e)))
        return data.batch(win, self.bucket)


def trained_names(names, cfg: dict) -> list[str]:
    """The task's trained set: the head; under LNA also the positional
    conv, SpecAugment's mask vector, and the attention and LayerNorms of
    the top ``wav2vec_ft_layers`` kept layers (lib/models.py:335-365)."""
    task = cfg["task"]
    first = max(0, task["wav2vec_keep_layers"] - task["wav2vec_ft_layers"])
    out = []
    for n in names:
        if n.startswith("seg_model."):
            out.append(n)
        elif not task["finetune_wav2vec"]:
            continue
        elif n.startswith(BB + "encoder.pos_conv_embed.") \
                or n == BB + "masked_spec_embed":
            out.append(n)
        elif n.startswith(BB + "encoder.layers."):
            layer, _, rest = n[len(BB + "encoder.layers."):].partition(".")
            if int(layer) >= first and rest.startswith(
                    ("attention.", "layer_norm.", "final_layer_norm.")):
                out.append(n)
    return out


def norms(named: dict) -> dict:
    """{leaf: L2 norm} of tensors by name; the head's packed QKV leaves
    (``in_proj_weight``, ``in_proj_bias``) as their q, k and v blocks, so
    that a block whose gradient is nought (a key's bias under softmax)
    can be told apart from the rest."""
    out = {}
    for n, t in named.items():
        t = t.detach()
        if n.endswith(("in_proj_weight", "in_proj_bias")):
            for part, block in zip("qkv", t.chunk(3, dim=0)):
                out[f"{n}[{part}]"] = float(block.norm())
        else:
            out[n] = float(t.norm())
    return out


def bce_loss(logits, target, out_mask, pos_weight: float):
    """The masked per-frame BCE with ``pos_weight``, summed over each row,
    meaned over the rows (train.py:408-454)."""
    t = min(logits.shape[1], target.shape[1])
    lpp = F.binary_cross_entropy_with_logits(
        logits[:, :t], target[:, :t], reduction="none",
        pos_weight=torch.tensor(pos_weight, device=logits.device))
    return torch.where(out_mask[:, :t], lpp, 0.0).sum(dim=1).mean()


def run(params: dict, cfg: dict, epoch: Epoch, updates: int,
        update_freq: int, learning_rate: float, max_epochs: int,
        dropout_seed: int, device, quant: bool = False) -> dict:
    """``updates`` optimizer updates of ``update_freq`` micro-steps each
    from ``params``: {"losses": per micro-step, "step_grads": {leaf: the
    first micro-step's gradient}, "grads": {leaf: the first update's
    gradient}, "grad_norms": {leaf: its norm}, "change_norms": {leaf: the
    norm of its change after the last update}, "logits": the first
    update's micro-steps' frame logits, zero off the output mask}."""
    names = trained_names(params, cfg)
    leaves = {n: params[n].detach().clone().requires_grad_(True)
              for n in names}
    model = Reference({**params, **leaves}, cfg, quant)
    total = max(1, int(max_epochs * len(epoch) / update_freq * 1.01))
    opt = torch.optim.AdamW(list(leaves.values()), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    gen = torch.Generator(device=device).manual_seed(dropout_seed)
    acc = {n: torch.zeros_like(p) for n, p in leaves.items()}
    losses, step_grads, grads, logits_out = [], {}, {}, []
    finetune = cfg["task"]["finetune_wav2vec"]
    for u in range(updates):
        for k in range(update_freq):
            b = {n: torch.from_numpy(v).to(device) for n, v in
                 epoch.batch(u * update_freq + k).items()}
            logits = model.logits(b["audio"], b["in_lengths"], b["out_mask"],
                                  gen, backbone_grad=finetune)
            loss = bce_loss(logits, b["target"], b["out_mask"],
                            epoch.pos_weight)
            got = torch.autograd.grad(loss, list(leaves.values()),
                                      allow_unused=True)
            for n, g in zip(leaves, got):
                if g is not None:
                    acc[n] += g
            if u == 0 and k == 0:
                step_grads = {n: torch.zeros_like(p) if g is None else g
                              for (n, p), g in zip(leaves.items(), got)}
            losses.append(float(loss.detach()))
            if u == 0:
                logits_out.append(torch.where(b["out_mask"], logits.detach(),
                                              0.0).cpu())
        lr = learning_rate * 0.5 * (1 + math.cos(math.pi * min(u, total)
                                                 / total))
        for group in opt.param_groups:
            group["lr"] = lr
        for n, p in leaves.items():
            p.grad = acc[n] / update_freq
        if u == 0:
            grads = {n: p.grad for n, p in leaves.items()}
        opt.step()
        for n, p in leaves.items():
            p.grad = None
            acc[n].zero_()
    change = norms({n: p.detach() - params[n] for n, p in leaves.items()})
    return {"losses": losses, "step_grads": step_grads, "grads": grads,
            "grad_norms": norms(grads),
            "change_norms": change, "logits": logits_out}
