"""Counters and spans installed from the benchmark's files around calls
into the program, for the traced run: each call of the kernels whose
rooflines the benchmark reports, with the shapes its bound follows from.
Nothing here changes what a call computes."""

from __future__ import annotations

import contextlib

import torch

from . import peaks


@contextlib.contextmanager
def patched(module, name: str, make):
    """``module.name`` replaced by ``make(original)`` for the block."""
    original = getattr(module, name)
    setattr(module, name, make(original))
    try:
        yield
    finally:
        setattr(module, name, original)


class OpCalls:
    """The self-attention calls (K3 packed in the encoder, K4 in the head)
    made inside ``record`` whose backward (K10) autograd will run: their
    shapes and each call's valid key counts (a device tensor, read after
    the window)."""

    def __init__(self, family) -> None:
        self.family = family
        self.attention: list[tuple[torch.Tensor, int, int]] = []

    def _attn(self, key_mask, b: int, t: int, heads: int, d: int,
              grad: bool, device) -> None:
        if not grad:
            return
        valid = (key_mask.sum(dim=1) if key_mask is not None
                 else torch.full((b,), t, device=device))
        self.attention.append((valid, heads, d))

    @contextlib.contextmanager
    def record(self):
        from wav2vecsegmenter_tpu_torch.models import sfc, wav2vec2
        from wav2vecsegmenter_tpu_torch.ops import backend

        def packed(orig):
            def call(proj, key_mask, num_heads, scale=None):
                b, t, th = proj.shape
                self._attn(key_mask, b, t, num_heads, th // 3 // num_heads,
                           backend.needs_grad(proj), proj.device)
                return orig(proj, key_mask, num_heads, scale)
            return call

        def qkv(orig):
            def call(x, key_mask=None, scale=None):
                b, t, _, heads, d = x.shape
                self._attn(key_mask, b, t, heads, d, backend.needs_grad(x),
                           x.device)
                return orig(x, key_mask, scale)
            return call

        with patched(wav2vec2, "attention_packed", packed), \
                patched(sfc, "attention_qkv", qkv):
            yield

    def bound_ms(self) -> dict:
        """The summed bound (ms) of the recorded calls' backward:
        ``attention_bwd``."""
        total = 0.0
        for valid, heads, d in self.attention:
            ops, nbytes = self.family.attention_cost(valid.tolist(), heads,
                                                     d, backward=True)
            total += peaks.bound(nbytes, ("bf16_tc", ops))[0]
        return {"attention_bwd": total}
