"""Kernel mode and per-kernel launch counters.

Counterpart of ``wav2vecsegmenter_tpu/ops/backend.py``.  Two modes:

* ``auto`` (default): CUDA tensors go through the hand-written kernels,
  CPU tensors through the plain PyTorch versions;
* ``eager``: the plain versions everywhere.  Only ever set explicitly — the
  counterpart of the JAX ``runtime.kernels=xla``.

Each kernel wrapper adds one to its counter where it launches its kernel,
and nowhere else, so a run can show that its path really went through the
kernels (``reset_launch_counts`` / ``launch_counts``).

A kernel writes its output through a raw pointer, so autograd sees no graph
behind it.  Every kernel wrapper therefore goes through a
``torch.autograd.Function`` where a gradient is needed (``needs_grad``):
``layer_norm`` and the attentions have backward kernels (K9, K10); the
FFN, the fused conv layers and the conv epilogue replay a plain
composition in the input's type under autograd (:func:`replay_vjp`), as
the JAX package's custom VJPs replay XLA.  No wrapper cuts a gradient.
"""

from __future__ import annotations

import torch

MODES = ("auto", "eager")

_mode = "auto"
_launches: dict[str, int] = {}


def set_kernels(mode: str) -> None:
    global _mode
    if mode not in MODES:
        raise ValueError(f"unknown kernel mode '{mode}' (expected {MODES})")
    _mode = mode


def use_kernel(x: torch.Tensor) -> bool:
    """True where the hand kernel must run: a CUDA tensor under ``auto``."""
    return x.is_cuda and _mode == "auto"


def needs_grad(*tensors) -> bool:
    """True where autograd would record a graph through ``tensors``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def replay_vjp(fn, inputs, needs, g: torch.Tensor) -> tuple:
    """The gradients of ``fn(*inputs)`` against the output gradient ``g``
    (cast to the output's type) for the inputs that ``needs`` marks, by
    autograd through ``fn``, a plain composition; None for the others."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_(n) for a, n in zip(inputs, needs)]
        out = fn(*leaves)
        grads = iter(torch.autograd.grad(
            out, [a for a, n in zip(leaves, needs) if n], g.to(out.dtype)))
    return tuple(next(grads) if n else None for n in needs)


def register_kernel(name: str) -> None:
    _launches.setdefault(name, 0)


def count_launch(name: str) -> None:
    _launches[name] += 1


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(_launches)
