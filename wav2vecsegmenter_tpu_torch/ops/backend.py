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
behind it.  ``layer_norm`` and the attention of ``[B, T, H, D]`` operands
wrap their kernels in ``torch.autograd.Function``s with backward kernels;
every other kernel wrapper calls :func:`refuse_grad` before it launches, so
that a gradient is never cut silently.
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


def refuse_grad(name: str, *tensors) -> None:
    """Raise where the kernel ``name``, which has no backward yet, would
    cut a gradient: grad mode on and an input that requires grad."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"the {name} kernel has no backward yet (its autograd Function "
            "comes with the LNA fine-tuning slice); run it under "
            "torch.no_grad() or on tensors that do not require grad")


def register_kernel(name: str) -> None:
    _launches.setdefault(name, 0)


def count_launch(name: str) -> None:
    _launches[name] += 1


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(_launches)
