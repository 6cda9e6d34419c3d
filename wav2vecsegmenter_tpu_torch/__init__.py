"""wav2vecsegmenter_tpu_torch — segmentation inference and the
frozen-backbone SFC trainer in PyTorch.

A port of ``wav2vecsegmenter_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
Hopper GPU.  The JAX package stays the reference; this package mirrors its
layout (``ops/``, ``models/``, ``checkpoints/``, ``data/``, ``infer/``,
``train/``, ``eval/``, ``cli/``) so each module's counterpart sits at the
same path.  Every Pallas kernel on those paths, the backward kernels of the
trained head included, has a hand-written CUDA kernel here (``ops/csrc``),
built with ``nvcc`` at first use; on CPU tensors the ops run their plain
PyTorch versions.

This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
