"""The kernels on each rank's shard of a mesh.

Counterpart of ``wav2vecsegmenter_tpu/ops/shmap.py``.  In the JAX package
``shard_map`` splits a kernel's operands over the mesh and runs the
single-device kernel on each shard.  Here each rank already holds only its
shard - its rows of the batch (over 'data', so a row-local op needs no
wrapper) and its slice of a split block's parameters (over 'model',
``parallel.mesh.shard_model``) - and runs the kernels on it as they are.
What is left is the model axis's pair of Megatron functions around a
block, as ``torch.autograd.Function``s: at the entry the identity forward
whose backward all-reduces the input's gradient (:func:`copy_to_model`),
at the exit the all-reduce of the rank's partial output whose backward is
the identity (:func:`reduce_from_model`).  :func:`shard_ffn` and
:func:`shard_attention` put them around K5 and K3 / K4 (K10 under grad).

The global batch's random masks: a mesh step equals the single-device
step on the global batch (the JAX SPMD contract), dropout and SpecAugment
included.  So each rank draws the mask of the whole batch from the run's
generator and takes its rows (:func:`rand_rows`); every rank's generator
then stays in step with every other's.
"""

from __future__ import annotations

import contextlib

import torch

from ..parallel.mesh import all_reduce

# the data rows of the running step: (rank, ranks) on 'data'
_ROWS = (0, 1)


@contextlib.contextmanager
def global_rows(mesh):
    """Within the block, random masks are drawn for the batch of every data
    rank of ``mesh`` (None: this rank's batch is the batch)."""
    global _ROWS
    prev = _ROWS
    _ROWS = (0, 1) if mesh is None else (mesh.data_rank, mesh.n_data)
    try:
        yield
    finally:
        _ROWS = prev


def rand_rows(shape, generator: torch.Generator, device,
              cols: tuple | None = None) -> torch.Tensor:
    """``torch.rand(shape)`` for this rank's rows of the global batch: the
    uniforms of the whole batch [B * ranks, ...] drawn from ``generator``,
    this rank's B rows taken; ``cols`` = (rank, ranks) takes this model
    rank's slice of the last dim too (an activation of a split block)."""
    rank, n = _ROWS
    full = list(shape)
    full[0] *= n
    if cols is not None:
        full[-1] *= cols[1]
    u = torch.rand(full, generator=generator, device=device)
    if n > 1:
        u = u[rank * shape[0]:(rank + 1) * shape[0]]
    if cols is not None and cols[1] > 1:
        w = shape[-1]
        u = u[..., cols[0] * w:(cols[0] + 1) * w]
    return u


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.mesh.model_group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.clone(memory_format=torch.contiguous_format),
                          mesh.model_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """A split block's input: the identity; under grad its gradient is
    summed over 'model'."""
    if mesh is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _CopyToModel.apply(x, mesh)
    return x


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """A split block's output: the ranks' partial sums summed over
    'model'."""
    if mesh is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromModel.apply(x, mesh)
    return all_reduce(x.contiguous(), mesh.model_group)


def tp_cols(mesh):
    """(rank, ranks) on 'model' of a split block's activation columns, for
    :func:`rand_rows`; None outside a split block."""
    return None if mesh is None else (mesh.model_rank, mesh.n_model)


def shard_ffn(fn, x, w1, b1, w2, b2, mesh):
    """``fn`` (K5, or its plain composition) Megatron-split over 'model':
    the rank's F slice (w1 [F/n, H] and b1 rows, w2 [H, F/n] columns) with
    a zero b2, the partials summed over 'model', then b2 added once (the
    JAX ``shard_ffn``).  GELU acts on each F column alone, so it commutes
    with the split.  Without a split (``mesh`` None) this is ``fn``."""
    if mesh is None:
        return fn(x, w1, b1, w2, b2)
    f = fn(copy_to_model(x, mesh), w1, b1, w2, torch.zeros_like(b2))
    return reduce_from_model(f, mesh) + b2.to(f.dtype)


def shard_attention(fn, x, mesh, out_bias, *args):
    """A split attention block's heads: ``fn(copy_to_model(x), *args)``
    runs the projections and the attention kernel (K3, K4; K10 under grad)
    on the rank's heads and returns its partial output projection (without
    its bias), which is summed over 'model' before ``out_bias`` is added
    once.  Without a split this is ``fn(x, *args) + out_bias``."""
    if mesh is None:
        return fn(x, *args) + out_bias
    return reduce_from_model(fn(copy_to_model(x, mesh), *args),
                             mesh) + out_bias
