"""Device mesh: data, tensor and FSDP parallelism over a process group.

Counterpart of ``wav2vecsegmenter_tpu/parallel/mesh.py``.  A mesh is a
``torch.distributed`` ``DeviceMesh`` of ``("data", "model")`` dims over the
group's ranks, rank ``r`` at ``(r // n_model, r % n_model)`` as the JAX
package lays devices out, one rank a device:

* **data** - each rank holds its rows of every batch; the gradients are
  summed over 'data' (the loss of each rank is its share of the global
  batch's loss, ``train.step``);
* **model** (``runtime.mesh.model``) - Megatron tensor parallelism over the
  transformer's heads and FFN columns, by the rule of :func:`tp_spec` on
  the reference state_dict names: each rank holds only its slice of a split
  parameter (:func:`shard_model`), and the blocks all-reduce at their exit
  (``ops.shmap``);
* **fsdp** (``runtime.mesh.fsdp``) - torch's ``fully_shard`` over the
  'data' dim (:func:`apply_fsdp`): parameters, gradients and the optimizer
  state live sharded, and are gathered for each forward.

Under gloo (the CPU, or two ranks on one card) the collectives take CUDA
tensors as they are: gloo copies them through the host itself.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch import nn


@dataclasses.dataclass
class Mesh:
    n_data: int
    n_model: int
    data_rank: int
    model_rank: int
    device_mesh: object     # torch.distributed.DeviceMesh ("data", "model")
    data_group: object
    model_group: object


def resolve_mesh(mesh_conf, world_size: int, device_type: str = "cpu"):
    """Validate a ``runtime.mesh`` block against ``world_size`` ranks
    (:func:`mesh_axes`) and build the mesh: ``(mesh_or_None, n_data,
    n_model)``.  A mesh of more than one rank is built over the current
    process group, whose size must be ``data * model``."""
    n_data, n_model = mesh_axes(mesh_conf, world_size)
    if n_data * n_model == 1:
        return None, n_data, n_model
    return make_mesh(n_data, n_model, device_type), n_data, n_model


def mesh_axes(mesh_conf, world_size: int) -> tuple[int, int]:
    """``(n_data, n_model)`` of a ``runtime.mesh`` block on ``world_size``
    ranks, ``data=-1`` taking ``world_size // model``.  An axis the ranks
    cannot satisfy raises, with the JAX ``resolve_mesh``'s messages, never
    a quiet fall back to one rank."""
    conf = mesh_conf or {}
    raw_data, raw_model = conf.get("data", -1), conf.get("model", 1)
    n_data = -1 if raw_data is None else int(raw_data)
    n_model = 1 if raw_model is None else int(raw_model)
    if n_model < 1 or n_data < -1 or n_data == 0:
        raise ValueError(
            f"runtime.mesh: invalid axis sizes data={n_data} model={n_model}")
    if n_model > world_size:
        raise ValueError(
            f"runtime.mesh.model={n_model} exceeds the {world_size} "
            f"available device(s)")
    if n_data == -1:
        n_data = world_size // n_model
    if n_data * n_model > world_size:
        raise ValueError(
            f"runtime.mesh: data={n_data} x model={n_model} = "
            f"{n_data * n_model} devices requested but only "
            f"{world_size} available")
    return n_data, n_model


def make_mesh(n_data: int, n_model: int, device_type: str = "cpu") -> Mesh:
    """The (data, model) mesh over the current process group."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized() or dist.get_world_size() != n_data * n_model:
        have = dist.get_world_size() if dist.is_initialized() else 1
        raise ValueError(
            f"runtime.mesh: data={n_data} x model={n_model} needs a process "
            f"group of {n_data * n_model} ranks, the run has {have} (start "
            f"it through the CLI, torchrun or W2VSEG_COORDINATOR)")
    dm = init_device_mesh(device_type, (n_data, n_model),
                          mesh_dim_names=("data", "model"))
    r = dist.get_rank()
    return Mesh(n_data, n_model, r // n_model, r % n_model, dm,
                dm.get_group("data"), dm.get_group("model"))


def pad_batch_to_devices(batch_size: int, n_devices: int) -> int:
    """Round a batch size up to a device multiple."""
    return ((batch_size + n_devices - 1) // n_devices) * n_devices


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, in place; returns ``t``."""
    dist.all_reduce(t, group=group)
    return t


def _gather_parts(t: torch.Tensor, group) -> list:
    """The ranks' ``t`` of ``group``, in rank order."""
    src = t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return parts


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` of ``group`` concatenated along the leading dim, in
    rank order."""
    return torch.cat(_gather_parts(t, group))


def local_rows(x, mesh: Mesh | None):
    """This data rank's rows of ``x`` (leading dim divisible by
    ``n_data``)."""
    if mesh is None or mesh.n_data == 1:
        return x
    if x.shape[0] % mesh.n_data:
        raise ValueError(f"a batch of {x.shape[0]} rows does not split over "
                         f"{mesh.n_data} data ranks")
    n = x.shape[0] // mesh.n_data
    return x[mesh.data_rank * n:(mesh.data_rank + 1) * n]


# --------------------------------------------------------------------------
# tensor parallelism
# --------------------------------------------------------------------------

# the reference state_dict's module names: column parallel (the output dim
# split, weight and bias), row parallel (the input dim split, the bias
# replicated), and the SFC head's packed q/k/v (three column sections)
_COL = ("q_proj", "k_proj", "v_proj", "intermediate_dense", "down_proj",
        "linear1")
_ROW = ("out_proj", "output_dense", "up_proj", "linear2")
_PACKED = ("in_proj_weight", "in_proj_bias")


def _tp_rule(name: str):
    """``(dim, sections)`` of the rule for the parameter ``name`` (a
    state_dict key, by its last two parts), or None outside it."""
    parts = name.split(".")
    leaf, mod = parts[-1], (parts[-2] if len(parts) > 1 else "")
    if leaf in _PACKED:
        return 0, 3
    if mod in _COL and leaf in ("weight", "bias"):
        return 0, 1
    if mod in _ROW and leaf == "weight":
        return 1, 1
    return None


def tp_spec(name: str, shape, n_model: int):
    """``(dim, sections)`` along which the model axis splits the parameter
    ``name`` (a state_dict key) of ``shape`` - ``sections`` equal parts of
    the dim, each split ``n_model`` ways - or None where it stays
    replicated: everything outside the rule, and a dim the model axis does
    not divide (the JAX ``param_shardings`` fallback)."""
    rule = _tp_rule(name)
    if rule is None or n_model <= 1 or len(shape) <= rule[0] \
            or shape[rule[0]] % (rule[1] * n_model):
        return None
    return rule


def tp_slice(t: torch.Tensor, spec, rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s part of the full tensor ``t`` under ``spec``."""
    dim, sections = spec
    return torch.cat([s.chunk(n, dim)[rank]
                      for s in t.chunk(sections, dim)], dim)


def tp_join(parts: list, spec) -> torch.Tensor:
    """The full tensor from the ranks' parts under ``spec`` (the inverse of
    :func:`tp_slice`)."""
    dim, sections = spec
    split = [p.chunk(sections, dim) for p in parts]
    return torch.cat([torch.cat([s[i] for s in split], dim)
                      for i in range(sections)], dim)


# the blocks that the rule splits, by class: their own parameters, the first
# of which decides (a block is split whole or not at all)
_BLOCKS = {
    "Attention": tuple(f"{m}.{leaf}" for m in ("q_proj", "k_proj", "v_proj")
                       for leaf in ("weight", "bias")) + ("out_proj.weight",),
    "SelfAttention": ("in_proj_weight", "in_proj_bias", "out_proj.weight"),
    "FeedForward": ("intermediate_dense.weight", "intermediate_dense.bias",
                    "output_dense.weight"),
    "Adapter": ("down_proj.weight", "down_proj.bias", "up_proj.weight"),
    "SFCLayer": ("linear1.weight", "linear1.bias", "linear2.weight"),
    "DecoderLayer": ("linear1.weight", "linear1.bias", "linear2.weight"),
}


def _heads_of(block, name: str, model) -> int | None:
    """The head count of an attention block, for the check that the model
    axis divides it."""
    kind = type(block).__name__
    if kind == "Attention":
        return model.w2v_cfg.num_heads
    if kind == "SelfAttention":
        seg = model.seg_model
        if ".decoder." in name:
            return seg.n_dec_heads
        return getattr(seg, "n_enc_heads", getattr(seg, "n_heads", None))
    return None


def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Split ``model``'s parameters over the mesh's model axis in place:
    each block of :data:`_BLOCKS` whose parameters :func:`tp_spec` splits
    keeps this rank's slice of them, with their ``requires_grad``, and is
    marked with ``tp_mesh`` for its forward (``ops.shmap``).  An attention
    block whose head count the axis does not divide stays whole (its
    weights' dims may divide where its heads do not)."""
    if mesh is None or mesh.n_model == 1:
        return model
    for name, block in model.named_modules():
        own = _BLOCKS.get(type(block).__name__)
        if own is None or tp_spec(own[0], block.get_parameter(own[0]).shape,
                                  mesh.n_model) is None:
            continue
        heads = _heads_of(block, name, model)
        if heads is not None and heads % mesh.n_model:
            continue
        for leaf in own:
            p = block.get_parameter(leaf)
            owner, _, attr = leaf.rpartition(".")
            holder = block.get_submodule(owner) if owner else block
            part = tp_slice(p.detach(), _tp_rule(leaf), mesh.model_rank,
                            mesh.n_model)
            setattr(holder, attr, nn.Parameter(part.clone(),
                                               requires_grad=p.requires_grad))
        block.tp_mesh = mesh
    return model


def split_parameters(model: nn.Module) -> dict:
    """{name: mesh} of the model's parameters that this rank holds in
    part (the split blocks' own parameters)."""
    return {f"{name}.{leaf}" if name else leaf: block.tp_mesh
            for name, block in model.named_modules()
            if getattr(block, "tp_mesh", None) is not None
            for leaf in _BLOCKS[type(block).__name__]}


def full_tensor(name: str, t: torch.Tensor, mesh: Mesh | None = None
                ) -> torch.Tensor:
    """The whole of the parameter-shaped tensor ``t`` (a parameter, its
    gradient or an optimizer moment) of the parameter ``name``: FSDP's
    shards gathered, and, with the ``mesh`` of a split parameter, the
    model axis's slices joined.  Every rank of the group takes part."""
    if hasattr(t, "full_tensor"):  # a DTensor (FSDP)
        t = _gather_shards(t)
    if mesh is not None:
        t = tp_join(_gather_parts(t, mesh.model_group),
                    _tp_rule(name))
    return t


def _gather_shards(t) -> torch.Tensor:
    """The whole of an FSDP-sharded DTensor (``Shard(0)`` over a 1-D mesh:
    torch.chunk's split, the last shards short or empty), by a plain
    all_gather of its shards padded to one length.  ``full_tensor`` waits
    on a functional collective, which ends the process under gloo with
    CUDA tensors (SIGSEGV, H100, torch 2.11)."""
    from torch.distributed.tensor import Shard

    if t.device_mesh.ndim != 1 or tuple(t.placements) != (Shard(0),):
        raise NotImplementedError(
            f"a DTensor placed {t.placements} on a {t.device_mesh.ndim}-D "
            f"mesh")
    local = t.to_local()
    group = t.device_mesh.get_group()
    rows = -(-t.shape[0] // dist.get_world_size(group))
    padded = local.new_zeros((rows,) + tuple(t.shape[1:]))
    padded[:local.shape[0]] = local
    return torch.cat(_gather_parts(padded, group))[:t.shape[0]]


def full_state_dict(model: nn.Module, prefix: str = "") -> dict:
    """The whole state_dict of ``model`` on the CPU, in the single-device
    layout; with ``prefix`` only its keys under that prefix, the prefix
    cut.  Every rank takes part in the gathers and gets the same
    tensors."""
    split = split_parameters(model)
    out = {}
    for key, value in model.state_dict(keep_vars=True).items():
        if not key.startswith(prefix):
            continue
        out[key[len(prefix):]] = full_tensor(key, value, split.get(key)) \
            .detach().cpu()
    return out


def local_part(model: nn.Module, name: str, value: torch.Tensor):
    """This rank's part of the whole tensor ``value`` shaped as the
    parameter ``name`` (the parameter, its optimizer moment): its
    model-axis slice where the parameter is split, its FSDP shard (a
    DTensor) where it is sharded, on the parameter's device."""
    p = model.get_parameter(name)
    mesh = split_parameters(model).get(name)
    if mesh is not None:
        value = tp_slice(value, _tp_rule(name), mesh.model_rank,
                         mesh.n_model)
    if hasattr(p, "device_mesh"):  # a DTensor (FSDP)
        from torch.distributed.tensor import distribute_tensor

        # every rank holds the whole value: each cuts its own shard
        return distribute_tensor(value.to(p.to_local().device),
                                 p.device_mesh, p.placements,
                                 src_data_rank=None)
    return value.to(p.device)


def load_full(model: nn.Module, name: str, value: torch.Tensor) -> None:
    """Copy the whole tensor ``value`` into the parameter ``name``, this
    rank's part of it where the parameter is split or sharded."""
    p = model.get_parameter(name)
    part = local_part(model, name, value.to(p.dtype))
    with torch.no_grad():
        p.copy_(part)


# --------------------------------------------------------------------------
# FSDP
# --------------------------------------------------------------------------

def apply_fsdp(model: nn.Module, mesh: Mesh) -> nn.Module:
    """ZeRO-3 over the mesh's 'data' dim through torch's ``fully_shard``
    on the whole model (one group: its forward methods gather every
    parameter once, ``train_forward`` and ``greedy_decode`` included).
    Gradients are summed, not averaged, over 'data' (each rank's loss is
    its share of the global batch's, ``train.step``)."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    fully_shard(model, mesh=mesh.device_mesh["data"])
    for method in ("train_forward", "greedy_decode"):
        if hasattr(model, method):
            register_fsdp_forward_method(model, method)
    model.set_gradient_divide_factor(1.0)
    # plain sums on the wire: gloo has no pre-multiplied sum
    model.set_force_sum_reduction_for_comms(True)
    return model
