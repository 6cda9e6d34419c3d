"""Process-level runtime: the process group of a multi-rank run.

Counterpart of ``maybe_init_distributed`` of
``wav2vecsegmenter_tpu/core/runtime.py``, with its environment contract:

* ``W2VSEG_COORDINATOR=host:port`` with ``W2VSEG_NUM_PROCESSES=N`` and
  ``W2VSEG_PROCESS_ID=i``: an explicit rendezvous at ``tcp://host:port``;
* ``W2VSEG_DISTRIBUTED=auto``: ``env://``, torchrun's ``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``;
* neither: a single process, nothing to do.

Torch's idiom is one process a device, where one JAX process drives every
chip of its host.  So a CLI that starts outside a group while its
``runtime.mesh`` asks for more than one rank launches one rank a device
(:func:`launch_ranks`): child processes that meet at a localhost
rendezvous through the same contract and run the same CLI call.  The
group's backend is NCCL for a CUDA run and gloo for a CPU run, or for a
CUDA run whose ranks on this host outnumber its cards (NCCL refuses two
ranks on one device).
"""

from __future__ import annotations

import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

_ROOT = Path(__file__).resolve().parents[2]


def backend_for(device_type: str, world: int) -> str:
    """NCCL for a CUDA run whose ranks on this host (``LOCAL_WORLD_SIZE``,
    as torchrun and :func:`launch_ranks` set it, else the group's
    ``world``) each have a card of their own; gloo otherwise."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return "nccl" if device_type == "cuda" \
        and local <= torch.cuda.device_count() else "gloo"


def maybe_init_distributed(device_type: str = "cuda") -> bool:
    """Join the process group that the environment describes (module
    docstring), once; True if the run has more than one process."""
    if not dist.is_available():
        return False
    if not dist.is_initialized():
        coord = os.environ.get("W2VSEG_COORDINATOR")
        auto = os.environ.get("W2VSEG_DISTRIBUTED", "").lower() == "auto"
        if coord:
            world = int(os.environ["W2VSEG_NUM_PROCESSES"])
            dist.init_process_group(
                backend_for(device_type, world), init_method=f"tcp://{coord}",
                world_size=world, rank=int(os.environ["W2VSEG_PROCESS_ID"]))
        elif auto:
            dist.init_process_group(
                backend_for(device_type, int(os.environ["WORLD_SIZE"])),
                init_method="env://")
        else:
            return False
    return dist.get_world_size() > 1


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def is_rank0() -> bool:
    return rank() == 0


def rank_device(device: torch.device) -> torch.device:
    """This rank's device: a CUDA run in a group takes ``cuda:LOCAL_RANK``
    (or its rank), modulo the host's devices (two ranks may share one
    card over gloo); any other run ``device``."""
    if device.type != "cuda" or device.index is not None \
            or not (dist.is_available() and dist.is_initialized()):
        return device
    index = int(os.environ.get("LOCAL_RANK", rank())) \
        % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def host_ranks(mesh_conf, device_type: str) -> int:
    """The ranks this host offers a mesh outside a group: one a CUDA
    device; on the CPU as many as ``mesh_conf`` asks for (one data rank
    for ``data=-1``)."""
    if device_type == "cuda":
        return max(1, torch.cuda.device_count())
    conf = mesh_conf or {}
    n_data = int(conf.get("data", -1) if conf.get("data") is not None
                 else -1)
    n_model = int(conf.get("model") or 1)
    return max(1, n_data) * max(1, n_model)


def mesh_ranks(mesh_conf, device_type: str) -> int:
    """The rank count a ``runtime.mesh`` block asks for on this host,
    validated as ``parallel.mesh.resolve_mesh`` validates it."""
    from ..parallel.mesh import mesh_axes

    n_data, n_model = mesh_axes(mesh_conf, host_ranks(mesh_conf,
                                                      device_type))
    return n_data * n_model


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(entry: str, argv: list[str], n: int):
    """Run ``entry`` (``"module:function"``, called with ``argv``) in ``n``
    child processes that form a group at a localhost rendezvous, rank i on
    local device i; wait for all of them and return rank 0's result.  A
    rank that fails fails the call, and the others are stopped."""
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        result = Path(tmp) / "result.pt"
        procs = []
        for i in range(n):
            env = dict(os.environ)
            env.update({
                "W2VSEG_COORDINATOR": f"127.0.0.1:{port}",
                "W2VSEG_NUM_PROCESSES": str(n),
                "W2VSEG_PROCESS_ID": str(i), "LOCAL_RANK": str(i),
                "LOCAL_WORLD_SIZE": str(n),
                "W2VSEG_RANK_ENTRY": entry,
                "W2VSEG_RANK_ARGV": json.dumps(list(argv)),
                "W2VSEG_RANK_RESULT": str(result),
                "PYTHONPATH": os.pathsep.join(
                    [str(_ROOT)] + [p for p in [env.get("PYTHONPATH")]
                                    if p])})
            procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 "from wav2vecsegmenter_tpu_torch.core.runtime import "
                 "rank_main; rank_main()"], env=env))
        codes = _wait_all(procs)
        if any(codes):
            raise RuntimeError(f"{entry} failed on its ranks (exit codes "
                               f"{codes})")
        return torch.load(str(result), weights_only=False)


def _wait_all(procs) -> list[int]:
    """Wait for every process; once one fails, stop the rest."""
    codes: list = [None] * len(procs)
    while any(c is None for c in codes):
        for i, p in enumerate(procs):
            if codes[i] is None:
                try:
                    codes[i] = p.wait(timeout=0.2)
                except subprocess.TimeoutExpired:
                    continue
                if codes[i]:
                    for q in procs:
                        if q.poll() is None:
                            q.terminate()
    return codes


def rank_main() -> None:
    """A child of :func:`launch_ranks`: run its entry in the group; rank
    0 saves the entry's result (less its modules and generators, a
    trained model's objects)."""
    module, _, fn = os.environ["W2VSEG_RANK_ENTRY"].partition(":")
    argv = json.loads(os.environ["W2VSEG_RANK_ARGV"])
    out = getattr(importlib.import_module(module), fn)(argv)
    if isinstance(out, dict):
        out = {k: v for k, v in out.items()
               if not isinstance(v, (torch.nn.Module, torch.Generator))}
    if rank() == 0:
        torch.save(out, os.environ["W2VSEG_RANK_RESULT"])
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
