"""The trainer's files: the model checkpoints it rotates and the run state
it resumes from.

Counterpart of the Orbax side of ``wav2vecsegmenter_tpu/checkpoints/io.py``
(the JAX trainer's ``save_orbax`` / ``restore_orbax``), in torch files:

* a model checkpoint is a reference ``.pt``, ``{"state_dict": ...}`` of the
  full model under LNA or of the head alone (``SHAS.save_full_state``;
  reference train.py:596-613), which
  ``checkpoints.convert.load_reference_checkpoint`` reads;
* the run state (``<run>/last_state/state.pt``) holds what the JAX run
  keeps in its ``last_state`` Orbax tree and ``meta.yaml``: the trained
  parameters, the optimizer's state, the dropout generator's state and the
  bookkeeping (epoch, global step, the rotated checkpoints, the best score
  and checkpoint), as plain values, without pyyaml.

Each file is written under a temporary name in its directory and moved into
place with ``os.replace``, so a crash mid-write leaves the previous file
whole.  The JAX package's Orbax checkpoints stay unreadable here; its
``checkpoints/torch_export`` writes the reference ``.pt``.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

STATE_FILE = "state.pt"


def atomic_save(obj, path: str | Path) -> Path:
    """``torch.save`` to ``path`` through a temporary file and
    ``os.replace``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(obj, str(tmp))
    os.replace(tmp, path)
    return path


def model_state_dict(model) -> dict:
    """The layout a training run saves: the full state_dict under LNA, the
    head's alone otherwise, on the CPU; whole on a mesh (split and sharded
    parameters gathered: every rank takes part,
    ``parallel.mesh.full_state_dict``)."""
    from ..parallel.mesh import full_state_dict

    return full_state_dict(model,
                           "" if model.save_full_state else "seg_model.")


def save_model_checkpoint(path: str | Path, model,
                          state_dict: dict | None = None) -> Path:
    """Write ``model``'s checkpoint (or ``state_dict``, one of
    :func:`model_state_dict`) to ``path``."""
    if state_dict is None:
        state_dict = model_state_dict(model)
    return atomic_save({"state_dict": state_dict}, path)


def save_run_state(run_dir: str | Path, state: dict) -> Path:
    return atomic_save(state, Path(run_dir) / STATE_FILE)


def load_run_state(run_dir: str | Path) -> dict | None:
    """The run state in ``run_dir``, its tensors on the CPU; None when the
    run has none."""
    path = Path(run_dir) / STATE_FILE
    if not path.is_file():
        return None
    return torch.load(str(path), map_location="cpu", weights_only=True)
