"""``torch.profiler`` traces of a run (the JAX package's
``jax.profiler.start_trace`` / ``stop_trace``): host (CPU) activity, and
the card's kernels where there is one.  A stopped trace is one Chrome trace
file, ``<dir>/rank<r>.<ns>.pt.trace.json``, written by
``tensorboard_trace_handler``: one file a rank under a mesh."""

from __future__ import annotations

import torch


def start_trace(out_dir):
    """A running trace that writes into ``out_dir`` when stopped."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    from .runtime import rank

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(
                       str(out_dir), worker_name=f"rank{rank()}"))
    prof.start()
    return prof


def stop_trace(prof) -> None:
    """Wait for the card's queued work, stop the trace and write it."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    prof.stop()
