"""Spawned gloo ranks for the port's CPU mesh tests: :func:`run_ranks`
runs a scenario of ``tests/torch_mesh_worker.py`` in ``n`` processes that
meet at a localhost rendezvous (the ``W2VSEG_COORDINATOR`` contract of
``core.runtime``) and returns each rank's result."""

import os
import subprocess
import sys
import threading
from pathlib import Path

import torch

from wav2vecsegmenter_tpu_torch.core.runtime import _free_port, _wait_all

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_mesh_worker.py")


def run_ranks(job: dict, n: int, tmp: Path, timeout: float = 240.0,
              contract: str = "coordinator") -> list:
    """Rank r's result of ``job`` run on ``n`` gloo ranks, for each r; the
    ranks meet through ``W2VSEG_COORDINATOR`` or, with ``contract="auto"``,
    torchrun's variables under ``W2VSEG_DISTRIBUTED=auto``."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    job_file = tmp / "job.pt"
    torch.save(job, job_file)
    port = _free_port()
    procs = []
    for r in range(n):
        group = ({"W2VSEG_COORDINATOR": f"127.0.0.1:{port}",
                  "W2VSEG_NUM_PROCESSES": str(n),
                  "W2VSEG_PROCESS_ID": str(r)} if contract == "coordinator"
                 else {"W2VSEG_DISTRIBUTED": "auto", "RANK": str(r),
                       "WORLD_SIZE": str(n), "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(port)})
        env = {**os.environ, **group, "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join(
                   [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p])}
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), str(job_file), str(tmp)], env=env,
            cwd=job.get("chdir") or tmp))
    # past the deadline every rank is killed, which fails the wait
    deadline = threading.Timer(timeout, lambda: [
        p.kill() for p in procs if p.poll() is None])
    deadline.start()
    try:
        codes = _wait_all(procs)
    finally:
        deadline.cancel()
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert not any(codes), f"ranks failed: {codes}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(n)]
