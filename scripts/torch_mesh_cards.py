"""The PyTorch port's meshes across the cards of one host, over NCCL.

    python3 scripts/torch_mesh_cards.py     # on a host of 2 or more cards

``chip_smoke.py`` checks the meshes on two gloo ranks of one card; this
script runs them as they run on a host of N cards: one rank a card,
launched by ``core.runtime.launch_ranks``, NCCL.  Prints one JSON line a
part, the cards' name and power limit, and last ``{"ok": true, ...}``;
exits non-zero without two cards or when a check fails.  Parts:

1. segment: ``chip_smoke``'s slice model (xls-r-300m, 15 layers, the SFC
   head, seed 0) on the slice's two talks at batch 14 (rounded up to a
   multiple of the data ranks), data=N and data=N/2 x model=2: the
   probabilities within ``KERNEL_SLACK`` of one card's distance to
   float32 (mean and p99), the sweep's wall against one card's, each
   rank's read + collate ms a batch of the sweep (a data rank reads only
   its rows) against one card's, each rank's ms a batch of 16 windows of
   20 s and, on the model axis, the all-reduces' share of one;
2. train: the train phase's talks of 100 s, ``TALKS_PER_CARD`` a card
   (at least 5 micro-steps a rank on data=N), the head on the frozen
   backbone, one epoch at batch 14 a rank on data=N against one card at
   batch 14 on the same corpus: ms a micro-step, windows a second, and
   the read and fetch ms of a micro-step, each the median of the
   micro-steps after the first ``WARM_STEPS`` on both sides, beside the
   count of micro-steps;
3. lna: one micro-step of conf/task/shas.yaml's LNA split on 4 windows on
   data=N, under FSDP on data=N and under FSDP on data=N/2 x model=2,
   each held to one card's by ``chip_smoke.check_lna_runs``: its loss
   within ``MESH_LOSS_RTOL``, its gradients gathered whole within
   ``KERNEL_SLACK`` of one card's distance to float32, its grad_norm.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

from wav2vecsegmenter_tpu_torch.core import runtime  # noqa: E402
from wav2vecsegmenter_tpu_torch.infer.pipeline import (  # noqa: E402
    WindowInference)
from wav2vecsegmenter_tpu_torch.parallel import mesh as pmesh  # noqa: E402


def batch16():
    """16 windows of 20 s (the full batch's 14 and two padding rows)."""
    from wav2vecsegmenter_tpu_torch.data.windows import BatchIterator

    batch, = BatchIterator(cs.full_batch_examples(), 16, 20.0)
    return batch


# the train part's corpus: talks a card, and the warm-up micro-steps
# (first launches, the reader's start) left out of every median
TALKS_PER_CARD, WARM_STEPS = 16, 2


def train_run(dev, split: dict, root: Path, n_data: int) -> dict:
    """One epoch of the train phase's frozen head at batch 14 a rank: ms
    a micro-step and windows a second, read and fetch ms, each the median
    of the micro-steps after the first ``WARM_STEPS``."""
    from wav2vecsegmenter_tpu_torch.config import Config, merge
    from wav2vecsegmenter_tpu_torch.train.loop import train

    config = merge(Config(), {
        "exp_name": f"cards{n_data}", "batch_size": cs.B,
        "learning_rate": 2.5e-4, "max_epochs": 1, "update_freq": 2,
        "segment_length": cs.TRAIN_WINDOW, "print_every_steps": 100,
        "save_ckpts": False, "task": cs.SHAS_TASK,
        "data": {"train": split, "eval": split},
        "runtime": {"device": dev.type, "compute_dtype": "bfloat16",
                    "kernels": "auto", "seed": 0,
                    "mesh": {"data": n_data, "model": 1}}})
    out = train(config, work_dir=root)
    steps = out["history"]["step_seconds"]
    cs.check(len(steps) >= WARM_STEPS + 3,
             f"train on data={n_data}: {len(steps)} micro-steps, too few "
             "for a median after the warm-up")

    def med(key):
        return float(np.median(out["history"][key][WARM_STEPS:]) * 1e3)

    ms = med("step_seconds")
    return {"micro_steps": len(steps),
            "median_of": len(steps) - WARM_STEPS, "ms_per_micro_step": ms,
            "windows_per_s": cs.B * n_data / ms * 1e3,
            "read_ms": med("read_seconds"), "fetch_ms": med("fetch_seconds"),
            "loss": out["history"]["loss"]}


def cards_rank(argv: list) -> dict:
    """One rank a card (``launch_ranks``): argv = [corpus dir, talks...].
    Rank 0 returns every part's figures."""
    from torch import distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runtime.maybe_init_distributed("cuda")
    dev = runtime.rank_device(torch.device("cuda"))
    n = runtime.world_size()
    root, wavs = Path(argv[0]), [Path(w) for w in argv[1:]]
    out: dict = {"backend": dist.get_backend(), "world": n}
    model = cs.mesh_model(dev).eval()
    batch = batch16()
    for name, conf in (("dp", {"data": n, "model": 1}),
                       ("tp", {"data": n // 2, "model": 2})):
        mesh, _, _ = pmesh.resolve_mesh(conf, n, "cuda")
        if name == "tp":
            pmesh.shard_model(model, mesh)
        cs.mesh_segment(model, wavs, dev, mesh=mesh)
        cs.backend.reset_launch_counts()
        read_s: list = []
        rows, probs, wall = cs.mesh_segment(model, wavs, dev, mesh=mesh,
                                            read_seconds=read_s)
        counts = cs.backend.launch_counts()
        reads = [None] * n
        dist.all_gather_object(reads, float(np.median(read_s)) * 1e3)
        engine = WindowInference(model, dev, torch.bfloat16, mesh=mesh)
        ms = [None] * n
        dist.all_gather_object(ms, cs.time_engine(engine, batch))
        res = {"segments": len(rows), "wall_s": wall, "probs": probs,
               "read_ms_per_batch_per_rank": reads,
               "batch16_ms_per_rank": ms, "launches": counts}
        if name == "tp":
            res["allreduce_share"] = cs.allreduce_share(engine, batch)
        out[name] = res
    del model, engine
    torch.cuda.empty_cache()
    split = {"talk_list": str(root / "talks.tsv"),
             "segments_list": str(root / "segments.tsv"),
             "segment_length": cs.TRAIN_WINDOW}
    out["train"] = train_run(dev, split, root / f"rank{runtime.rank()}", n)
    torch.cuda.empty_cache()
    out.update(cs.mesh_lna_runs(dev, lna_runs(n), n))
    return out


def lna_runs(n: int) -> tuple:
    """The LNA steps on n cards: (name, runtime.mesh, fsdp)."""
    return (("lna_dp", {"data": n, "model": 1}, False),
            ("fsdp", {"data": n, "model": 1}, True),
            ("fsdp_tp", {"data": n // 2, "model": 2}, True))


def main() -> int:
    if torch.cuda.device_count() < 2:
        print("torch_mesh_cards: needs two or more CUDA devices",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    n = torch.cuda.device_count()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start = time.perf_counter()
    cs._build.library()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        wavs = [root / name for name in cs.MESH_TALKS]
        for seed, w in enumerate(wavs):
            cs.write_talk(w, cs.MESH_TALKS[w.name], seed)
        (root / "corpus").mkdir()
        cs.write_corpus(root / "corpus", TALKS_PER_CARD * n)
        # one card: the references
        model = cs.mesh_model(dev).eval()
        cs.mesh_segment(model, wavs, dev)
        one_reads: list = []
        _, one, one_wall = cs.mesh_segment(model, wavs, dev,
                                           read_seconds=one_reads)
        _, f32, _ = cs.mesh_segment(model, wavs, dev, torch.float32)
        one_ms = cs.time_engine(
            WindowInference(model, dev, torch.bfloat16), batch16())
        del model
        torch.cuda.empty_cache()
        split = {"talk_list": str(root / "corpus" / "talks.tsv"),
                 "segments_list": str(root / "corpus" / "segments.tsv"),
                 "segment_length": cs.TRAIN_WINDOW}
        train_one = train_run(dev, split, root / "one", 1)
        torch.cuda.empty_cache()
        ranks = runtime.launch_ranks(
            "scripts.torch_mesh_cards:cards_rank",
            [str(root / "corpus")] + [str(w) for w in wavs], n)
    one_f32 = cs.dprob_to(one, f32)
    for name in ("dp", "tp"):
        run = ranks[name]
        vs = cs.dprob_to(run.pop("probs"), f32)
        for q in ("mean", "p99"):
            cs.check(vs[q] <= cs.KERNEL_SLACK * one_f32[q],
                     f"{name}: {q} dprob to float32 {vs[q]} vs {one_f32[q]}")
        run.update(vs_f32=vs, audio_per_wall=sum(cs.MESH_TALKS.values())
                   / run["wall_s"])
        print(json.dumps({"part": "segment", "mesh": name,
                          "one_card": {"vs_f32": one_f32, "wall_s": one_wall,
                                       "audio_per_wall": sum(
                                           cs.MESH_TALKS.values()) / one_wall,
                                       "read_ms_per_batch": float(np.median(
                                           one_reads)) * 1e3,
                                       "batch16_ms": one_ms}, **run}),
              flush=True)
    print(json.dumps({"part": "train", "one_card": train_one,
                      "mesh": ranks["train"]}), flush=True)
    names = [name for name, _, _ in lna_runs(n)]
    cs.check_lna_runs(ranks, names)
    print(json.dumps({"part": "lna", "one_card": ranks["lna_one"],
                      **{name: ranks[name] for name in names}}), flush=True)
    print(json.dumps({"seconds": time.perf_counter() - start,
                      "backend": ranks["backend"], "world": ranks["world"]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": n}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
