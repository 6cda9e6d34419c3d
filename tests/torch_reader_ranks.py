"""The data ranks of tests/test_torch_reader_native.py: an entry of
``core.runtime.launch_ranks`` (``tests.torch_reader_ranks:data_ranks``)
that imports the port only.  On a gloo mesh of ``data=2`` each rank reads
an epoch of the random generator and the fixed grid, sweeps the talks
through ``cli.common.segment_wavs`` and takes two frozen micro-steps fed
its rows and two fed the whole batches, recording the windows each
dataset read; rank 0 returns every rank's results."""

import json

import torch


def data_ranks(argv: list) -> dict:
    from torch import distributed as dist

    from wav2vecsegmenter_tpu_torch.cli.common import segment_wavs
    from wav2vecsegmenter_tpu_torch.core import runtime
    from wav2vecsegmenter_tpu_torch.data import datasets, loader, windows
    from wav2vecsegmenter_tpu_torch.models.wav2vec2 import init_from_numpy
    from wav2vecsegmenter_tpu_torch.parallel import mesh as pmesh
    from wav2vecsegmenter_tpu_torch.train import loss as tloss
    from wav2vecsegmenter_tpu_torch.train import step as tstep
    from wav2vecsegmenter_tpu_torch.train.loop import data_ranks as ranks_of

    from .torch_mesh_worker import build

    torch.set_num_threads(1)
    runtime.maybe_init_distributed("cpu")
    job = json.loads(argv[0])
    mesh, _, _ = pmesh.resolve_mesh({"data": 2}, runtime.world_size(), "cpu")
    ranks = ranks_of(mesh)
    reads: list = []

    def counted(cls):
        real = cls.__getitem__

        def getitem(self, idx):
            reads.append(int(idx))
            return real(self, idx)

        cls.__getitem__ = getitem

    counted(datasets._GridDataset)
    counted(windows.FixedSegmentationDatasetNoTarget)
    out: dict = {"ranks": ranks}

    gen = loader.RandomDataloaderGenerator(job["talks"], job["segments"], 4,
                                           4, seed=7, **ranks)
    out["random"] = list(gen.generate())
    out["random_reads"], reads[:] = list(reads), []
    fixed = loader.FixedDataloaderGenerator(
        job["talks"], job["segments"], 4, 4, inference_times=2,
        remainder_ladder=True, **ranks)
    out["fixed"] = [list(fixed.generate(t, it))
                    for t in fixed.get_talk_ids() for it in range(2)]
    out["fixed_reads"], reads[:] = list(reads), []

    model = build("shas", {}, {})
    init_from_numpy(model, seed=0)
    probs: dict = {}
    out["rows"] = segment_wavs(model.eval(), job["wavs"], job["algorithm"],
                               3, 4.0, 2, torch.device("cpu"), torch.float32,
                               talk_probs=probs, mesh=mesh)
    out["probs"], out["sweep_reads"] = probs, list(reads)

    # the frozen step on this rank's rows and on the whole batches
    whole = list(loader.RandomDataloaderGenerator(
        job["talks"], job["segments"], 4, 4, seed=7).generate())
    for name, batches in (("step_rows", out["random"]), ("step_whole", whole)):
        init_from_numpy(model, seed=0)
        params = model.set_requires_grad()
        step = tstep.make_train_step(
            model, tloss.BCEWithLogitsLoss(None), 0,
            tstep.AccumulatingAdamW(params, 1e-3, 10, 1), torch.float32,
            torch.Generator().manual_seed(0), mesh=mesh)
        runs = []
        for batch in batches[:2]:
            m = step(batch, 0.5)
            runs.append({"loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]),
                         "rows": vars(m["rows"].numpy())
                         if "rows" in m else {}})
        out[name] = runs
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, out)
    return {"ranks": gathered}
