"""One rank of a CPU mesh test: run as a script by ``tests/torch_mesh.py``
(``python tests/torch_mesh_worker.py <job file> <out dir>``) in a gloo
group of the environment's ``W2VSEG_*`` rendezvous.  It imports the port
only (no JAX), on one torch thread; the job file (``torch.save``) names a
scenario of this module and its inputs, and the rank saves what the
scenario returns as ``<out dir>/rank<r>.pt``."""

import os
import sys

import torch

from wav2vecsegmenter_tpu_torch.core import runtime
from wav2vecsegmenter_tpu_torch.models.wav2vec2 import Wav2Vec2Config

# tests/helpers.TINY_W2V, in the port's config class
TINY = dict(hidden_size=64, num_layers=2, num_heads=4, ffn_dim=128,
            conv_dim=(32,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
            conv_stride=(5, 2, 2, 2, 2, 2, 2), conv_bias=True,
            feat_extract_norm="layer", do_stable_layer_norm=True,
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
            hidden_dropout=0.0, attention_dropout=0.0,
            activation_dropout=0.0, feat_proj_dropout=0.0)


def tiny_cfg(**kw) -> Wav2Vec2Config:
    return Wav2Vec2Config(**{**TINY, **kw})


def build(kind: str, cfg_kw: dict, model_kw: dict):
    """The tiny port model of ``kind`` (shas, ssl, arseg)."""
    from wav2vecsegmenter_tpu_torch.models.autoreg import AutoRegSegmenter
    from wav2vecsegmenter_tpu_torch.models.shas import SHAS, SHASWithSSL

    cfg = tiny_cfg(**cfg_kw)
    if kind == "shas":
        return SHAS(**{"wav2vec_keep_layers": 2,
                       "n_transformer_enc_layers": 1,
                       "n_transformer_enc_heads": 4, "init_dropout": 0.0,
                       **model_kw}, w2v_cfg=cfg)
    if kind == "ssl":
        return SHASWithSSL(**{"n_transformer_enc_layers": 1,
                              "n_transformer_enc_heads": 4,
                              "init_dropout": 0.0, **model_kw}, w2v_cfg=cfg)
    return AutoRegSegmenter(**{"wav2vec_keep_layers": 2,
                               "n_transformer_enc_layers": 1,
                               "n_transformer_enc_heads": 4,
                               "n_transformer_dec_layers": 2,
                               "n_transformer_dec_heads": 4,
                               "init_dropout": 0.0, **model_kw}, w2v_cfg=cfg)


def train_steps(job: dict) -> dict:
    """Micro-steps of ``train.step`` on the mesh of ``job["mesh"]``: the
    loss and grad_norm of each, and the whole trained parameters after."""
    from wav2vecsegmenter_tpu_torch.parallel import mesh as pmesh
    from wav2vecsegmenter_tpu_torch.train import loss as tloss
    from wav2vecsegmenter_tpu_torch.train import step as tstep

    if "layer_dropout" in job:
        from wav2vecsegmenter_tpu_torch.models import autoreg

        autoreg.LAYER_DROPOUT = job["layer_dropout"]
    conf = job["mesh"]
    mesh, _, _ = pmesh.resolve_mesh(conf, runtime.world_size(), "cpu")
    model = build(job["kind"], job.get("cfg", {}), job.get("model_kw", {}))
    model.load_state_dict(job["state_dict"])
    model.set_requires_grad()
    pmesh.shard_model(model, mesh)
    fsdp = bool(conf.get("fsdp")) and mesh is not None
    if fsdp:
        pmesh.apply_fsdp(model, mesh)
    params = model.trainable_parameters()
    names = [n for n, _ in model.named_parameters() if model._trains(n)]
    opt = tstep.AccumulatingAdamW(params, job["lr"], job["total_steps"],
                                  job.get("update_freq", 1))
    loss_fn = {"bce": lambda: tloss.BCEWithLogitsLoss(None),
               "ce": lambda: tloss.CrossEntropyLoss(
                   ignore_index=job.get("ignore_index", -100)),
               "ctc": lambda: tloss.CTCLoss(blank=0, reduction="mean")}[
        job["loss"]]()
    vocab = None
    if job.get("vocab"):
        from wav2vecsegmenter_tpu_torch.data import vocab as tvocab

        vocab = {"base": tvocab.BaseVocabulary,
                 "char": tvocab.UppercasedCharVocabulary}[job["vocab"]]()
    gen = torch.Generator().manual_seed(job.get("seed", 0))
    step = tstep.make_train_step(model, loss_fn, job.get("ma", 0), opt,
                                 torch.float32, gen, job["loss"], vocab,
                                 job["kind"] == "arseg", mesh, fsdp)
    out = {"loss": [], "grad_norm": []}
    for batch in job["batches"]:
        m = step(batch, job.get("pos_weight"))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    opt.flush()
    split = pmesh.split_parameters(model)
    out["params"] = {n: pmesh.full_tensor(n, p, split.get(n)).detach()
                     .clone() for n, p in zip(names, params)}
    out["local_shapes"] = {n: tuple((p.to_local() if hasattr(p, "to_local")
                                     else p).shape)
                           for n, p in zip(names, params)}
    return out


def world(job: dict) -> dict:
    """The group this rank joined."""
    import torch.distributed as dist

    return {"rank": runtime.rank(), "world": runtime.world_size(),
            "backend": dist.get_backend()}


def gather_shards(job: dict) -> dict:
    """``parallel.mesh.full_tensor`` of FSDP-placed DTensors (``Shard(0)``
    over the group) of dim-0 sizes ``job["rows"]``, some not divisible by
    the ranks: {rows: (whole tensor, gathered, DTensor.full_tensor)}."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from wav2vecsegmenter_tpu_torch.parallel.mesh import full_tensor

    mesh = init_device_mesh("cpu", (runtime.world_size(),))
    out = {}
    for rows in job["rows"]:
        whole = torch.randn(rows, 3, generator=torch.Generator()
                            .manual_seed(rows))
        t = distribute_tensor(whole, mesh, [Shard(0)], src_data_rank=None)
        out[rows] = (whole, full_tensor("w", t), t.full_tensor())
    return out


def cli(job: dict):
    """A port CLI's ``main(argv)`` in this rank, with the tiny model of
    ``job["kind"]`` built in place of the task's."""
    import importlib

    from wav2vecsegmenter_tpu_torch.cli import common

    kind = job.get("kind", "shas")
    cfg_kw, model_kw = job.get("cfg", {}), job.get("model_kw", {})
    common.build_model = lambda conf, device=None: (
        build(kind, cfg_kw, model_kw).to(device), None)
    if job.get("chdir"):
        os.chdir(job["chdir"])
    main = importlib.import_module(
        f"wav2vecsegmenter_tpu_torch.cli.{job['cli']}").main
    out = main(job["argv"])
    if isinstance(out, dict):
        out = {k: v for k, v in out.items()
               if not isinstance(v, (torch.nn.Module, torch.Generator))}
    return out


def decode(job: dict) -> dict:
    """The autoregressive model's greedy decode and teacher-forced forward
    on ``job["mesh"]`` (float32), each rank's whole outputs."""
    from wav2vecsegmenter_tpu_torch.parallel import mesh as pmesh

    mesh, _, _ = pmesh.resolve_mesh(job["mesh"], runtime.world_size(), "cpu")
    model = build("arseg", job.get("cfg", {}), {})
    model.load_state_dict(job["state_dict"])
    pmesh.shard_model(model.eval(), mesh)
    b = job["batch"]
    audio = torch.from_numpy(b.audio)
    lengths = torch.from_numpy(b.in_lengths)
    with torch.no_grad():
        probs, logits, tokens = model.greedy_decode(
            audio, lengths, b.src_mask.shape[1])
        forced = model(audio, lengths, torch.from_numpy(b.in_target),
                       torch.from_numpy(b.tgt_mask))
    return {"probs": probs, "logits": logits, "tokens": tokens,
            "forced": forced}


class _Crash(Exception):
    pass


def train_loop(job: dict) -> dict:
    """``train.loop.train`` of ``conf/train.yaml`` with ``job["overrides"]``
    under ``job["work"]``, on the tiny SHAS; with ``crash_at``, the run
    stops at that micro-step (a crash) and returns ``{"crashed": True}``."""
    from pathlib import Path

    from wav2vecsegmenter_tpu_torch.config import compose
    from wav2vecsegmenter_tpu_torch.parallel.mesh import (full_tensor,
                                                          split_parameters)
    from wav2vecsegmenter_tpu_torch.train import loop as tloop

    conf_dir = Path(__file__).resolve().parents[1] / "conf"
    config = compose(conf_dir, "train", job["overrides"])
    # the tiny SHAS (32 conv channels) with the task's trainable split
    tloop.build_model = lambda task, device=None: (build("shas", {}, {
        k: task["model"][k] for k in ("finetune_wav2vec", "wav2vec_ft_layers")
        if k in task["model"]}).to(device), None)
    seen = []

    def on_step(metrics):
        seen.append(1)
        if len(seen) == job.get("crash_at"):
            raise _Crash

    try:
        out = tloop.train(config, work_dir=job["work"], on_step=on_step)
    except _Crash:
        return {"crashed": True}
    split = split_parameters(out["model"])
    params = {n: full_tensor(n, p, split.get(n)).detach().clone()
              for n, p in out["model"].named_parameters()}
    return {k: v for k, v in out.items()
            if not isinstance(v, (torch.nn.Module, torch.Generator))
            } | {"params": params}


if __name__ == "__main__":
    torch.set_num_threads(1)
    job_file, out_dir = sys.argv[1], sys.argv[2]
    runtime.maybe_init_distributed("cpu")
    job = torch.load(job_file, weights_only=False)
    result = globals()[job["scenario"]](job)
    torch.save(result, os.path.join(out_dir, f"rank{runtime.rank()}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
