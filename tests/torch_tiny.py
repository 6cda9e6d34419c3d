"""The tiny SHAS of ``tests.helpers.tiny_shas`` in both packages, with one
set of weights: JAX ``init`` -> ``export_torch_checkpoint`` (the reference's
full layout) -> the port's ``load_reference_checkpoint``; and a workspace
on which the segment and inference CLIs of both packages run."""

import dataclasses
import importlib
import os
from pathlib import Path

import jax
import pytest
import torch

from wav2vecsegmenter_tpu.checkpoints.torch_export import (
    export_torch_checkpoint)
from wav2vecsegmenter_tpu_torch.checkpoints.convert import (
    load_reference_checkpoint)
from wav2vecsegmenter_tpu_torch.models.shas import SHAS
from wav2vecsegmenter_tpu_torch.models.wav2vec2 import Wav2Vec2Config

from .helpers import TINY_W2V, make_speechlike_wav, tiny_shas


def port_tiny(**kwargs) -> SHAS:
    return SHAS(wav2vec_keep_layers=2, n_transformer_enc_layers=1,
                n_transformer_enc_heads=4, init_dropout=0.0,
                w2v_cfg=Wav2Vec2Config(**dataclasses.asdict(TINY_W2V)),
                **kwargs)


def tiny_pair(ckpt_path, seed: int = 0):
    """(JAX model, its params, the port's model in eval mode) on the same
    weights; the checkpoint is written to ``ckpt_path``."""
    params = jax.device_get(tiny_shas().init(jax.random.PRNGKey(seed)))
    export_torch_checkpoint(params, tiny_shas(finetune_wav2vec=True),
                            ckpt_path)
    model = port_tiny()
    load_reference_checkpoint(ckpt_path, model)
    return tiny_shas(), params, model.eval()


@pytest.fixture(scope="module", autouse=True)
def threads_per_worker():
    """Under pytest-xdist, the port's CPU ops of a module (imported into it)
    on the host's cores divided among the workers (one thread on 8 cores
    and 6 workers): torch's default pool of a thread a core in every worker
    oversubscribes the host, and its threads then wait on each other (a
    training test took 11 times as long beside five busy processes as
    alone, and no longer than alone on one thread; serving tests' many
    small forwards slowed ~20x).  Outside xdist the default stays."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    n = torch.get_num_threads()
    if workers:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(n)


def cli_workspace(ws: Path, talks: dict, seed: int = 7) -> Path:
    """``ws`` holding the talks ({name: seconds}) under ``wav/``, their
    ``orig.yaml``, the tiny model's reference ``ckpt.pt``, a training
    config (``train_config.yaml``) and a training run's layout for the
    inference CLI (``run/.hydra/config.yaml``, ``run/e2e/ckpts/final.pt``)."""
    import yaml

    from wav2vecsegmenter_tpu.config import compose, save_config

    (ws / "wav").mkdir()
    for i, (name, secs) in enumerate(talks.items()):
        make_speechlike_wav(ws / "wav" / name, duration_secs=secs,
                            seed=seed + i)
    with open(ws / "orig.yaml", "w") as f:
        yaml.dump([{"duration": secs, "offset": 0.0, "speaker_id": "NA",
                    "wav": name} for name, secs in talks.items()], f)
    tiny_pair(ws / "ckpt.pt")
    train_cfg = compose(Path(__file__).parents[1] / "conf", "train")
    save_config(train_cfg, ws / "train_config.yaml")
    train_cfg["exp_name"] = "e2e"
    (ws / "run" / "e2e" / "ckpts").mkdir(parents=True)
    (ws / "run" / "e2e" / "ckpts" / "final.pt").write_bytes(
        (ws / "ckpt.pt").read_bytes())
    save_config(train_cfg, ws / "run" / ".hydra" / "config.yaml")
    return ws


@pytest.fixture
def tiny_builders(monkeypatch):
    """Both packages' CLIs build the tiny architecture from the task
    config."""
    from wav2vecsegmenter_tpu.config import registry
    from wav2vecsegmenter_tpu_torch.cli import common

    import tests.helpers as helpers

    monkeypatch.setitem(registry._ALIASES, "lib.models.SHAS",
                        "tests.helpers:_tiny_builder")
    monkeypatch.setattr(helpers, "_tiny_builder",
                        lambda **kwargs: tiny_shas(), raising=False)
    monkeypatch.setattr(common, "build_model",
                        lambda conf, device=None: (port_tiny().to(device),
                                                   None))


# each package's runtime: the JAX engine on its XLA path, the port on the
# CPU (both float32 with runtime.compute_dtype=float32)
JAX_SIDE = ["runtime.kernels=xla"]
PORT_SIDE = ["+runtime.device=cpu"]


def offline_both(ws: Path, cli: str, extra: list,
                 algorithm: str = "pthr") -> dict:
    """{"jax": ..., "port": ...}: (rows, custom_segments.yaml bytes) of the
    ``segment`` or ``inference`` CLI of each package on a
    :func:`cli_workspace`, 4 s windows at batch 3, ``algorithm`` (pTHR by
    default), float32."""
    out = {}
    for side, pkg, own in (("jax", "wav2vecsegmenter_tpu", JAX_SIDE),
                           ("port", "wav2vecsegmenter_tpu_torch", PORT_SIDE)):
        main = importlib.import_module(f"{pkg}.cli.{cli}").main
        d = ws / f"{cli}_{side}_{len(list(ws.glob(f'{cli}_{side}_*')))}"
        args = {"segment": [f"ckpt_path={ws}/ckpt.pt",
                            f"config_path={ws}/train_config.yaml",
                            f"output_dir={d}"],
                "inference": [f"outputs={ws}/run", "ckpt=final.pt"]}[cli]
        rows = main([*args, f"+results_path={d}",
                     f"infer_data.wav_dir={ws}/wav",
                     f"infer_data.orig_seg_yaml={ws}/orig.yaml",
                     "inference_segment_length=4", "batch_size=3",
                     f"algorithm={algorithm}",
                     "runtime.compute_dtype=float32",
                     *extra, *own])
        out[side] = (rows, (d / "custom_segments.yaml").read_bytes())
    return out


# the multi-class SSL model (task=shas_ssl) at the tiny geometry: the JAX
# spec's and the port's constructor kwargs
SSL_KW = dict(n_transformer_enc_layers=1, n_transformer_enc_heads=4,
              init_dropout=0.0)


def jax_tiny_ssl(cfg=TINY_W2V, **kwargs):
    """The JAX ``SHASWithSSL`` at ``cfg`` (its layers cut to
    ``wav2vec_keep_layers`` where given)."""
    from wav2vecsegmenter_tpu.models.shas import SHASWithSSL as JaxSSL

    kwargs = {**SSL_KW, **kwargs}
    model = JaxSSL(**kwargs)
    keep = kwargs.get("wav2vec_keep_layers")
    model.w2v_cfg = dataclasses.replace(
        cfg, num_layers=min(keep or cfg.num_layers, cfg.num_layers))
    model.d_model = cfg.hidden_size
    return model


def port_tiny_ssl(cfg=TINY_W2V, device=None, **kwargs):
    """The port's ``SHASWithSSL`` at the geometry of :func:`jax_tiny_ssl`."""
    from wav2vecsegmenter_tpu_torch.models.shas import SHASWithSSL

    kwargs = {**SSL_KW, **kwargs}
    keep = kwargs.get("wav2vec_keep_layers")
    cfg = dataclasses.replace(
        cfg, num_layers=min(keep or cfg.num_layers, cfg.num_layers))
    return SHASWithSSL(**kwargs, device=device,
                       w2v_cfg=Wav2Vec2Config(**dataclasses.asdict(cfg)))


def ssl_params(model, seed: int = 0) -> dict:
    """JAX ``init`` of an SSL spec as numpy, the final LayerNorm's scale and
    bias drawn away from 1 and 0 so that the parity sees them."""
    import numpy as np

    params = jax.device_get(model.init(jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)
    d = model.d_model
    params["final_ln"] = {
        "scale": (1 + 0.2 * rng.randn(d)).astype(np.float32),
        "bias": (0.1 * rng.randn(d)).astype(np.float32)}
    return params


def tiny_ssl_pair(ckpt_path, seed: int = 0, **kwargs):
    """(JAX SSL spec, its params, the port's SSL model in eval mode) on the
    same weights; the full-layout checkpoint is written to ``ckpt_path``."""
    from wav2vecsegmenter_tpu_torch.checkpoints.convert import (
        state_dict_from_jax_params)

    jm = jax_tiny_ssl(**kwargs)
    params = ssl_params(jm, seed)
    model = port_tiny_ssl(**kwargs)
    torch.save({"state_dict": state_dict_from_jax_params(params, model)},
               str(ckpt_path))
    load_reference_checkpoint(ckpt_path, model)
    return jm, params, model.eval()


# the autoregressive segmenter (task=arseg) at the tiny geometry: 2 backbone
# layers of width 64, a 1-layer encoder and a 2-layer decoder of 4 heads,
# the 4-token vocabulary, no dropout
AR_KW = dict(wav2vec_keep_layers=2, n_transformer_enc_layers=1,
             n_transformer_enc_heads=4, n_transformer_dec_layers=2,
             n_transformer_dec_heads=4, init_dropout=0.0)


def jax_tiny_autoreg(cfg=TINY_W2V, **kwargs):
    """The JAX ``AutoRegSegmenterImpl`` with the backbone ``cfg``."""
    from wav2vecsegmenter_tpu.models.autoreg import AutoRegSegmenterImpl

    model = AutoRegSegmenterImpl(**{**AR_KW, **kwargs})
    model.w2v_cfg = cfg
    model.d_model = cfg.hidden_size
    return model


def port_tiny_autoreg(cfg=TINY_W2V, device=None, **kwargs):
    """The port's ``AutoRegSegmenter`` at the geometry of
    :func:`jax_tiny_autoreg`."""
    from wav2vecsegmenter_tpu_torch.models.autoreg import AutoRegSegmenter

    return AutoRegSegmenter(**{**AR_KW, **kwargs}, device=device,
                            w2v_cfg=Wav2Vec2Config(**dataclasses.asdict(cfg)))


def autoreg_params(model, seed: int = 0) -> dict:
    """JAX ``init`` of an autoregressive spec as numpy, every LayerNorm of
    the head drawn away from scale 1 and bias 0 so that the parity sees
    which is which."""
    import numpy as np

    params = jax.device_get(model.init(jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)

    def jitter(node):
        if isinstance(node, dict):
            if set(node) == {"scale", "bias"}:
                shape = np.shape(node["scale"])
                return {"scale": (1 + 0.2 * rng.randn(*shape)).astype(
                            np.float32),
                        "bias": (0.1 * rng.randn(*shape)).astype(np.float32)}
            return {k: jitter(v) for k, v in node.items()}
        return node

    params["seg"] = jitter(params["seg"])
    return params


def autoreg_pair(cfg=TINY_W2V, seed: int = 0, **kwargs):
    """(JAX spec, its params, the port's model in eval mode) on the same
    weights."""
    from wav2vecsegmenter_tpu_torch.checkpoints.convert import (
        state_dict_from_jax_params)

    jm = jax_tiny_autoreg(cfg, **kwargs)
    params = autoreg_params(jm, seed)
    tm = port_tiny_autoreg(cfg, **kwargs)
    tm.load_state_dict(state_dict_from_jax_params(params, tm), strict=True)
    return jm, params, tm.eval()
