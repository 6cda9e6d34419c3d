"""The tiny SHAS of ``tests.helpers.tiny_shas`` in both packages, with one
set of weights: JAX ``init`` -> ``export_torch_checkpoint`` (the reference's
full layout) -> the port's ``load_reference_checkpoint``."""

import dataclasses

import jax
import pytest
import torch

from wav2vecsegmenter_tpu.checkpoints.torch_export import (
    export_torch_checkpoint)
from wav2vecsegmenter_tpu_torch.checkpoints.convert import (
    load_reference_checkpoint)
from wav2vecsegmenter_tpu_torch.models.shas import SHAS
from wav2vecsegmenter_tpu_torch.models.wav2vec2 import Wav2Vec2Config

from .helpers import TINY_W2V, tiny_shas


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
def one_torch_thread():
    """The port's CPU ops on one thread for a module (imported into it):
    serving tests run many small forwards, which a pool of threads slows
    many times over when test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
