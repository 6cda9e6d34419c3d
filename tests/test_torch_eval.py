"""The port's evaluation (``eval.metrics.evaluate``) against the JAX
package's on shared weights: the eval loss is the mean over (talk, pass)
of each one's mean batch loss, as the JAX ``evaluate`` takes it.

The tiny models, the corpus of three talks (13.3 s, 9.1 s and 5.2 s) and
the loss constants are those of tests/test_torch_train.py; both engines
live for the module, so the JAX forward compiles once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vecsegmenter_tpu.data import loader as jloader
from wav2vecsegmenter_tpu.eval.metrics import evaluate as jevaluate
from wav2vecsegmenter_tpu.infer import pipeline as jpipe
from wav2vecsegmenter_tpu.ops.backend import set_backend
from wav2vecsegmenter_tpu.train.loss import BCEWithLogitsLoss as JBCE
from wav2vecsegmenter_tpu_torch.data import loader as tloader
from wav2vecsegmenter_tpu_torch.eval.metrics import evaluate
from wav2vecsegmenter_tpu_torch.infer.pipeline import WindowInference
from wav2vecsegmenter_tpu_torch.train import loss as tloss

from .test_torch_train import LOSS_RTOL, POS_WEIGHT, _models, corpus  # noqa: F401


@pytest.fixture(scope="module")
def engines():
    jm, tm, params = _models()
    engine = WindowInference(tm.eval(), "cpu", torch.float32)
    engine.loss_fn = tloss.BCEWithLogitsLoss(POS_WEIGHT)
    jengine = jpipe.WindowInference(jm, params, compute_dtype=jnp.float32,
                                    loss_fn=JBCE(POS_WEIGHT))
    return engine, jengine


@pytest.mark.parametrize("inference_times", [1, 2])
def test_eval_loss_matches_jax_evaluate(corpus, engines, inference_times):
    """eval_loss over talks of unequal batch counts (batch 2 of 4 s
    windows: 2, 1 and 1 batches a pass).  A mean over every batch of the
    split, as the port took it before, weighs the long talk more."""
    talks, segments = corpus
    engine, jengine = engines
    gen = tloader.FixedDataloaderGenerator(talks, segments, 4, 2,
                                           inference_times=inference_times)
    batches = [len(gen.generate(t, 0)) for t in gen.get_talk_ids()]
    assert len(set(batches)) > 1, batches
    got = evaluate(gen, engine)
    set_backend("xla")
    try:
        jgen = jloader.FixedDataloaderGenerator(
            talks, segments, 4, 2, num_workers=1,
            inference_times=inference_times, device_normalize=True)
        want = jevaluate(jgen, jengine)
    finally:
        set_backend("auto")
    assert set(got) == set(want)
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"],
                               rtol=LOSS_RTOL)
