"""The port's precision ladder (``runtime.precision``) against the JAX
package's: the arms resolve to the same knobs, every arm's logits equal the
JAX engine's at float32, the casts sit where the JAX encoder puts them
(bf16 on the CPU), and ``f32_last_k`` refuses a freezing split.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vecsegmenter_tpu.data.collate import collate as jax_collate
from wav2vecsegmenter_tpu.infer import pipeline as jpipe
from wav2vecsegmenter_tpu.ops.backend import set_backend
from wav2vecsegmenter_tpu_torch.data.collate import collate
from wav2vecsegmenter_tpu_torch.infer import pipeline as tpipe
from wav2vecsegmenter_tpu_torch.models import sfc, wav2vec2

from .helpers import tiny_shas
from .torch_tiny import threads_per_worker, port_tiny, tiny_pair  # noqa: F401

ARMS = ("bf16", "f32head", "f32res", "f32last1", "f32last2", "f32")
LOGITS_ATOL = 2e-4  # float32 engines, the port's model tolerance


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return tiny_pair(tmp_path_factory.mktemp("precision") / "ckpt.pt")


def _examples():
    rng = np.random.RandomState(3)
    wavs = [rng.randn(n).astype(np.float32) * 0.1 for n in (16000, 11000)]
    return [(w, None, 0, int(len(w) * 49.95 / 16000)) for w in wavs]


@pytest.mark.parametrize("arm", ARMS + (None, "f32last4"))
def test_resolve_precision_maps_arms_as_jax(arm):
    jdt, jkw = jpipe.resolve_precision(arm, jnp.bfloat16)
    dt, kw = tpipe.resolve_precision(arm, torch.bfloat16)
    as_name = {jnp.bfloat16: "bfloat16", jnp.float32: "float32",
               torch.bfloat16: "bfloat16", torch.float32: "float32"}
    assert as_name[dt] == as_name[jdt]
    assert kw.keys() == jkw.keys()
    for key, value in jkw.items():
        assert (as_name[kw[key]] == as_name[value] if key.endswith("dtype")
                else kw[key] == value)


def test_unknown_arm_raises_as_jax():
    for resolve, dt in ((jpipe.resolve_precision, jnp.bfloat16),
                        (tpipe.resolve_precision, torch.bfloat16)):
        with pytest.raises(ValueError, match="runtime.precision"):
            resolve("f16", dt)
    with pytest.raises(ValueError):
        tpipe.WindowInference(port_tiny(), "cpu", precision="f16")


class _LogitsSpy:
    """Stands in for the engine's model: records each call's logits."""

    def __init__(self, model):
        self.model, self.logits = model, []

    def __call__(self, *args, **kwargs):
        out = self.model(*args, **kwargs)
        self.logits.append(out.numpy().copy())
        return out


@pytest.mark.parametrize("arm", ARMS)
def test_every_arm_matches_jax_logits_at_f32(pair, arm):
    jm, params, model = pair
    jbatch = jax_collate(_examples(), 2, 16000, 50)
    set_backend("xla")
    try:
        want_probs, want = jpipe.WindowInference(
            jm, params, precision=arm).run_batch(jbatch)
    finally:
        set_backend("auto")
    engine = tpipe.WindowInference(model, "cpu", torch.float32, arm)
    spy = engine.model = _LogitsSpy(model)
    batch = collate(_examples(), 2, 16000, 50)
    probs = engine.run_batch(batch).numpy()
    # the JAX engine zeroes the logits of masked frames; the model does not
    np.testing.assert_allclose(spy.logits[0][batch.out_mask],
                               np.asarray(want)[batch.out_mask],
                               atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_allclose(probs, np.asarray(want_probs),
                               atol=LOGITS_ATOL, rtol=0)


def _record_dtypes(monkeypatch) -> list:
    """Patch the encoder's and head's op wrappers to log (site, input
    dtype) in call order."""
    log = []

    def spy(mod, name, site, arg=0):
        real = getattr(mod, name)

        def wrapped(*args, **kwargs):
            log.append((site, args[arg].dtype))
            return real(*args, **kwargs)

        monkeypatch.setattr(mod, name, wrapped)

    spy(wav2vec2, "layer_norm", "ln")
    spy(wav2vec2, "_mha", "attn", 1)  # (module, x, ...)
    spy(wav2vec2, "_ffn", "ffn", 1)
    spy(sfc, "layer_norm", "head_ln")
    return log


# (site, input dtype) a forward of the 2-layer encoder and the head logs
# under bf16 compute: LayerNorms read the residual stream, the sub-blocks
# the LayerNorm outputs cast to their layer's dtype
BF, F32 = torch.bfloat16, torch.float32
WANT = {
    "bf16": ([("ln", BF), ("attn", BF), ("ln", BF), ("ffn", BF)] * 2,
             [BF] * 3),
    "f32head": ([("ln", BF), ("attn", BF), ("ln", BF), ("ffn", BF)] * 2,
                [F32] * 3),
    "f32res": ([("ln", F32), ("attn", BF), ("ln", F32), ("ffn", BF)] * 2,
               [F32] * 3),
    "f32last1": ([("ln", F32), ("attn", BF), ("ln", F32), ("ffn", BF),
                  ("ln", F32), ("attn", F32), ("ln", F32), ("ffn", F32)],
                 [F32] * 3),
    "f32": ([("ln", F32), ("attn", F32), ("ln", F32), ("ffn", F32)] * 2,
            [F32] * 3),
}


@pytest.mark.parametrize("arm", sorted(WANT))
def test_cast_points_follow_the_jax_encoder(pair, monkeypatch, arm):
    model = pair[2]
    log = _record_dtypes(monkeypatch)
    engine = tpipe.WindowInference(model, "cpu", torch.bfloat16, arm)
    probs = engine.run_batch(collate(_examples(), 2, 16000, 50)).numpy()
    assert np.isfinite(probs).all()
    encoder, head = WANT[arm]
    # the feature projection's LayerNorm reads the conv stack's output in
    # the compute dtype (float32 only in the f32 arm), before the layers
    assert log[0] == ("ln", F32 if arm == "f32" else BF)
    assert log[1:1 + len(encoder)] == encoder
    assert [dt for site, dt in log[1 + len(encoder):]] == head
    assert {site for site, _ in log[1 + len(encoder):]} == {"head_ln"}


def test_f32_last_k_refuses_freezing_splits_and_train_mode():
    from wav2vecsegmenter_tpu.models.wav2vec2 import encoder as jax_encoder

    b, t = 1, 16000
    audio, lengths = torch.zeros(b, t), torch.full((b,), t)
    mask = torch.ones(b, 49, dtype=torch.bool)
    frozen = port_tiny(finetune_wav2vec=True, wav2vec_ft_layers=1)
    with pytest.raises(ValueError, match="freeze"):
        frozen(audio, lengths, mask, f32_last_k=1)
    ffn_frozen = port_tiny(finetune_wav2vec=True)  # FFNs stay frozen
    with pytest.raises(ValueError, match="freeze"):
        ffn_frozen(audio, lengths, mask, f32_last_k=1)
    port_tiny(finetune_wav2vec=True, finetune_w2v_ffn=True)(
        audio, lengths, mask, f32_last_k=1)  # all trained: runs
    with pytest.raises(ValueError, match="train mode"):
        port_tiny().wav2vec_model.model(
            audio, lengths, generator=torch.Generator().manual_seed(0),
            f32_last_k=1)
    # the JAX encoder refuses the same split
    jm = tiny_shas(finetune_wav2vec=True, wav2vec_ft_layers=1)
    params = jm.init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="freeze"):
        jax_encoder(params["wav2vec"], jnp.zeros((1, 49, 64)),
                    jnp.ones((1, 49), bool), jm.w2v_cfg, n_frozen_layers=1,
                    f32_last_k=1)


# ROADMAP C3, held as a fidelity question: the port's bf16 logits may sit
# no farther from the JAX float32 logits than this many times the JAX bf16
# (XLA) logits do
C3_RATIO = 1.25


class _FloatLogitsSpy(_LogitsSpy):
    def __call__(self, *args, **kwargs):
        out = self.model(*args, **kwargs)
        self.logits.append(out.float().numpy().copy())
        return out


def _rel_l2(got, want, mask) -> float:
    got, want = (np.asarray(a, np.float64)[mask] for a in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_error_from_f32_within_jax_bf16s(tmp_path, seed):
    """On the same weights (``tiny_pair`` of ``seed``), the relative L2
    distance on ``out_mask`` of the port's eager bf16 logits from the JAX
    float32 logits is within C3_RATIO of the JAX bf16 engine's
    (``compute_dtype=bfloat16``, XLA): the port adds no bf16 error of its
    own (ROADMAP C3)."""
    jm, params, model = tiny_pair(tmp_path / "ckpt.pt", seed)
    jbatch = jax_collate(_examples(), 2, 16000, 50)
    set_backend("xla")
    try:
        _, want = jpipe.WindowInference(jm, params).run_batch(jbatch)
        _, jax_bf16 = jpipe.WindowInference(
            jm, params, compute_dtype=jnp.bfloat16).run_batch(jbatch)
    finally:
        set_backend("auto")
    engine = tpipe.WindowInference(model, "cpu", torch.bfloat16)
    spy = engine.model = _FloatLogitsSpy(model)
    batch = collate(_examples(), 2, 16000, 50)
    assert np.isfinite(engine.run_batch(batch).numpy()).all()
    port = _rel_l2(spy.logits[0], want, batch.out_mask)
    jax_err = _rel_l2(jax_bf16, want, batch.out_mask)
    print(f"seed {seed}: port bf16 {port:.5f}, JAX bf16 {jax_err:.5f}")
    assert 0 < port <= C3_RATIO * jax_err, (port, jax_err)
