"""The port's int8 (w8a8) serving mode (``ops/quant.py``,
``runtime.quantize=int8``) against the JAX package's
(``wav2vecsegmenter_tpu/ops/quant.py``): the weight quantization bit for
bit, the product's int8 activations and int32 sums exactly and its output
within 1e-6, the whole SHAS forward against the JAX int8 engine, the scope
(no fused FFN kernel, the caller's module untouched), and the segment,
inference, online and serve CLIs with ``runtime.quantize=int8``.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vecsegmenter_tpu.data.collate import collate as jax_collate
from wav2vecsegmenter_tpu.infer import pipeline as jpipe
from wav2vecsegmenter_tpu.ops import quant as jquant
from wav2vecsegmenter_tpu.ops.backend import set_backend
from wav2vecsegmenter_tpu_torch.cli import common as tcommon
from wav2vecsegmenter_tpu_torch.data.collate import collate
from wav2vecsegmenter_tpu_torch.infer import pipeline as tpipe
from wav2vecsegmenter_tpu_torch.models import wav2vec2
from wav2vecsegmenter_tpu_torch.ops import quant

from .torch_tiny import (JAX_SIDE, PORT_SIDE, cli_workspace,  # noqa: F401
                         offline_both, threads_per_worker, port_tiny,
                         tiny_builders, tiny_pair)

# int8_matmul against the JAX function as the jitted forward runs it: the
# same int8 and int32 values, the float32 scaling in the same order
# (observed: bitwise equal, 0 relative)
MATMUL_RTOL = 1e-6


def _jax_linear(seed: int, d_in: int, d_out: int):
    """A numpy-seeded [d_in, d_out] weight whose columns span four decades
    (per-channel scales matter), and a bias."""
    rng = np.random.RandomState(seed)
    w = (rng.randn(d_in, d_out) * 10.0 ** rng.uniform(-3, 1, d_out)
         ).astype(np.float32)
    return w, rng.randn(d_out).astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 32), (48, 96)])
def test_quantize_linear_equals_jax(shape):
    w, b = _jax_linear(0, *shape)
    want = jquant.quantize_linear({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    got = quant.quantize_linear(torch.from_numpy(w.T.copy()),
                                torch.from_numpy(b))
    assert got.qw.dtype == torch.int8 and got.qs.dtype == torch.float32
    np.testing.assert_array_equal(got.qw.numpy(), np.asarray(want["qw"]).T)
    np.testing.assert_array_equal(got.qs.numpy(), np.asarray(want["qs"]))
    back, bias = quant.dequantize_linear(got)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jquant.dequantize_linear(want)["w"]).T)
    np.testing.assert_array_equal(bias.numpy(), b)


@jax.jit
def _jax_activations(x):
    """The JAX int8_matmul's activation step (wav2vecsegmenter_tpu/ops/
    quant.py), spelled out: its int8 rows and row scales, jitted as in the
    JAX forward (where XLA turns the division by 127 into a product by
    its reciprocal)."""
    xf = x.astype(jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0,
                     1e-30)
    return (jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8), sx)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_equals_jax(dtype):
    w, b = _jax_linear(2, 64, 48)
    rng = np.random.RandomState(3)
    x = rng.randn(4, 37, 64).astype(np.float32)
    x[0, 5] = 0.0  # a padded frame
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq = jquant.quantize_linear({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    tq = quant.quantize_linear(torch.from_numpy(w.T.copy()),
                               torch.from_numpy(b))

    jxq, jsx = _jax_activations(jx.reshape(-1, 64))
    xq, sx = quant.quantize_rows(tx.reshape(-1, 64))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    want_sums = jax.lax.dot_general(jxq, jq["qw"], (((1,), (0,)), ((), ())),
                                    preferred_element_type=jnp.int32)
    sums = quant.int8_mm(xq, tq.qw)
    assert sums.dtype == torch.int32
    np.testing.assert_array_equal(sums.numpy(), np.asarray(want_sums))

    want = np.asarray(jax.jit(jquant.int8_matmul)(jx, jq["qw"], jq["qs"]))
    got = quant.int8_matmul(tx, tq.qw, tq.qs)
    assert got.dtype == torch.float32 and got.shape == (4, 37, 48)
    np.testing.assert_allclose(got.numpy(), want, rtol=MATMUL_RTOL, atol=0)
    np.testing.assert_array_equal(got[0, 5].numpy(), 0.0)


def test_int8_matmul_zero_rows_stay_zero():
    w, b = _jax_linear(4, 32, 16)
    tq = quant.quantize_linear(torch.from_numpy(w.T.copy()),
                               torch.from_numpy(b))
    out = quant.int8_matmul(torch.zeros(2, 5, 32), tq.qw, tq.qs)
    np.testing.assert_array_equal(out.numpy(), 0.0)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return tiny_pair(tmp_path_factory.mktemp("quant") / "ckpt.pt")


def _examples():
    rng = np.random.RandomState(5)
    wavs = [rng.randn(n).astype(np.float32) * 0.1 for n in (16000, 11000)]
    return [(w, None, 0, int(len(w) * 49.95 / 16000)) for w in wavs]


class _LogitsSpy:
    """Stands in for the engine's model: records each call's logits."""

    def __init__(self, model):
        self.model, self.logits = model, []

    def __call__(self, *args, **kwargs):
        out = self.model(*args, **kwargs)
        self.logits.append(out.numpy().copy())
        return out


def _jax_int8_products(jm, params, arm, dtype) -> list:
    """(x, qw, qs, y) of every int8 product of the JAX int8 engine's
    forward on the examples, in call order (per layer: QKV, attention
    output, w1, w2)."""
    calls = []
    real = jquant.int8_matmul

    def record(x, qw, qs):
        y = real(x, qw, qs)
        jax.debug.callback(
            lambda *a: calls.append(tuple(np.array(v) for v in a)),
            x, qw, qs, y, ordered=True)
        return y

    set_backend("xla")
    jquant.int8_matmul = record
    try:
        probs, _ = jpipe.WindowInference(
            jm, params, quantize="int8", precision=arm,
            compute_dtype=dtype).run_batch(
                jax_collate(_examples(), 2, 16000, 50))
        jax.block_until_ready(probs)
        jax.effects_barrier()
    finally:
        jquant.int8_matmul = real
        set_backend("auto")
    return calls


@pytest.mark.parametrize("arm", [None, "f32last1", "f32res"])
def test_int8_products_equal_jax_on_its_activations(pair, arm):
    """Each int8 product of the forward, in bf16 under the precision arm:
    the engine's quantized layers equal the JAX engine's (the QKV's three
    weights and scales concatenated alike), and the port's product of the
    activations the JAX forward fed it equals the JAX product within
    MATMUL_RTOL (observed: bitwise)."""
    jm, params, model = pair
    calls = _jax_int8_products(jm, params, arm, jnp.bfloat16)
    engine = tpipe.WindowInference(model, "cpu", torch.bfloat16, arm,
                                   "int8")
    table = [layer[k] for layer in engine.quantized
             for k in ("qkv", "o", "w1", "w2")]
    assert len(calls) == len(table) == 8
    for (x, qw, qs, y), q in zip(calls, table):
        np.testing.assert_array_equal(q.qw.numpy(), qw.T)
        np.testing.assert_array_equal(q.qs.numpy(), qs)
        xt = torch.from_numpy(x.astype(np.float32)).to(
            torch.bfloat16 if x.dtype != np.float32 else torch.float32)
        got = quant.int8_matmul(xt, q.qw, q.qs).numpy()
        np.testing.assert_allclose(got, y, rtol=MATMUL_RTOL, atol=0)
    # f32last1: the last layer's products read float32 activations
    want = [np.float32] * 4 if arm == "f32last1" else []
    assert [c[0].dtype for c in calls[4:]][:len(want)] == want


@pytest.mark.parametrize("arm", [None, "f32last1", "f32res"])
def test_int8_forward_within_the_int8_error_of_jax(pair, arm):
    """The whole int8 forward at float32 against the JAX int8 engine.
    The two agree until float32 noise (~1e-6 between the two float paths)
    puts an activation on the other side of a rounding step, which moves
    a product's row by one int8 step of its scale; that difference then
    spreads like quantization error.  Observed on these inputs: port-int8
    vs JAX-int8 max |dlogit| 3.4e-3 (mean 3.7e-4), JAX-int8 vs JAX-float
    1.2e-2 (mean 3.3e-3).  Held: the port's distance to the JAX int8
    engine within the JAX int8 engine's own distance to float, max and
    mean (the products themselves are held exactly above)."""
    jm, params, model = pair
    jbatch = jax_collate(_examples(), 2, 16000, 50)
    set_backend("xla")
    try:
        want = {q: np.asarray(jpipe.WindowInference(
            jm, params, quantize=q, precision=arm).run_batch(jbatch)[1])
            for q in (None, "int8")}
    finally:
        set_backend("auto")
    engine = tpipe.WindowInference(model, "cpu", torch.float32, arm, "int8")
    assert quant.is_quantized(engine.quantized)
    spy = engine.model = _LogitsSpy(model)
    batch = collate(_examples(), 2, 16000, 50)
    probs = engine.run_batch(batch).numpy()
    assert np.isfinite(probs).all()
    mask = batch.out_mask
    port_vs_jax = np.abs(spy.logits[0] - want["int8"])[mask]
    int8_vs_float = np.abs(want["int8"] - want[None])[mask]
    assert int8_vs_float.max() > 1e-3  # quantization moved the logits
    assert port_vs_jax.max() <= int8_vs_float.max()
    assert port_vs_jax.mean() <= int8_vs_float.mean()


def test_int8_composes_with_f32_last_k_in_bf16(pair, monkeypatch):
    """Each int8 product's output dtype: bf16 in the first layer, float32
    in the last under f32last1 (the JAX ``cast_tree`` leaves the int8
    leaves and scales alone, and the layer's compute dtype is float32)."""
    model = pair[2]
    log = []
    real = wav2vec2.int8_linear

    def spy(x, q, dt):
        log.append(dt)
        return real(x, q, dt)

    monkeypatch.setattr(wav2vec2, "int8_linear", spy)
    engine = tpipe.WindowInference(model, "cpu", torch.bfloat16, "f32last1",
                                   "int8")
    probs = engine.run_batch(collate(_examples(), 2, 16000, 50)).numpy()
    assert np.isfinite(probs).all()
    # qkv, o, w1, w2 per layer
    assert log == [torch.bfloat16] * 4 + [torch.float32] * 4


def test_int8_skips_the_fused_ffn_and_leaves_the_module(pair, monkeypatch):
    model = pair[2]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    calls = []
    real = wav2vec2.ffn
    monkeypatch.setattr(wav2vec2, "ffn",
                        lambda *a: calls.append(1) or real(*a))
    batch = collate(_examples(), 2, 16000, 50)
    tpipe.WindowInference(model, "cpu", torch.float32).run_batch(batch)
    assert len(calls) == 2  # the default path: the fused FFN per layer
    calls.clear()
    engine = tpipe.WindowInference(model, "cpu", torch.float32,
                                   quantize="int8")
    engine.run_batch(batch).numpy()
    assert calls == []
    after = model.state_dict()
    assert after.keys() == before.keys()
    for k, v in before.items():
        assert after[k].dtype == v.dtype and torch.equal(after[k], v), k


def test_unknown_quantize_mode_raises(pair):
    with pytest.raises(ValueError, match="unknown quantize mode"):
        tpipe.WindowInference(pair[2], "cpu", quantize="fp8")
    with pytest.raises(ValueError, match="train mode"):
        port_tiny().wav2vec_model.model(
            torch.zeros(1, 16000), torch.full((1,), 16000),
            generator=torch.Generator().manual_seed(0),
            quantized=quant.quantize_layers(
                port_tiny().wav2vec_model.model.encoder))


# --- the CLIs with runtime.quantize=int8, against the JAX CLIs ------------

TALKS = {"talkA.wav": 21.7, "talkB.wav": 13.4}
INT8 = ["runtime.quantize=int8", "runtime.compute_dtype=float32"]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    return cli_workspace(tmp_path_factory.mktemp("torch_quant_cli"), TALKS)


@pytest.mark.parametrize("cli", ["segment", "inference"])
def test_offline_clis_int8_equal_jax(workspace, tiny_builders, cli):
    got = offline_both(workspace, cli, INT8)
    assert got["port"] == got["jax"] and len(got["port"][0]) > 0
    assert {r["wav"] for r in got["port"][0]} == set(TALKS)


def test_online_cli_int8_commits_equal_jax(workspace, tiny_builders, capsys):
    import json

    ws = workspace

    def lines(side, main):
        capsys.readouterr()
        rows = main([f"ckpt_path={ws}/ckpt.pt",
                     f"config_path={ws}/train_config.yaml",
                     f"output_dir={ws}/online_{side}",
                     f"+results_path={ws}/online_{side}",
                     f"infer_data.wav_dir={ws}/wav",
                     f"infer_data.orig_seg_yaml={ws}/orig.yaml",
                     "segment_length=4", "chunk_secs=0.3", "algorithm=strm",
                     "algorithm.max_segment_length=3", *INT8,
                     *(JAX_SIDE if side == "jax" else PORT_SIDE)])
        return rows, [json.loads(ln) for ln in
                      capsys.readouterr().out.splitlines()
                      if ln.startswith("{")]

    from wav2vecsegmenter_tpu.cli.online import main as jax_main
    from wav2vecsegmenter_tpu_torch.cli.online import main as port_main

    jrows, jlines = lines("jax", jax_main)
    rows, got = lines("port", port_main)
    assert rows == jrows and len(rows) > 0
    assert got == jlines and len(got) == len(rows)


def test_serve_cli_int8_serves_the_quantized_engine(workspace, monkeypatch):
    from wav2vecsegmenter_tpu_torch.cli import serve
    from wav2vecsegmenter_tpu_torch.config import load_config, merge
    from wav2vecsegmenter_tpu_torch.data.audio import read_wav_window
    from wav2vecsegmenter_tpu_torch.infer.online import OnlineSegmenter
    from wav2vecsegmenter_tpu_torch.infer.server import segment_stream_client

    ws = workspace
    monkeypatch.setattr(tcommon, "build_model",
                        lambda conf, device=None: (port_tiny().to(device),
                                                   None))
    _, [(config, _)] = tcommon.cli_jobs(serve.CONF_DIR, "serve", [
        f"ckpt_path={ws}/ckpt.pt", "segment_length=4", "algorithm=strm",
        "algorithm.max_segment_length=3", "+runtime.device=cpu", *INT8])
    config = merge(load_config(ws / "train_config.yaml"), config)
    srv = serve.build_server(config)
    try:
        engine = srv.mux.engine
        assert quant.is_quantized(engine.quantized)
        t = threading.Thread(target=srv.serve_forever,
                             kwargs={"poll_s": 0.01}, daemon=True)
        t.start()
        wav = read_wav_window(ws / "wav" / "talkB.wav", 0,
                              int(TALKS["talkB.wav"] * 16000))
        pcm = (np.clip(np.rint(wav * 32768.0), -32768, 32767)
               .astype("<i2").tobytes())
        lines = segment_stream_client(srv.address, pcm)
        srv.shutdown()
        t.join(timeout=10)
    finally:
        srv.close()
    assert lines[-1]["type"] == "end" and lines[-1]["n_segments"] > 0
    alone = OnlineSegmenter(engine, **srv.mux._stream_kwargs)
    alone.feed(np.frombuffer(pcm, "<i2").astype(np.float32) / 32768.0)
    alone.finish()
    assert ([(ln["offset"], ln["duration"]) for ln in lines
             if ln["type"] == "segment"]
            == [(s.offset, s.duration) for s in alone.segments])
