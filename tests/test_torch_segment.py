"""The port's product path (windows -> engine -> stitch -> algorithm -> yaml)
against the JAX package on the fixtures of tests/test_e2e_segment.py: two
synthetic talks of 65 s and 41.2 s and ``tests.helpers.tiny_shas`` weights,
carried to the port through a reference ``.pt``.  The JAX engine runs its
XLA path (``runtime.kernels=xla``) in float32.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from wav2vecsegmenter_tpu.checkpoints.torch_export import export_torch_checkpoint
from wav2vecsegmenter_tpu.data.datasets import (
    FixedSegmentationDatasetNoTarget as JaxDataset)
from wav2vecsegmenter_tpu.data.loader import BatchIterator as JaxBatchIterator
from wav2vecsegmenter_tpu.infer import pipeline as jpipe
from wav2vecsegmenter_tpu.ops.backend import set_backend
from wav2vecsegmenter_tpu_torch.checkpoints.convert import load_reference_checkpoint
from wav2vecsegmenter_tpu_torch.cli import common as tcommon
from wav2vecsegmenter_tpu_torch.data.windows import (
    BatchIterator, FixedSegmentationDatasetNoTarget)
from wav2vecsegmenter_tpu_torch.infer import pipeline as tpipe
from wav2vecsegmenter_tpu_torch.models.shas import SHAS

from .helpers import make_speechlike_wav, tiny_shas
from .torch_tiny import port_tiny, tiny_builders  # noqa: F401

PROBS_ATOL = 1e-5  # float32 engines, different summation orders
TALKS = ("talk1.wav", "talk2.wav")


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    ws = tmp_path_factory.mktemp("torch_e2e")
    (ws / "wav").mkdir()
    (ws / "txt").mkdir()
    make_speechlike_wav(ws / "wav" / TALKS[0], duration_secs=65.0, seed=0)
    make_speechlike_wav(ws / "wav" / TALKS[1], duration_secs=41.2, seed=1)
    orig = [{"duration": d, "offset": 0.0, "speaker_id": "NA", "wav": w}
            for d, w in zip((65.0, 41.2), TALKS)]
    with open(ws / "txt" / "orig.yaml", "w") as f:
        yaml.dump(orig, f)
    jm = tiny_shas(finetune_wav2vec=True)  # full checkpoint layout
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    export_torch_checkpoint(params, jm, ws / "ckpt.pt")
    from wav2vecsegmenter_tpu.config import compose, save_config

    save_config(compose(Path(__file__).parents[1] / "conf", "train"),
                ws / "train_config.yaml")
    return ws, jm, params


def _port_model(ws) -> SHAS:
    model = port_tiny()
    load_reference_checkpoint(ws / "ckpt.pt", model)
    return model.eval()


@pytest.mark.parametrize("iteration", [0, 1])
def test_batches_equal_jax_batch_iterator(workspace, iteration):
    ws = workspace[0]
    for talk in TALKS:
        ours = FixedSegmentationDatasetNoTarget(ws / "wav" / talk, 20, 2)
        ref = JaxDataset(ws / "wav" / talk, 20, 2)
        ours.fixed_length_segmentation(iteration)
        ref.fixed_length_segmentation(iteration)
        assert ours.duration_outframes == ref.duration_outframes
        got = list(BatchIterator(ours, 3, 20.0))
        want = list(JaxBatchIterator(ref, 3, 20.0, device_normalize=True,
                                     remainder_ladder=True))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert w.tokens is None  # CTC batches: not on this path
            for field in dataclasses.fields(g):
                a, b = getattr(g, field.name), getattr(w, field.name)
                if isinstance(b, np.ndarray):
                    np.testing.assert_array_equal(a, b)
                else:
                    assert a == b, field.name


def test_stitched_probs_match_jax_engine(workspace):
    ws, jm, params = workspace
    model = _port_model(ws)
    engine = tpipe.WindowInference(model, "cpu", torch.float32)
    set_backend("xla")
    try:
        jengine = jpipe.WindowInference(jm, params, compute_dtype=jnp.float32)
        for talk in TALKS:
            ds = FixedSegmentationDatasetNoTarget(ws / "wav" / talk, 20, 1)
            ds.fixed_length_segmentation(0)
            got = tpipe.collect_talk(
                tpipe.dispatch_talk(engine, BatchIterator(ds, 3, 20.0)),
                ds.duration_outframes)
            jds = JaxDataset(ws / "wav" / talk, 20, 1)
            jds.fixed_length_segmentation(0)
            pending = jpipe.dispatch_talk(jengine, JaxBatchIterator(
                jds, 3, 20.0, device_normalize=True, remainder_ladder=True))
            want, _, _ = jpipe.collect_talk(jengine, pending,
                                            jds.duration_outframes,
                                            need_logits=False)
            assert got.shape == want.shape == (ds.duration_outframes,)
            assert np.isfinite(got).all()
            np.testing.assert_allclose(got, want, atol=PROBS_ATOL, rtol=0)
    finally:
        set_backend("auto")


@pytest.mark.parametrize("algo", [["algorithm=pthr"],
                                  ["algorithm=dac",
                                   "algorithm.max_segment_length=10"]])
def test_segment_cli_yaml_equals_jax_cli(workspace, tiny_builders, algo):
    from wav2vecsegmenter_tpu.cli.segment import main as jax_main
    from wav2vecsegmenter_tpu_torch.cli.segment import main as port_main

    ws = workspace[0]
    common = [f"ckpt_path={ws}/ckpt.pt",
              f"config_path={ws}/train_config.yaml",
              f"infer_data.wav_dir={ws}/wav",
              f"infer_data.orig_seg_yaml={ws}/txt/orig.yaml",
              "batch_size=3", "runtime.compute_dtype=float32", *algo]
    name = algo[0].split("=")[1]
    out_jax, out_port = ws / f"jax_{name}", ws / f"port_{name}"
    rows_jax = jax_main(common + [f"output_dir={out_jax}",
                                  f"+results_path={out_jax}",
                                  "runtime.kernels=xla", "runtime.mesh.data=1"])
    rows_port = port_main(common + [f"output_dir={out_port}",
                                    f"+results_path={out_port}",
                                    "+runtime.device=cpu"])
    assert rows_port == rows_jax
    assert {r["wav"] for r in rows_port} == set(TALKS)
    assert ((out_port / "custom_segments.yaml").read_bytes()
            == (out_jax / "custom_segments.yaml").read_bytes())


def test_segment_cli_runs_on_cuda_unless_asked_for_cpu(workspace,
                                                     tiny_builders,
                                                     monkeypatch):
    """Without a GPU the segment CLI raises, and says how to ask for the
    CPU; the device is never picked behind the caller's back."""
    from wav2vecsegmenter_tpu_torch.cli.segment import main as port_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ws = workspace[0]
    with pytest.raises(RuntimeError, match=r"\+runtime\.device=cpu"):
        port_main([f"ckpt_path={ws}/ckpt.pt",
                   f"config_path={ws}/train_config.yaml",
                   f"infer_data.wav_dir={ws}/wav",
                   f"infer_data.orig_seg_yaml={ws}/txt/orig.yaml",
                   f"output_dir={ws}/no_gpu", f"+results_path={ws}/no_gpu"])
    assert tcommon.runtime_device_dtype("cpu") == (torch.device("cpu"),
                                                   torch.float32)
    with pytest.raises(RuntimeError):
        tcommon.runtime_device_dtype()


def test_segment_wavs_fills_talk_probs(workspace):
    """segment_wavs with plain arguments (the path chip_smoke.py drives):
    two passes, one talk of lookahead, probs handed back per talk."""
    ws = workspace[0]
    probs: dict = {}
    algo = {"tag": "pthr", "max_segment_length": 28, "min_segment_length": 0.2,
            "max_lerp_range": 4, "min_lerp_range": 0.4, "threshold": 0.1,
            "moving_average_window": 0.1}
    rows = tcommon.segment_wavs(
        _port_model(ws), [ws / "wav" / t for t in TALKS], algo, 3, 20.0, 2,
        torch.device("cpu"), torch.float32, talk_probs=probs)
    assert sorted(probs) == list(TALKS) and rows
    for p in probs.values():
        assert np.isfinite(p).all() and ((p >= 0) & (p <= 1)).all()


def test_stitch_and_nan_fill_match_jax():
    """An excluded (silent) row, a gap between windows, and a last window
    whose end lies one past the talk (the .5-frame clamp)."""
    from wav2vecsegmenter_tpu.data.collate import Batch

    rng = np.random.RandomState(3)
    probs = rng.rand(3, 12)
    batch = Batch(audio=None, in_lengths=None, target=None, out_mask=None,
                  included=np.array([True, False, True]),
                  starts=np.array([0, 10, 24]), ends=np.array([8, 20, 31]))
    duration = 30
    got = np.full(duration, np.nan)
    want, want_logits = jpipe.alloc_talk_arrays(1, duration)
    for i in range(3):
        tpipe.stitch_row(got, batch, i, probs, duration)
        jpipe.stitch_row(want, want_logits, batch, i, probs, None, duration)
    tpipe.nan_fill(got, duration)
    jpipe.nan_fill(want, duration)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all() and (got[10:20] == 0).all()
