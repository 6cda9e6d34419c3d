"""The port's cross-talk window packing (``infer/packing.py``,
``runtime.pack_across_talks``) against the JAX package's
(``wav2vecsegmenter_tpu/infer/packing.py``): the packed sweep's per-talk
probabilities and batch count, packing at batch 1 against the per-talk
sweep, fewer batches than the per-talk sweep, the segment and inference
CLIs' yaml against the JAX CLIs', and a failed drain that closes the
packer.  After tests/test_packing.py; the tiny model of tests/helpers,
float32, the JAX engine on its XLA path.
"""

import numpy as np
import pytest
import torch

from wav2vecsegmenter_tpu.data.datasets import (
    FixedSegmentationDatasetNoTarget as JaxDataset)
from wav2vecsegmenter_tpu.infer import packing as jpacking
from wav2vecsegmenter_tpu.infer import pipeline as jpipe
from wav2vecsegmenter_tpu.ops.backend import set_backend
from wav2vecsegmenter_tpu_torch.cli import common as tcommon
from wav2vecsegmenter_tpu_torch.data.windows import (
    BatchIterator, FixedSegmentationDatasetNoTarget)
from wav2vecsegmenter_tpu_torch.infer import packing
from wav2vecsegmenter_tpu_torch.infer import pipeline as tpipe

from .helpers import make_speechlike_wav
from .torch_tiny import (cli_workspace, offline_both,  # noqa: F401
                         threads_per_worker, tiny_builders, tiny_pair)

SEG_LEN = 4.0
PROBS_ATOL = 2e-4  # float32 engines, the port's model tolerance
# three talks whose 4 s grids end in windows of both audio buckets (a tail
# window longer than 4 s after the short-tail merge, and a short one)
TALKS = {"talk0.wav": 25.0, "talk1.wav": 18.3, "talk2.wav": 13.7}


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    return cli_workspace(tmp_path_factory.mktemp("torch_packing"), TALKS,
                         seed=0)


@pytest.fixture(scope="module")
def engines(workspace):
    jm, params, model = tiny_pair(workspace / "ckpt.pt")
    return (jpipe.WindowInference(jm, params),
            tpipe.WindowInference(model, "cpu", torch.float32))


class Counting:
    """An engine (either package's) that counts its batches."""

    def __init__(self, engine):
        self.engine, self.model, self.n_batches = engine, engine.model, 0

    def run_batch(self, batch, *need_logits):
        self.n_batches += 1
        return self.engine.run_batch(batch, *need_logits)


def _wavs(ws):
    return [ws / "wav" / name for name in TALKS]


def _port_packed(engine, wavs, batch_size):
    counting = Counting(engine)
    packer = packing.PackedSweep(counting, batch_size, SEG_LEN)
    try:
        units = []
        for wav in wavs:
            ds = FixedSegmentationDatasetNoTarget(wav, SEG_LEN, 1)
            ds.fixed_length_segmentation(0)
            units.append((packer.add_dataset_pass(ds), ds))
        return ([packer.drain_unit(u, ds.duration_outframes)
                 for u, ds in units], counting.n_batches)
    finally:
        packer.close()


def _jax_packed(engine, wavs, batch_size):
    counting = Counting(engine)
    packer = jpacking.PackedSweep(counting, batch_size, SEG_LEN)
    set_backend("xla")
    try:
        units = []
        for wav in wavs:
            ds = JaxDataset(wav, SEG_LEN, 1)
            ds.fixed_length_segmentation(0)
            unit = packer.new_unit()
            packer.add_dataset_pass(unit, ds)
            units.append((unit, ds))
        return ([packer.drain_unit(u, ds.duration_outframes)[0]
                 for u, ds in units], counting.n_batches)
    finally:
        set_backend("auto")
        packer.close()


def _port_unpacked(engine, wav, batch_size):
    ds = FixedSegmentationDatasetNoTarget(wav, SEG_LEN, 1)
    ds.fixed_length_segmentation(0)
    return tpipe.collect_talk(tpipe.dispatch_talk(
        engine, BatchIterator(ds, batch_size, SEG_LEN)),
        ds.duration_outframes)


@pytest.mark.parametrize("batch_size", [1, 3])
def test_packed_sweep_equals_jax(workspace, engines, batch_size):
    """The same windows share each batch (equal batch counts), and each
    talk's stitched probabilities agree."""
    jengine, engine = engines
    got, n = _port_packed(engine, _wavs(workspace), batch_size)
    want, jn = _jax_packed(jengine, _wavs(workspace), batch_size)
    assert n == jn
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=PROBS_ATOL, rtol=0)


def test_batch_size_1_packing_equals_the_per_talk_sweep(workspace, engines):
    """With every batch full, packing changes nothing, bit for bit."""
    engine = engines[1]
    packed, _ = _port_packed(engine, _wavs(workspace), 1)
    for wav, p in zip(_wavs(workspace), packed):
        np.testing.assert_array_equal(p, _port_unpacked(engine, wav, 1))


def test_packing_launches_fewer_batches(engines, tmp_path):
    """3 talks of 8 standard-bucket windows at batch 6: the per-talk sweep
    runs ceil(8/6) * 3 = 6 batches, the packed one ceil(24/6) = 4."""
    engine = engines[1]
    wavs = []
    for i in range(3):
        wavs.append(tmp_path / f"u{i}.wav")
        # 30.5 s at 4 s windows: 7 full and a free-standing 2.5 s
        make_speechlike_wav(wavs[-1], duration_secs=30.5, seed=10 + i)
    packed, n_packed = _port_packed(engine, wavs, 6)
    counting = Counting(engine)
    for wav in wavs:
        _port_unpacked(counting, wav, 6)
    assert (n_packed, counting.n_batches) == (4, 6)
    assert np.isfinite(np.concatenate(packed)).all()


@pytest.mark.parametrize("cli,passes", [("segment", 1), ("inference", 1),
                                        ("segment", 2)])
def test_offline_clis_packed_equal_jax(workspace, tiny_builders, cli,
                                       passes):
    """Two passes (``inference_times=2``) pack two units a talk."""
    got = offline_both(workspace, cli, ["runtime.pack_across_talks=true",
                                        f"inference_times={passes}"])
    assert got["port"] == got["jax"] and len(got["port"][0]) > 0
    assert {r["wav"] for r in got["port"][0]} == set(TALKS)


def test_failed_drain_closes_the_packer(workspace, engines, monkeypatch):
    """An exception while a talk is drained closes the packer (its decode
    pool refuses work after), and the next packed sweep in the process
    runs clean and gives the rows of an undisturbed one."""
    model = engines[1].model
    closed = []
    real_close = packing.PackedSweep.close

    def close(self):
        closed.append(self)
        real_close(self)

    monkeypatch.setattr(packing.PackedSweep, "close", close)
    algo = {"tag": "pthr", "max_segment_length": 3, "threshold": 0.5}

    def sweep():
        return tcommon.segment_wavs(model, _wavs(workspace), algo, 3,
                                    SEG_LEN, 1, torch.device("cpu"),
                                    torch.float32, pack_across_talks=True)

    want = sweep()
    real_run = tcommon.run_algorithm

    def boom(*args):
        raise RuntimeError("algorithm failed")

    monkeypatch.setattr(tcommon, "run_algorithm", boom)
    with pytest.raises(RuntimeError, match="algorithm failed"):
        sweep()
    assert len(closed) == 2
    with pytest.raises(RuntimeError):  # its pool is shut down
        closed[1]._pool.submit(int)
    monkeypatch.setattr(tcommon, "run_algorithm", real_run)
    assert sweep() == want and len(want) > 0
