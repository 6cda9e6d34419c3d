"""pDAC-with-logits (``algorithm=dac_logits``) and the multi-class engine in
the port's offline and online CLIs against the JAX package's, on
``task=shas_ssl`` at the tiny geometry (``tests/torch_tiny``: one set of
weights, a full-layout SSL ``.pt``): the 2-D logits stitch and its NaN
fill, and ``custom_segments.yaml`` byte for byte from ``segment.py`` and
``cli/inference.py`` (per talk, packed across talks, two passes, a ``-m``
sweep) and the online CLI's commits.  Both CLIs build the tiny model from
the task's ``_target_``: the JAX registry's alias and the port's
``cli/common.MODELS`` entry point at it.
"""

from pathlib import Path

import numpy as np
import pytest

from wav2vecsegmenter_tpu.infer import pipeline as jpipe
from wav2vecsegmenter_tpu_torch.infer import pipeline as tpipe

from .torch_tiny import (cli_workspace, jax_tiny_ssl,  # noqa: F401
                         offline_both, threads_per_worker, port_tiny_ssl,
                         tiny_ssl_pair)

TALKS = {"talkA.wav": 15.3, "talkB.wav": 9.7}
CONF = Path(__file__).resolve().parents[1] / "conf"
SHORT = ["algorithm.max_segment_length=6"]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """:func:`cli_workspace` with the tiny SSL model's checkpoint and a
    training config of ``task=shas_ssl`` in place of the SHAS ones."""
    from wav2vecsegmenter_tpu.config import compose, save_config

    ws = cli_workspace(tmp_path_factory.mktemp("torch_dac_logits"), TALKS)
    tiny_ssl_pair(ws / "ckpt.pt")
    (ws / "run" / "e2e" / "ckpts" / "final.pt").write_bytes(
        (ws / "ckpt.pt").read_bytes())
    train_cfg = compose(CONF, "train", ["task=shas_ssl"])
    save_config(train_cfg, ws / "train_config.yaml")
    train_cfg["exp_name"] = "e2e"
    save_config(train_cfg, ws / "run" / ".hydra" / "config.yaml")
    return ws


@pytest.fixture
def ssl_builders(monkeypatch):
    """``lib.models.SHASWithSSL`` builds the tiny SSL model in both
    packages, with the vocabulary's size that the builders wire in."""
    import tests.torch_tiny as torch_tiny
    from wav2vecsegmenter_tpu.config import registry
    from wav2vecsegmenter_tpu_torch.cli import common

    monkeypatch.setitem(registry._ALIASES, "lib.models.SHASWithSSL",
                        "tests.torch_tiny:_jax_ssl_builder")
    monkeypatch.setattr(
        torch_tiny, "_jax_ssl_builder",
        lambda **kw: jax_tiny_ssl(vocab_size=kw["vocab_size"]),
        raising=False)
    monkeypatch.setitem(
        common.MODELS, "lib.models.SHASWithSSL",
        lambda device=None, **kw: port_tiny_ssl(vocab_size=kw["vocab_size"],
                                                device=device))


def test_logits_stitch_and_nan_fill_match_jax():
    """[T, V] logits: an excluded (silent) row zeroes its span, a gap
    between windows takes one scalar over its whole [5, V] neighbourhood,
    the last window's end is clamped."""
    from wav2vecsegmenter_tpu.data.collate import Batch

    rng = np.random.RandomState(3)
    probs, logits = rng.rand(3, 12), rng.randn(3, 12, 36)
    batch = Batch(audio=None, in_lengths=None, target=None, out_mask=None,
                  included=np.array([True, False, True]),
                  starts=np.array([0, 10, 24]), ends=np.array([8, 20, 31]))
    duration = 30
    got_p = np.full(duration, np.nan)
    got = tpipe.talk_logits_array(36, duration)
    want_p, want = jpipe.alloc_talk_arrays(36, duration)
    assert got.shape == want.shape
    for i in range(3):
        tpipe.stitch_row(got_p, batch, i, probs, duration, None, got, logits)
        jpipe.stitch_row(want_p, want, batch, i, probs, logits, duration)
    for arr in (got_p, got, want_p, want):
        (tpipe if arr is got_p or arr is got else jpipe).nan_fill(arr,
                                                                 duration)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_p, want_p)
    assert np.isfinite(got).all() and (got[10:20] == 0).all()
    assert (got[8] == got[8, 0]).all()  # one scalar for the gap row


@pytest.mark.parametrize("cli,extra", [
    ("segment", []),
    ("inference", []),
    ("segment", ["runtime.pack_across_talks=true", "inference_times=2"]),
    ("inference", ["runtime.pack_across_talks=true"]),
])
def test_offline_clis_dac_logits_equal_jax(workspace, ssl_builders, cli,
                                           extra):
    """``algorithm=dac_logits`` on SHASWithSSL: the talks' summed logits
    trimmed on argmax != <B>, split in descending p(<B>)."""
    got = offline_both(workspace, cli, SHORT + extra, "dac_logits")
    assert got["port"] == got["jax"]
    rows = got["port"][0]
    assert {r["wav"] for r in rows} == set(TALKS) and len(rows) > 2


def test_offline_dac_on_ssl_probs_equals_jax(workspace, ssl_builders):
    """``algorithm=dac`` on the SSL head's p(<B>) (a softmax over 36, so
    its threshold is lowered to where the random head's values lie)."""
    got = offline_both(workspace, "segment",
                       SHORT + ["algorithm.threshold=0.03"], "dac")
    assert got["port"] == got["jax"] and len(got["port"][0]) > 2


def test_segment_sweep_dac_logits_equals_jax(workspace, ssl_builders):
    """``-m algorithm.max_segment_length=5,7``: one job a value, each
    job's yaml byte-equal to the JAX CLI's."""
    import importlib

    ws = workspace
    out = {}
    for side, pkg, own in (
            ("jax", "wav2vecsegmenter_tpu", ["runtime.kernels=xla"]),
            ("port", "wav2vecsegmenter_tpu_torch", ["+runtime.device=cpu"])):
        main = importlib.import_module(f"{pkg}.cli.segment").main
        d = ws / f"sweep_{side}"
        rows = main(["-m", f"ckpt_path={ws}/ckpt.pt",
                     f"config_path={ws}/train_config.yaml",
                     f"output_dir={d}", f"infer_data.wav_dir={ws}/wav",
                     f"infer_data.orig_seg_yaml={ws}/orig.yaml",
                     "inference_segment_length=4", "batch_size=3",
                     "algorithm=dac_logits",
                     "algorithm.max_segment_length=5,7",
                     "runtime.compute_dtype=float32", *own])
        out[side] = (rows, {str(p.relative_to(d)): p.read_bytes()
                            for p in sorted(d.rglob("custom_segments.yaml"))})
    assert out["port"] == out["jax"]
    rows, yamls = out["port"]
    assert len(rows) == len(yamls) == 2 and rows[0] != rows[1]


def test_online_cli_commits_equal_jax(workspace, ssl_builders):
    """The online CLI on ``task=shas_ssl`` (pTHR over p(<B>)): the same
    committed segments and yaml bytes as the JAX CLI's."""
    import importlib

    ws = workspace
    out = {}
    for side, pkg, own in (
            ("jax", "wav2vecsegmenter_tpu", ["runtime.kernels=xla"]),
            ("port", "wav2vecsegmenter_tpu_torch", ["+runtime.device=cpu"])):
        main = importlib.import_module(f"{pkg}.cli.online").main
        d = ws / f"online_{side}"
        rows = main([f"ckpt_path={ws}/ckpt.pt",
                     f"config_path={ws}/train_config.yaml",
                     f"output_dir={d}", f"+results_path={d}",
                     f"infer_data.wav_dir={ws}/wav",
                     f"infer_data.orig_seg_yaml={ws}/orig.yaml",
                     "segment_length=4", "chunk_secs=0.3",
                     "algorithm=pthr", "algorithm.threshold=0.06",
                     "algorithm.max_segment_length=4",
                     "runtime.compute_dtype=float32", *own])
        out[side] = (rows, (d / "custom_segments.yaml").read_bytes())
    assert out["port"] == out["jax"] and len(out["port"][0]) > 2
