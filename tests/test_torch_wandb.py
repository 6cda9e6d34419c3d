"""wandb logging of the port (A9, ``core.wandblog``, the port's copy of
the JAX package's): a stub ``wandb`` module in ``sys.modules``, the same
for both packages.  The trainer logs the keys of the JAX trainer at its
steps; the ST pipe's tables equal the JAX ``st_results_tables``' on one
results dict; without the wandb package, ``log_wandb=true`` logs a warning
and the run goes on.  (The inference CLI's ``n_segments`` and the ST
pipe's run are tests/test_torch_cli_options.py's.)"""

import logging
import sys
from pathlib import Path

import pytest

from wav2vecsegmenter_tpu.config import compose as jcompose
from wav2vecsegmenter_tpu_torch.config import Config, compose
from wav2vecsegmenter_tpu_torch.core import wandblog as twandb
from wav2vecsegmenter_tpu_torch.train import loop as tloop

from .test_torch_cli_options import wandb_stub  # noqa: F401
from .test_torch_mesh_cli import corpus  # noqa: F401
from .torch_tiny import port_tiny, threads_per_worker  # noqa: F401
from .helpers import tiny_shas

CONF = Path(__file__).resolve().parents[1] / "conf"


def _overrides(root) -> list[str]:
    talks, segments = root / "talks.tsv", root / "segments.tsv"
    return ["exp_name=run", "batch_size=2", "segment_length=2",
            "task=shas_fix", "max_epochs=1", "update_freq=1",
            "print_every_steps=2", "save_ckpts=false", "log_wandb=true",
            "learning_rate=1e-3", "runtime.compute_dtype=float32",
            f"data.train.talk_list={talks}",
            f"data.train.segments_list={segments}",
            f"data.eval.talk_list={talks}",
            f"data.eval.segments_list={segments}"]


def _shape(run) -> list:
    return [(sorted(data), step) for data, step in run.logged]


def test_train_loop_logs_the_jax_trainers_keys_and_steps(
        corpus, tmp_path, monkeypatch, wandb_stub):  # noqa: F811
    """Both trainers on the tiny SHAS over one fixed-grid corpus: one run
    each, started with the same init kwargs, logging ``{"epoch", **train
    metrics}`` at the same global steps and the epoch's evaluation, then
    finished."""
    from wav2vecsegmenter_tpu.config import registry
    from wav2vecsegmenter_tpu.train.loop import train as jtrain

    import tests.helpers as helpers

    monkeypatch.setattr(helpers, "_tiny_builder_wandb",
                        lambda **kw: tiny_shas(), raising=False)
    monkeypatch.setitem(registry._ALIASES, "lib.models.SHAS",
                        "tests.helpers:_tiny_builder_wandb")
    monkeypatch.setattr(tloop, "build_model",
                        lambda task, device=None: (port_tiny().to(device),
                                                   None))
    # one JAX device, as the port's one rank (the JAX default mesh takes
    # all 8 host devices, and an 8-times batch)
    jtrain(jcompose(CONF, "train", _overrides(corpus)
                    + ["runtime.kernels=xla", "runtime.mesh.data=1"]),
           work_dir=tmp_path / "jax")
    tloop.train(compose(CONF, "train", _overrides(corpus)
                        + ["+runtime.device=cpu"]),
                work_dir=tmp_path / "port")
    jrun, trun = wandb_stub
    assert _shape(trun) == _shape(jrun)
    assert len(trun.logged) >= 3 and trun.logged[0][1] == 2
    assert trun.finished and jrun.finished
    for key in ("project", "name", "notes", "group", "tags"):
        assert trun.kwargs[key] == jrun.kwargs[key], key


def _same(a, b) -> bool:
    """Equal values, NaN equal to NaN (a partial BERTScore's r and f1),
    tables by their rows' text and columns."""
    if hasattr(b, "columns"):
        return repr(a.data) == repr(b.data) and a.columns == b.columns
    return a == b or (a != a and b != b)


RESULTS = {"eval_st_bleu_dac": 21.25, "eval_st_bertscore_p_dac": 0.81,
           "eval_st_bertscore_r_dac": 0.79, "eval_st_bertscore_f1_dac": 0.8,
           "eval_st_bleurt_dac": 0.41, "eval_st_n_segments_dac": 17}


@pytest.mark.parametrize("results", [
    RESULTS, {"eval_st_bleu_dac": 18.0},
    {"eval_st_bertscore_p_dac": 0.7, "eval_st_n_segments_dac": 3}],
    ids=["all", "bleu", "partial_bertscore"])
def test_st_results_tables_equal_jax(wandb_stub, results):  # noqa: F811
    from wav2vecsegmenter_tpu.core import wandblog as jwandb

    class Run:
        def __init__(self):
            self.logged = []

        def log(self, data, step=None):
            self.logged.append((data, step))

    want, got = Run(), Run()
    jwandb.st_results_tables(want, "exp/job", dict(results), "dac",
                             extra={"n_segments": 9})
    twandb.st_results_tables(got, "exp/job", dict(results), "dac",
                             extra={"n_segments": 9})
    assert [sorted(d) for d, _ in got.logged] == \
        [sorted(d) for d, _ in want.logged]
    for (g, gs), (w, ws) in zip(got.logged, want.logged):
        assert gs == ws == 0
        for key, value in w.items():
            assert _same(g[key], value), key


def test_without_wandb_a_warning_and_the_run_goes_on(tmp_path, monkeypatch,
                                                     caplog):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import fails
    with caplog.at_level(logging.WARNING):
        run = twandb.init_wandb(Config({"log_wandb": True}), tmp_path)
    assert run is None
    assert "wandb is not installed" in caplog.text
    assert twandb.init_wandb(Config({"log_wandb": False}), tmp_path) is None
    twandb.st_results_tables(None, "x", RESULTS, "dac")  # no run: nothing
