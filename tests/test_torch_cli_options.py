"""The options of the JAX CLIs that the port's CLIs once refused
(``runtime.mesh``, ``runtime.profile_dir``, ``runtime.profile_steps``,
``log_wandb``) take their JAX effect in each app: a ``runtime.mesh`` asks
the CLI for that many ranks (``core.runtime.launch_ranks``, recorded here;
tests/test_torch_mesh_cli.py runs the ranks), ``runtime.profile_dir``
writes a ``torch.profiler`` trace of the first talk, ``log_wandb`` logs to
a wandb run (a stub module in ``sys.modules``), and
``runtime.profile_steps`` is accepted by the inference CLIs and does
nothing there, as in the JAX package (ROADMAP C22); the trainer's traces
are tests/test_torch_trace.py's.  The apps run on the CPU at the tiny
geometry (tests/torch_tiny.py).
"""

import sys
import types

import pytest

from wav2vecsegmenter_tpu_torch.cli import common
from wav2vecsegmenter_tpu_torch.cli import inference as inference_cli
from wav2vecsegmenter_tpu_torch.cli import inference_st_pipe as st_pipe_cli
from wav2vecsegmenter_tpu_torch.cli import online as online_cli
from wav2vecsegmenter_tpu_torch.cli import segment as segment_cli
from wav2vecsegmenter_tpu_torch.cli import serve as serve_cli
from wav2vecsegmenter_tpu_torch.cli import train as train_cli
from wav2vecsegmenter_tpu_torch.config import compose
from wav2vecsegmenter_tpu_torch.core import runtime

from .torch_tiny import (cli_workspace, threads_per_worker,  # noqa: F401
                         tiny_builders)

# the options each app once refused, with a value that sets it
SEGMENT = {
    "runtime.profile_steps": "runtime.profile_steps=3",
    "runtime.profile_dir": "+runtime.profile_dir=prof",
    "runtime.mesh": "runtime.mesh.data=2",
}
INFERENCE = {**SEGMENT, "log_wandb": "log_wandb=true"}
TRAIN = {
    "log_wandb": "log_wandb=true",
    "runtime.profile_steps": "runtime.profile_steps=2",
    "runtime.mesh": "runtime.mesh.model=2",
}
ONLINE = {"runtime.profile_steps": "runtime.profile_steps=3"}
SERVE = dict(ONLINE)
TALKS = {"talkA.wav": 9.3, "talkB.wav": 5.1}


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    return cli_workspace(tmp_path_factory.mktemp("torch_cli_options"), TALKS)


@pytest.fixture
def wandb_stub(monkeypatch):
    """A ``wandb`` module whose runs record their ``init`` kwargs and
    ``log`` calls."""
    runs = []

    class Run:
        def __init__(self, **kwargs):
            self.kwargs, self.logged, self.finished = kwargs, [], False

        def log(self, data, step=None):
            self.logged.append((dict(data), step))

        def finish(self):
            self.finished = True

    def init(**kwargs):
        runs.append(Run(**kwargs))
        return runs[-1]

    class Table:
        def __init__(self, data, columns):
            self.data, self.columns = data, columns

        def __eq__(self, other):
            return (self.data, self.columns) == (other.data, other.columns)

    monkeypatch.setitem(sys.modules, "wandb", types.SimpleNamespace(
        init=init, Table=Table))
    return runs


@pytest.fixture
def launches(monkeypatch):
    """``core.runtime.launch_ranks`` recorded, not run: (entry, argv,
    ranks) of each call; it returns "launched"."""
    calls = []

    def launch(entry, argv, n):
        calls.append((entry, list(argv), n))
        return "launched"

    monkeypatch.setattr(runtime, "launch_ranks", launch)
    monkeypatch.delenv("W2VSEG_COORDINATOR", raising=False)
    return calls


def _io(ws) -> list[str]:
    return [f"infer_data.wav_dir={ws}/wav",
            f"infer_data.orig_seg_yaml={ws}/orig.yaml",
            "inference_segment_length=4", "batch_size=3", "algorithm=pthr",
            "runtime.compute_dtype=float32", "+runtime.device=cpu"]


def _segment_args(ws, out) -> list[str]:
    return [f"ckpt_path={ws}/ckpt.pt", f"config_path={ws}/train_config.yaml",
            f"output_dir={out}", f"+results_path={out}", *_io(ws)]


def _inference_args(ws, out) -> list[str]:
    return [f"outputs={ws}/run", "ckpt=final.pt", f"+results_path={out}",
            *_io(ws)]


def _online_args(ws, out) -> list[str]:
    return [f"ckpt_path={ws}/ckpt.pt", f"config_path={ws}/train_config.yaml",
            f"output_dir={out}", f"+results_path={out}",
            f"infer_data.wav_dir={ws}/wav",
            f"infer_data.orig_seg_yaml={ws}/orig.yaml", "segment_length=4",
            "chunk_secs=0.5", "algorithm=strm",
            "algorithm.max_segment_length=3",
            "runtime.compute_dtype=float32", "+runtime.device=cpu"]


def _train_args(root=None) -> list[str]:
    """A train run on the CPU; with ``root``, of a tiny backbone whose
    config.json lies there (the 512-channel conv stack of the presets)."""
    args = ["exp_name=run", "batch_size=2", "max_epochs=1",
            "+runtime.device=cpu", "runtime.kernels=eager"]
    if root is not None:
        (root / "w2v").mkdir(exist_ok=True)
        (root / "w2v" / "config.json").write_text(
            '{"hidden_size": 64, "num_hidden_layers": 2, '
            '"num_attention_heads": 2, "intermediate_size": 128}')
        args += [f"task.model.wav2vec_model_name={root / 'w2v'}",
                 "task.model.n_transformer_enc_heads=2"]
    return args


def _traces(d) -> list:
    return sorted(d.glob("*.pt.trace.json")) if d.exists() else []


def _fake_eval_st(monkeypatch):
    """The ST pipe's host part (fairseq, mWER, scores) replaced by fixed
    scores: tests/test_torch_stpipe.py runs the real one."""
    import wav2vecsegmenter_tpu_torch.stpipe.eval_st as eval_st_mod

    def fake(config, rows, out, algorithm, cmd_style="train"):
        return {f"eval_st_bleu_{algorithm}": 21.5,
                f"eval_st_n_segments_{algorithm}": len(rows)}

    monkeypatch.setattr(eval_st_mod, "eval_st", fake)


def test_every_once_refused_option_is_tested():
    """The table of options the CLIs once refused (the removed
    ``common.UNPORTED``) is whole: 3 segment, 4 inference and ST-pipe, 3
    train, 1 online and 1 serve option, and no refusal is left."""
    assert not hasattr(common, "UNPORTED")
    assert not hasattr(common, "refuse_unported")
    assert (len(SEGMENT), len(INFERENCE), len(TRAIN), len(ONLINE),
            len(SERVE)) == (3, 4, 3, 1, 1)


@pytest.mark.parametrize("key", sorted(SEGMENT))
def test_segment_cli_takes_option(workspace, tiny_builders, tmp_path,
                                  monkeypatch, launches, key):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out"
    rows = segment_cli.main(_segment_args(workspace, out) + [SEGMENT[key]])
    if key == "runtime.mesh":
        assert rows == "launched" and launches[0][2] == 2
        assert launches[0][0] == "wav2vecsegmenter_tpu_torch.cli.segment:main"
        return
    assert rows and (out / "custom_segments.yaml").exists()
    assert len(_traces(tmp_path / "prof")) == (
        key == "runtime.profile_dir")


@pytest.mark.parametrize("key", sorted(INFERENCE))
def test_inference_cli_takes_option(workspace, tiny_builders, tmp_path,
                                    monkeypatch, launches, wandb_stub, key):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out"
    rows = inference_cli.main(_inference_args(workspace, out)
                              + [INFERENCE[key]])
    if key == "runtime.mesh":
        assert rows == "launched" and launches[0][2] == 2
        return
    assert (out / "custom_segments.yaml").exists()
    assert len(_traces(tmp_path / "prof")) == (
        key == "runtime.profile_dir")
    if key == "log_wandb":
        (run,) = wandb_stub
        assert run.logged == [({"n_segments": len(rows)}, 0)]
        assert run.finished and run.kwargs["name"].endswith("/out")
    else:
        assert not wandb_stub


@pytest.mark.parametrize("key", sorted(INFERENCE))
def test_st_pipe_cli_takes_option(workspace, tiny_builders, tmp_path,
                                  monkeypatch, launches, wandb_stub, key):
    """The ST pipe composes conf/inference.yaml and takes what the
    inference CLI takes; with wandb, the scores and result tables."""
    monkeypatch.chdir(tmp_path)
    _fake_eval_st(monkeypatch)
    out = tmp_path / "out"
    results = st_pipe_cli.main(_inference_args(workspace, out)
                               + [INFERENCE[key]])
    if key == "runtime.mesh":
        assert results == "launched" and launches[0][2] == 2
        return
    assert results["eval_st_bleu_pthr"] == 21.5
    assert len(_traces(tmp_path / "prof")) == (
        key == "runtime.profile_dir")
    if key == "log_wandb":
        (run,) = wandb_stub
        (logged, step), = run.logged
        assert step == 0 and logged["bleu"] == 21.5
        assert logged["n_segments"] == results["eval_st_n_segments_pthr"]
        assert logged["bleu_table"].columns == ["name", "print", "score"]
    else:
        assert not wandb_stub


@pytest.mark.parametrize("key", sorted(ONLINE))
def test_online_cli_accepts_profile_steps(workspace, tiny_builders, tmp_path,
                                          monkeypatch, capsys, key):
    monkeypatch.chdir(tmp_path)
    rows = online_cli.main(_online_args(workspace, tmp_path / "out")
                           + [ONLINE[key]])
    assert rows and not list(tmp_path.rglob("*.pt.trace.json"))


@pytest.mark.parametrize("key", sorted(SERVE))
def test_serve_cli_accepts_profile_steps(workspace, tiny_builders, tmp_path,
                                         key):
    (config, _), = common.cli_jobs(
        serve_cli.CONF_DIR, "serve",
        [f"ckpt_path={workspace}/ckpt.pt",
         f"config_path={workspace}/train_config.yaml",
         "runtime.compute_dtype=float32", "+runtime.device=cpu",
         SERVE[key]])[1]
    from wav2vecsegmenter_tpu_torch.config import load_config, merge

    server = serve_cli.build_server(merge(load_config(config.config_path),
                                          config))
    try:
        assert server.address
    finally:
        server.close()
    assert not list(tmp_path.rglob("*.pt.trace.json"))


# runtime.mesh.fsdp, a subkey no conf file sets: the trainer shards over
# 'data' with it; the inference CLIs, as the JAX ones, read only the axes
@pytest.mark.parametrize("app", ["segment", "inference", "train"])
def test_cli_takes_mesh_fsdp(workspace, tiny_builders, tmp_path, monkeypatch,
                             launches, app):
    monkeypatch.chdir(tmp_path)
    main, args = {"segment": (segment_cli.main,
                              _segment_args(workspace, tmp_path / "o")),
                  "inference": (inference_cli.main,
                                _inference_args(workspace, tmp_path / "o")),
                  "train": (train_cli.main, _train_args())}[app]
    assert main(args + ["runtime.mesh.data=2",
                        "+runtime.mesh.fsdp=true"]) == "launched"
    (entry, argv, n), = launches
    assert n == 2 and "+runtime.mesh.fsdp=true" in argv
    assert entry.endswith(f".{app}:main")


def test_sweep_runs_every_job_with_an_option(workspace, tiny_builders,
                                             tmp_path, monkeypatch):
    """A sweep whose second job sets profile_steps runs both jobs."""
    monkeypatch.chdir(tmp_path)
    out = segment_cli.main(["-m"] + _segment_args(workspace, tmp_path / "o")
                           + ["runtime.profile_steps=0,3"])
    assert len(out) == 2 and out[0] == out[1]


@pytest.mark.parametrize("key", sorted(TRAIN))
def test_train_cli_takes_option(tmp_path, monkeypatch, launches, wandb_stub,
                                key):
    """The train CLI under a model axis launches its ranks; with wandb and
    profile_steps it starts its run (the loop's effects are
    tests/test_torch_trace.py's and tests/test_torch_wandb.py's: here the
    run stops at its missing corpus, after the wandb run began)."""
    monkeypatch.chdir(tmp_path)
    if key == "runtime.mesh":
        assert train_cli.main(_train_args() + [TRAIN[key]]) == "launched"
        assert launches[0][2] == 2
        return
    with pytest.raises(FileNotFoundError):
        train_cli.main(_train_args(tmp_path) + [
            TRAIN[key], "data.train.talk_list=missing.tsv"])
    assert (tmp_path / "run" / ".hydra" / "config.yaml").exists()
    assert len(wandb_stub) == (key == "log_wandb")


@pytest.mark.parametrize("app", ["segment", "inference", "train", "online",
                                 "serve"])
def test_defaults_ask_for_one_rank(app):
    """Each app's defaults (``runtime.mesh`` data -1 on the CPU) launch no
    ranks: the call runs in this process."""
    config = compose(segment_cli.CONF_DIR, app, ["+runtime.device=cpu"],
                     resolve_interp=app == "train")
    assert common.rank_count([config]) == 1
