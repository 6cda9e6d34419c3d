"""The port's segment, inference, ST-pipe, train, online and serve CLIs
refuse the options of the JAX CLIs that they do not carry out yet
(``cli.common.UNPORTED``): each one set away from its default in
``conf/<app>.yaml`` raises NotImplementedError naming the key, before any
model is built, and the defaults pass.  Keys that the JAX CLIs read but no
conf file sets are refused too (``runtime.profile_dir``; ``runtime.mesh``'s
subkeys).  (The default runs end to end in tests/test_torch_segment.py,
tests/test_torch_inference_cli.py and tests/test_torch_train.py.)
"""

import pytest

from wav2vecsegmenter_tpu_torch.cli import common
from wav2vecsegmenter_tpu_torch.cli import inference as inference_cli
from wav2vecsegmenter_tpu_torch.cli import inference_st_pipe as st_pipe_cli
from wav2vecsegmenter_tpu_torch.cli import online as online_cli
from wav2vecsegmenter_tpu_torch.cli import segment as segment_cli
from wav2vecsegmenter_tpu_torch.cli import serve as serve_cli
from wav2vecsegmenter_tpu_torch.cli import train as train_cli
from wav2vecsegmenter_tpu_torch.config import compose

SEGMENT = {
    "runtime.profile_steps": "runtime.profile_steps=3",
    "runtime.profile_dir": "+runtime.profile_dir=prof",
    "runtime.mesh": "runtime.mesh.data=8",
}
INFERENCE = {**SEGMENT, "log_wandb": "log_wandb=true"}
TRAIN = {
    "log_wandb": "log_wandb=true",
    "runtime.profile_steps": "runtime.profile_steps=2",
    "runtime.mesh": "runtime.mesh.model=2",
}
ONLINE = {"runtime.profile_steps": "runtime.profile_steps=3"}
SERVE = dict(ONLINE)


def _segment_args(tmp_path) -> list[str]:
    return [f"ckpt_path={tmp_path}/ckpt.pt",
            f"config_path={tmp_path}/config.yaml",
            f"output_dir={tmp_path}/out", f"+results_path={tmp_path}/out",
            "runtime.compute_dtype=float32", "+runtime.device=cpu"]


def _inference_args(tmp_path) -> list[str]:
    return [f"outputs={tmp_path}/run", "ckpt=epoch-0_best_eval_f1",
            f"+results_path={tmp_path}/out", "runtime.compute_dtype=float32",
            "+runtime.device=cpu"]


def _online_args(tmp_path) -> list[str]:
    return [f"ckpt_path={tmp_path}/ckpt.pt",
            f"config_path={tmp_path}/config.yaml",
            f"output_dir={tmp_path}/out", f"+results_path={tmp_path}/out",
            "runtime.compute_dtype=float32", "+runtime.device=cpu"]


def _serve_args(tmp_path) -> list[str]:
    return [f"ckpt_path={tmp_path}/ckpt.pt",
            f"config_path={tmp_path}/config.yaml",
            "runtime.compute_dtype=float32", "+runtime.device=cpu"]


def _train_args() -> list[str]:
    return ["exp_name=run", "batch_size=2", "max_epochs=1",
            "+runtime.device=cpu", "runtime.kernels=eager"]


def test_every_refused_option_is_tested():
    assert set(common.UNPORTED["segment"]) == set(SEGMENT)
    assert set(common.UNPORTED["inference"]) == set(INFERENCE)
    assert set(common.UNPORTED["train"]) == set(TRAIN)
    assert set(common.UNPORTED["online"]) == set(ONLINE)
    assert set(common.UNPORTED["serve"]) == set(SERVE)


@pytest.mark.parametrize("key", sorted(SEGMENT))
def test_segment_cli_refuses_unported_option(tmp_path, monkeypatch, key):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        segment_cli.main(_segment_args(tmp_path) + [SEGMENT[key]])
    assert not (tmp_path / "out").exists()  # raised before any work


@pytest.mark.parametrize("key", sorted(INFERENCE))
def test_inference_cli_refuses_unported_option(tmp_path, monkeypatch, key):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        inference_cli.main(_inference_args(tmp_path) + [INFERENCE[key]])
    assert not (tmp_path / "out").exists()  # raised before any work


@pytest.mark.parametrize("key", sorted(INFERENCE))
def test_st_pipe_cli_refuses_unported_option(tmp_path, monkeypatch, key):
    """The ST-pipe CLI composes conf/inference.yaml and refuses what the
    inference CLI refuses, naming the ROADMAP item, before any job."""
    monkeypatch.chdir(tmp_path)
    item = common.UNPORTED["inference"][key].split(" (")[0]
    with pytest.raises(NotImplementedError,
                       match=rf"{key.replace('.', '[.]')}.*ROADMAP {item}"):
        st_pipe_cli.main(_inference_args(tmp_path) + [INFERENCE[key]])
    assert not (tmp_path / "out").exists()  # raised before any work


@pytest.mark.parametrize("key", sorted(ONLINE))
def test_online_cli_refuses_unported_option(tmp_path, monkeypatch, key):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        online_cli.main(_online_args(tmp_path) + [ONLINE[key]])
    assert not (tmp_path / "out").exists()  # raised before any work


@pytest.mark.parametrize("key", sorted(SERVE))
def test_serve_cli_refuses_unported_option(tmp_path, monkeypatch, key):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        serve_cli.main(_serve_args(tmp_path) + [SERVE[key]])


# subkeys of a refused node that no conf file sets (the JAX loop reads
# runtime.mesh.fsdp): refused under the node's key
@pytest.mark.parametrize("app", ["segment", "inference", "train"])
def test_cli_refuses_mesh_subkey(tmp_path, monkeypatch, app):
    monkeypatch.chdir(tmp_path)
    main, args = {"segment": (segment_cli.main, _segment_args(tmp_path)),
                  "inference": (inference_cli.main,
                                _inference_args(tmp_path)),
                  "train": (train_cli.main, _train_args())}[app]
    with pytest.raises(NotImplementedError, match=r"runtime\.mesh"):
        main(args + ["+runtime.mesh.fsdp=true"])


def test_sweep_is_refused_before_its_first_job(tmp_path, monkeypatch):
    """A sweep whose second job sets a refused option runs no job."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="runtime.profile_steps"):
        segment_cli.main(["-m"] + _segment_args(tmp_path)
                         + ["runtime.profile_steps=0,3"])
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("key", sorted(TRAIN))
def test_train_cli_refuses_unported_option(tmp_path, monkeypatch, key):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        train_cli.main(_train_args() + [TRAIN[key]])
    assert not (tmp_path / "run").exists()  # raised before any work


@pytest.mark.parametrize("app", ["segment", "inference", "train", "online",
                                 "serve"])
def test_defaults_are_not_refused(tmp_path, app):
    args = {"segment": _segment_args(tmp_path),
            "inference": _inference_args(tmp_path),
            "train": _train_args(), "online": _online_args(tmp_path),
            "serve": _serve_args(tmp_path)}[app]
    config = compose(segment_cli.CONF_DIR, app, args,
                     resolve_interp=app == "train")
    common.refuse_unported(config, app, segment_cli.CONF_DIR)
