"""The port's synthetic-data tool (``cli/prepare_synthetic_data.py``)
against the JAX package's: stage 1 (the segmentation tree, a device path;
here the CPU in float32) on the tiny model of tests/helpers from one set of
weights (JAX ``init``, an Orbax checkpoint for JAX, the exported ``.pt``
for the port), and stages 2-3 (translation tree, tournament, exports)
with a fake ``fairseq-generate`` on ``PATH``.  Outputs equal byte for
byte.
"""

import os
import stat
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import yaml

from wav2vecsegmenter_tpu.checkpoints.io import save_orbax
from wav2vecsegmenter_tpu.checkpoints.torch_export import (
    export_torch_checkpoint)
from wav2vecsegmenter_tpu.config import compose, save_config
from wav2vecsegmenter_tpu.data.audio import write_wav

from .helpers import make_speechlike_wav, tiny_shas
from .torch_tiny import threads_per_worker, tiny_builders  # noqa: F401

CONF = Path(__file__).resolve().parents[1] / "conf"


def _stage1_args(tmp_path, side: str, inference_times: int):
    return SimpleNamespace(
        save_dir=str(tmp_path / f"synth_{side}"),
        outputs=str(tmp_path / f"outputs_{side}"), checkpoint="epoch-0",
        path_to_wavs=str(tmp_path / "wav"), inference_segment_length=4,
        inference_times=inference_times, inference_batch_size=2,
        max_segment_length=6, min_segment_length=0.2,
        boundary_threshold=0.5, trim_threshold=0.0, tree_depth=4,
        device="cpu")


@pytest.mark.parametrize("inference_times", [1, 2])
def test_stage1_tree_equals_jax(tmp_path, tiny_builders, inference_times):
    """custom_segments.tree.yaml and tree.length of the port's stage 1
    equal the JAX stage 1's on the same tiny weights (two talks, one
    dispatched ahead of the other; 4 s windows at batch 2)."""
    from wav2vecsegmenter_tpu.cli.prepare_synthetic_data import (
        generate_segmentation_tree as jax_stage1)
    from wav2vecsegmenter_tpu_torch.cli.prepare_synthetic_data import (
        generate_segmentation_tree)

    (tmp_path / "wav").mkdir()
    make_speechlike_wav(tmp_path / "wav" / "t1.wav", duration_secs=17,
                        seed=2)
    make_speechlike_wav(tmp_path / "wav" / "t2.wav", duration_secs=9.3,
                        seed=3)
    cfg = compose(CONF, "train", overrides=["exp_name=exp"])
    jm = tiny_shas()
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    for side in ("jax", "port"):
        out = tmp_path / f"outputs_{side}"
        save_config(cfg, out / ".hydra" / "config.yaml")
        (out / "exp" / "ckpts").mkdir(parents=True)
    save_orbax(tmp_path / "outputs_jax" / "exp" / "ckpts" / "epoch-0",
               params)
    export_torch_checkpoint(params, tiny_shas(finetune_wav2vec=True),
                            tmp_path / "outputs_port" / "exp" / "ckpts"
                            / "epoch-0.pt")
    jax_stage1(_stage1_args(tmp_path, "jax", inference_times))
    generate_segmentation_tree(_stage1_args(tmp_path, "port",
                                            inference_times))
    for name in ("custom_segments.tree.yaml", "tree.length"):
        got = (tmp_path / "synth_port" / name).read_bytes()
        assert got == (tmp_path / "synth_jax" / name).read_bytes(), name
    rows = yaml.safe_load((tmp_path / "synth_port" /
                           "custom_segments.tree.yaml").read_text())
    lengths = (tmp_path / "synth_port" / "tree.length").read_text()
    assert lengths.splitlines()[0].startswith("t1.wav\t")
    assert {r["wav"] for r in rows} == {"t1.wav", "t2.wav"}
    assert len({r["speaker_id"] for r in rows}) > 2


def test_stage1_runs_on_cuda_unless_asked_for_cpu(tmp_path, tiny_builders):
    """Stage 1 asks for the card by default and raises without one."""
    from wav2vecsegmenter_tpu_torch.cli.prepare_synthetic_data import (
        generate_segmentation_tree)

    (tmp_path / "wav").mkdir()
    out = tmp_path / "outputs_port"
    save_config(compose(CONF, "train", overrides=["exp_name=exp"]),
                out / ".hydra" / "config.yaml")
    args = _stage1_args(tmp_path, "port", 1)
    del args.device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_segmentation_tree(args)


FAKE = """#!/bin/bash
echo 'D-0 -0.1 voellig falscher elterntext hier'
echo 'D-1 -0.1 hallo welt dies ist das allererste segment'
echo 'D-2 -0.1 und hier kommt das zweite laengere segment'
echo 'D-4 -0.1 das zweite laengere segment'
echo 'D-3 -0.1 und hier kommt'
"""


@pytest.mark.parametrize("evaluate", [False, True])
def test_stages_2_3_equal_jax(tmp_path, monkeypatch, evaluate):
    """Stages 2-3 through main() of each package on one stage-1 output (a
    depth-2 tree; a bad parent, good children): the manifest, the formatted
    translations, the tournament's selection and its MuST-C yaml and TSVs
    equal the JAX tool's; with --evaluate_data also the mWER realignment
    (the port's own binary) and its BLEU."""
    from wav2vecsegmenter_tpu.cli.prepare_synthetic_data import (
        main as jax_main)
    from wav2vecsegmenter_tpu_torch.cli.prepare_synthetic_data import main

    wav_dir = tmp_path / "wav"
    wav_dir.mkdir()
    rng = np.random.RandomState(3)
    write_wav(wav_dir / "t1.wav", rng.randn(16000 * 6).astype(np.float32)
              * 0.1)
    tree = [(6.0, 0.0), (3.0, 0.0), (3.0, 3.0), (1.6, 3.0), (1.2, 4.6)]
    rows = [{"duration": d, "offset": o, "rW": 0, "uW": 0,
             "speaker_id": str(i if i < 3 else i + 2), "wav": "t1.wav"}
            for i, (d, o) in enumerate(tree)]
    ref_de = ["hallo welt dies ist das allererste segment",
              "und hier kommt das zweite laengere segment"]
    with open(tmp_path / "dev.yaml", "w") as f:
        yaml.dump([{"duration": 3.0, "offset": 0.0, "wav": "t1.wav"},
                   {"duration": 3.0, "offset": 3.0, "wav": "t1.wav"}], f)
    (tmp_path / "dev.en").write_text("hello one\nhello two\n")
    (tmp_path / "dev.de").write_text("\n".join(ref_de) + "\n")
    bindir = tmp_path / "bin"
    bindir.mkdir()
    fake = bindir / "fairseq-generate"
    fake.write_text(FAKE)
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    st_dir = tmp_path / "stmodel"
    st_dir.mkdir()
    (st_dir / "ckpt.pt").write_text("")

    outs = {}
    for side, fn in (("jax", jax_main), ("port", main)):
        save_dir = tmp_path / f"synth_{side}"
        save_dir.mkdir()
        with open(save_dir / "custom_segments.tree.yaml", "w") as f:
            yaml.dump(rows, f, default_flow_style=True, sort_keys=False)
        (save_dir / "tree.length").write_text("t1.wav\t7\n")
        fn(["--stage", "2", "--stop_stage", "3",
            "--save_dir", str(save_dir), "--path_to_wavs", str(wav_dir),
            "--path_to_st_checkpoint", str(st_dir / "ckpt.pt"),
            "--fairseq_root", str(tmp_path), "--tgt_lang", "de",
            "--path_to_src_yaml", str(tmp_path / "dev.yaml"),
            "--path_to_src_txt", str(tmp_path / "dev.en"),
            "--path_to_ref_txt", str(tmp_path / "dev.de"),
            "--tree_depth", "2", *(["--evaluate_data"] if evaluate else [])])
        outs[side] = save_dir

    got, want = outs["port"], outs["jax"]
    names = sorted(str(p.relative_to(want)) for p in want.rglob("*")
                   if p.is_file())
    assert names == sorted(str(p.relative_to(got)) for p in got.rglob("*")
                           if p.is_file())
    assert ("synthetic_data/score.sacrebleu" in names) == evaluate
    for name in names:
        if name.endswith(".zip"):
            continue  # its entries' times; its bytes feed the TSV's offsets
        a = (got / name).read_text().replace(str(got), "<dir>")
        b = (want / name).read_text().replace(str(want), "<dir>")
        assert a == b, name
    selected = yaml.safe_load(
        (got / "synthetic_data" / "custom_segments.yaml").read_text())
    assert [s["offset"] for s in selected] == [0.0, 3.0]
