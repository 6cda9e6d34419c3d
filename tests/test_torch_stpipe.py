"""The port's ST-evaluation harness (``stpipe/``) and its CLIs against the
JAX package's: ``eval_st`` end to end with a fake ``fairseq-generate`` on
``PATH`` (the dataset, the generation parsing, the port's own build of the
mWER resegmenter, sacreBLEU), ``get_statistics``, and the ST-pipe CLI on
the tiny model of tests/helpers on the CPU; and the port's native builds
(``data/native_audio.build_native``), which write under the port's
``_build/`` and leave ``native/`` as it was.
"""

import hashlib
import os
import stat
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from wav2vecsegmenter_tpu.config import Config as JConfig
from wav2vecsegmenter_tpu.data.audio import write_wav
from wav2vecsegmenter_tpu_torch.config import Config as TConfig

from .torch_tiny import (cli_workspace, threads_per_worker,  # noqa: F401
                         tiny_builders)

REPO = Path(__file__).resolve().parents[1]

# the fake generator's words: a hypothesis line cycles through the
# reference's words, so that BLEU is neither 0 nor 100
FAKE_GENERATE = """#!{python}
import sys
from pathlib import Path
args = sys.argv[1:]
subset = args[args.index("--gen-subset") + 1]
rows = (Path(args[0]) / (subset + ".tsv")).read_text().splitlines()[1:]
words = "hallo welt dies ist das erste segment und hier kommt das zweite".split()
for i in range(len(rows)):
    k = (3 * i) % len(words)
    print("H-%d -0.5 x" % i)
    print("D-%d -0.1 %s" % (i, " ".join((words + words)[k:k + 4 + i % 5])))
"""


def fake_fairseq(bindir: Path, monkeypatch) -> None:
    """A ``fairseq-generate`` on ``PATH`` that writes one D-line for each row
    of the dataset's TSV (stdout is redirected to translations.txt by the
    caller's shell command)."""
    bindir.mkdir(exist_ok=True)
    fake = bindir / "fairseq-generate"
    fake.write_text(FAKE_GENERATE.format(python=sys.executable))
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")


def st_corpus(root: Path, talks: dict) -> dict:
    """``root/wav`` with the talks ({name: seconds}, speech-like noise), the
    corpus segmentation ``dev.yaml`` (3 s segments) and its transcript and
    translation ``dev.en`` / ``dev.de``: the ``infer_data`` node."""
    rng = np.random.RandomState(1)
    (root / "wav").mkdir(parents=True, exist_ok=True)
    orig, en, de = [], [], []
    for name, secs in talks.items():
        path = root / "wav" / name
        if not path.exists():
            write_wav(path, rng.randn(int(16000 * secs)).astype(np.float32)
                      * 0.1)
        for k, off in enumerate(np.arange(0.0, secs - 1.0, 3.0)):
            orig.append({"duration": float(min(3.0, secs - off)),
                         "offset": float(off), "wav": name})
            en.append(f"hello world segment {k} of {name}")
            de.append(" ".join(["hallo welt dies ist das erste segment",
                                "und hier kommt das zweite"][k % 2:]))
    with open(root / "dev.yaml", "w") as f:
        yaml.dump(orig, f)
    (root / "dev.en").write_text("\n".join(en) + "\n")
    (root / "dev.de").write_text("\n".join(de) + "\n")
    return {"wav_dir": str(root / "wav"), "tgt_lang": "de", "src_lang": "en",
            "orig_seg_yaml": str(root / "dev.yaml"),
            "orig_src_txt": str(root / "dev.en"),
            "orig_tgt_txt": str(root / "dev.de")}


def st_config(root: Path, infer_data: dict, model_dir: str) -> dict:
    return {"cust_seg_yaml": "custom_segments.yaml",
            "st_model_dir": str(root / model_dir), "st_ckpt": "ckpt.pt",
            "fairseq_root": str(root), "st_metrics": ["bleu"],
            "infer_data": infer_data}


def as_config(cls, conf: dict):
    """A plain dict as a package's Config, nested nodes too."""
    return cls({k: as_config(cls, v) if isinstance(v, dict) else v
                for k, v in conf.items()})


ST_FILES = ("custom_segments.yaml", "translations.txt",
            "translations_formatted.txt", "__segments", "__mreference",
            "score.sacrebleu", "dev.en.xml", "dev.de.xml")


def assert_same_st_outputs(got: Path, want: Path) -> None:
    """The files of two eval_st runs equal; the manifest TSV equal but for
    its directory, the feature zip's entries equal."""
    import zipfile

    for name in ST_FILES:
        assert (got / name).read_bytes() == (want / name).read_bytes(), name
    assert (got / "custom_segments.tsv").read_text().replace(
        str(got), "<dir>") == (want / "custom_segments.tsv").read_text(
        ).replace(str(want), "<dir>")
    with zipfile.ZipFile(got / "fbank80.zip") as a, \
            zipfile.ZipFile(want / "fbank80.zip") as b:
        assert [(i.filename, i.header_offset) for i in a.infolist()] == [
            (i.filename, i.header_offset) for i in b.infolist()]
        for info in a.infolist():
            assert a.read(info) == b.read(info.filename), info.filename


CUSTOM = [
    {"duration": 2.5, "offset": 0.0, "rW": 0, "uW": 0, "speaker_id": "NA",
     "wav": "t1.wav"},
    {"duration": 3.2, "offset": 2.8, "rW": 0, "uW": 0, "speaker_id": "NA",
     "wav": "t1.wav"},
    {"duration": 4.0, "offset": 1.0, "rW": 0, "uW": 0, "speaker_id": "NA",
     "wav": "t2.wav"},
    {"duration": 0.02, "offset": 5.0, "rW": 0, "uW": 0, "speaker_id": "NA",
     "wav": "t2.wav"},
]


@pytest.mark.parametrize("style,model_dir", [
    ("train", "whatever"), ("cli", "joint-s2t-mustc-en-de"),
    ("cli", "mustc_multilingual_st")])
def test_eval_st_equals_jax(tmp_path, monkeypatch, style, model_dir):
    """eval_st on one segmentation (a segment too short for the manifest
    among them) in each command style: the port's results dict and files
    equal the JAX eval_st's; the fake generator's hypotheses realigned by
    the port's own mWER binary."""
    from wav2vecsegmenter_tpu.stpipe.eval_st import eval_st as jax_eval_st
    from wav2vecsegmenter_tpu_torch.stpipe.eval_st import eval_st

    fake_fairseq(tmp_path / "bin", monkeypatch)
    data = st_corpus(tmp_path, {"t1.wav": 7.0, "t2.wav": 6.0})
    conf = st_config(tmp_path, data, model_dir)
    got = eval_st(as_config(TConfig, conf), [dict(r) for r in CUSTOM],
                  tmp_path / "port", "dac", cmd_style=style)
    want = jax_eval_st(as_config(JConfig, conf), [dict(r) for r in CUSTOM],
                       tmp_path / "jax", "dac", cmd_style=style)
    assert got == want
    assert got["eval_st_n_segments_dac"] == 4
    assert 0 < got["eval_st_bleu_dac"] < 100
    assert_same_st_outputs(tmp_path / "port", tmp_path / "jax")


def test_eval_st_without_a_generator(tmp_path, monkeypatch):
    """fairseq-generate missing: both report the segment count alone."""
    from wav2vecsegmenter_tpu.stpipe.eval_st import eval_st as jax_eval_st
    from wav2vecsegmenter_tpu_torch.stpipe.eval_st import eval_st

    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    data = st_corpus(tmp_path, {"t1.wav": 7.0, "t2.wav": 6.0})
    conf = st_config(tmp_path, data, "whatever")
    got = eval_st(as_config(TConfig, conf), CUSTOM[:2], tmp_path / "port",
                  "pthr")
    want = jax_eval_st(as_config(JConfig, conf), CUSTOM[:2],
                       tmp_path / "jax", "pthr")
    assert got == want == {"eval_st_n_segments_pthr": 2}


def test_get_statistics_equals_jax(tmp_path):
    """The per-sentence statistics TSV of the port's CLI equals the JAX
    CLI's (BERTScore absent: NA columns), alignment by the port's mWER
    binary."""
    from wav2vecsegmenter_tpu.cli.get_statistics import main as jax_main
    from wav2vecsegmenter_tpu_torch.cli.get_statistics import main

    outs = {}
    for side, fn in (("port", main), ("jax", jax_main)):
        work = tmp_path / side
        work.mkdir()
        (work / "__translation").write_text(
            "hallo welt dies ist\ndas erste segment und hier\n"
            "kommt das zweite\n")
        (work / "__mreference").write_text(
            "hallo welt dies ist das erste segment\n"
            "und hier kommt das zweite\n")
        with open(work / "custom_segments.yaml", "w") as f:
            yaml.dump([dict(r) for r in CUSTOM[:3]], f,
                      default_flow_style=True)
        outs[side] = fn([str(work), "de"])
    got, want = (outs[s].read_bytes() for s in ("port", "jax"))
    assert got == want and got.count(b"\n") == 4
    assert b"NA" in got


def _tree_hashes(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()
                                                     ).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_native_builds_go_to_the_ports_build_dir(tmp_path, monkeypatch):
    """The wav/FLAC library and the mWER binary build from native/*/*.cpp
    into the build dir (here a fresh one), keyed by sources and flags; the
    native library is the path taken on this host (g++ present); nothing
    under native/ changes.  The JAX package's own make targets
    (libw2vaudio.so, mwer_segmenter) may appear there meanwhile, from its
    tests in other workers; a file that was there stays byte for byte."""
    from wav2vecsegmenter_tpu_torch.data import native_audio
    from wav2vecsegmenter_tpu_torch.stpipe import flac, mwer

    before = _tree_hashes(REPO / "native")
    monkeypatch.setattr(native_audio, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native_audio, "_LIB", None)
    monkeypatch.setattr(native_audio, "_TRIED", False)
    assert native_audio.available()
    binary = mwer._ensure_native_built()
    built = sorted(p.name for p in (tmp_path / "_build").iterdir())
    assert len(built) == 2 and binary.parent == tmp_path / "_build"
    assert built[0].startswith("libw2vaudio_") and built[0].endswith(".so")
    assert built[1].startswith("mwer_segmenter_")
    assert os.access(binary, os.X_OK)
    # a second call finds the file
    assert mwer._ensure_native_built() == binary
    samples = (np.sin(np.arange(9000) / 7) * 9000).astype(np.int16)
    assert flac.encode_flac(samples) == native_audio.encode_flac(samples,
                                                                 16000)
    after = _tree_hashes(REPO / "native")
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) <= {"audio/libw2vaudio.so",
                                        "mwer/mwer_segmenter"}


def test_native_wav_reads_equal_the_wave_reader(tmp_path):
    """The binding's wav info and window reads against the port's stdlib
    reader (data/audio.py)."""
    from wav2vecsegmenter_tpu_torch.data import audio, native_audio

    path = tmp_path / "a.wav"
    write_wav(path, np.random.RandomState(3).randn(23456).astype(np.float32)
              * 0.2)
    assert native_audio.wav_info(str(path)) == audio.wav_info(path)
    for offset, n in ((0, 23456), (100, 5000), (20000, -1)):
        want = audio.read_wav_window(path, offset, None if n < 0 else n)
        np.testing.assert_array_equal(
            native_audio.read_window(str(path), offset, n), want)


# ------------------------------------------------------ the ST-pipe CLI

TALKS = {"talk1.wav": 13.0, "talk2.wav": 9.0}


def _st_args(ws, data: dict, *extra) -> list[str]:
    return [f"outputs={ws}/run", "ckpt=final.pt",
            *(f"infer_data.{k}={v}" for k, v in data.items()),
            f"st_model_dir={ws}/joint-s2t-mustc-en-de", "st_ckpt=ckpt.pt",
            f"fairseq_root={ws}", "st_metrics=[bleu]",
            "inference_segment_length=4", "batch_size=3",
            "runtime.compute_dtype=float32", "+runtime.device=cpu", *extra]


def test_st_pipe_cli(tmp_path, tiny_builders, monkeypatch):
    """The port's ST-pipe CLI on the CPU: its segmentation equals the
    port's inference CLI's, its results and files equal the JAX eval_st's
    on those rows (the ST-pipe command style), and a -m sweep over two
    algorithms runs one job each, in its own run directory."""
    from wav2vecsegmenter_tpu.stpipe.eval_st import eval_st as jax_eval_st
    from wav2vecsegmenter_tpu_torch.cli import inference, inference_st_pipe

    ws = cli_workspace(tmp_path, TALKS)
    fake_fairseq(tmp_path / "bin", monkeypatch)
    data = st_corpus(ws, TALKS)
    dac = ("algorithm=dac", "algorithm.max_segment_length=4")
    rows = inference.main(_st_args(ws, data, *dac, f"+results_path={ws}/seg"))
    results = inference_st_pipe.main(_st_args(ws, data, *dac,
                                              f"+results_path={ws}/st"))
    assert (ws / "st" / "custom_segments.yaml").read_bytes() == (
        ws / "seg" / "custom_segments.yaml").read_bytes()
    conf = st_config(ws, data, "joint-s2t-mustc-en-de")
    want = jax_eval_st(as_config(JConfig, conf), rows, ws / "jax", "dac",
                       cmd_style="cli")
    assert results == want and len(rows) > 2
    assert results["eval_st_n_segments_dac"] == len(rows)
    assert 0 < results["eval_st_bleu_dac"] < 100
    assert_same_st_outputs(ws / "st", ws / "jax")

    swept = inference_st_pipe.main(["-m", *_st_args(
        ws, data, "algorithm=dac,pthr", "algorithm.max_segment_length=4")])
    assert [sorted(r) for r in swept] == [
        ["eval_st_bleu_dac", "eval_st_n_segments_dac"],
        ["eval_st_bleu_pthr", "eval_st_n_segments_pthr"]]
    assert swept[0] == results
    root = ws / "run" / "infer_outputs"
    runs = sorted(str(p.parent.relative_to(root))
                  for p in root.rglob("score.sacrebleu"))
    assert len(runs) == 2
    assert "algorithm=dac" in runs[0] and "algorithm=pthr" in runs[1]
