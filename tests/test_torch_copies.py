"""The port's own copies of the JAX package's jax-free helpers, held equal to
the originals: constants, frame conversions, window grids, wav reads,
collation (the CTC task's transcript tokens too, and the autoregressive
task's batch), the vocabularies, the
segmentation algorithms (pDAC with logits too), the config composer and the
CLIs' override helpers (sweeps, run directories, the online hop mode's
knobs).
Equality is exact: the same arrays, the same segment lists, the same
configs.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

import wav2vecsegmenter_tpu.algorithms as jalgo
import wav2vecsegmenter_tpu.cli.common as jcommon
import wav2vecsegmenter_tpu.config as jconfig
import wav2vecsegmenter_tpu.constants as jconst
from wav2vecsegmenter_tpu.core import frames as jframes
from wav2vecsegmenter_tpu.core import windows as jwindows
from wav2vecsegmenter_tpu.data import audio as jaudio
from wav2vecsegmenter_tpu.data import collate as jcollate
from wav2vecsegmenter_tpu.data import vocab as jvocab
import wav2vecsegmenter_tpu_torch.algorithms as talgo
import wav2vecsegmenter_tpu_torch.cli.common as tcommon
import wav2vecsegmenter_tpu_torch.config as tconfig
import wav2vecsegmenter_tpu_torch.constants as tconst
from wav2vecsegmenter_tpu_torch.core import frames as tframes
from wav2vecsegmenter_tpu_torch.core import windows as twindows
from wav2vecsegmenter_tpu_torch.data import audio as taudio
from wav2vecsegmenter_tpu_torch.data import collate as tcollate
from wav2vecsegmenter_tpu_torch.data import vocab as tvocab

from .helpers import make_speechlike_wav

CONF = Path(__file__).resolve().parents[1] / "conf"


def test_constants_equal():
    for name in ("INPUT_SAMPLE_RATE", "TARGET_SAMPLE_RATE",
                 "WAV2VEC_FRAME_LEN"):
        assert getattr(tconst, name) == getattr(jconst, name)


def test_frame_conversions_equal():
    x = np.random.RandomState(0).rand(1000) * 1e6
    for name in ("secs_to_outframes", "outframes_to_inframes",
                 "inframes_to_outframes", "secs_to_inframes",
                 "conv_output_length"):
        np.testing.assert_array_equal(getattr(tframes, name)(x.astype(int)),
                                      getattr(jframes, name)(x.astype(int)))
        np.testing.assert_array_equal(getattr(tframes, name)(x),
                                      getattr(jframes, name)(x))


@pytest.mark.parametrize("inference_times", [1, 2, 3])
def test_window_grid_equal(inference_times):
    for duration in (100, 320000, 320001, 351999, 352000, 1040000, 659219):
        for it in range(inference_times):
            got = twindows.fixed_window_grid(duration, 20, inference_times, it)
            want = jwindows.fixed_window_grid(duration, 20, inference_times,
                                              it)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 3])
def test_random_window_grid_equal(seed):
    for total in (100, 320000, 659219, 1040000):
        got = twindows.random_window_grid(total, 20,
                                          np.random.RandomState(seed))
        want = jwindows.random_window_grid(total, 20,
                                           np.random.RandomState(seed))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_wav_reads_equal(tmp_path):
    path = tmp_path / "talk.wav"
    make_speechlike_wav(path, duration_secs=3.3, seed=4)
    assert taudio.assert_sample_rate(path) == jaudio.assert_sample_rate(path)
    for offset, n in ((0, None), (100, 5000), (52000, 10000)):
        np.testing.assert_array_equal(taudio.read_wav_window(path, offset, n),
                                      jaudio.read_wav_window(path, offset, n))
    ours, theirs = taudio.WaveformCache(1), jaudio.WaveformCache(1)
    np.testing.assert_array_equal(ours.window(path, 7, 900),
                                  theirs.window(path, 7, 900))
    ours.clear()
    theirs.clear()
    assert not ours._data and not theirs._data


@pytest.mark.parametrize("device_normalize", [True, False])
def test_collate_equal(device_normalize):
    rng = np.random.RandomState(5)
    examples = [(rng.randn(n).astype(np.float32) * 0.1, None, s, s + n // 320)
                for n, s in ((32000, 0), (25000, 100), (31990, 200))]
    examples.append((np.zeros(32000, np.float32), None, 300, 400))  # silent
    audio_len = 32000
    got = tcollate.collate(examples, 6, audio_len,
                           tcollate.out_len_for(audio_len),
                           device_normalize=device_normalize)
    want = jcollate.collate(examples, 6, audio_len,
                            jcollate.out_len_for(audio_len),
                            device_normalize=device_normalize)
    for field in dataclasses.fields(got):
        a, b = getattr(got, field.name), getattr(want, field.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, field.name
            np.testing.assert_array_equal(a, b, err_msg=field.name)
        else:
            assert a == b, field.name


@pytest.mark.parametrize("rows", [2, 3])
def test_collate_autoreg_equal(rows):
    """The autoregressive batch: SEP-led in_target and SEP-tailed
    out_target [B, T+1], tgt_mask [B, T+1], src_mask [B, T], the audio
    normalized on the host (ddof=1); a silent window and, at 3 rows, an
    empty padding row."""
    rng = np.random.RandomState(6)
    vocab = tvocab.BaseVocabulary()
    examples = []
    for n in (32000, 20000):
        t = int(tcollate.out_len_for(n))
        target = (rng.rand(t) > 0.5).astype(np.float32)
        examples.append((rng.randn(n).astype(np.float32) * 0.1, target, 0, t))
    examples[1] = (np.zeros(20000, np.float32), *examples[1][1:])
    args = (examples, rows, 32000, tcollate.out_len_for(32000),
            vocab.pad_token_id, vocab.sep_token_id)
    got, want = tcollate.collate_autoreg(*args), jcollate.collate_autoreg(*args)
    assert [f.name for f in dataclasses.fields(got)] == [
        f.name for f in dataclasses.fields(want)]
    for field in dataclasses.fields(got):
        a, b = getattr(got, field.name), getattr(want, field.name)
        assert a.dtype == b.dtype, field.name
        np.testing.assert_array_equal(a, b, err_msg=field.name)
    assert got.in_target.shape == (rows, tcollate.out_len_for(32000) + 1)
    assert (got.in_target[:2, 0] == vocab.sep_token_id).all()


def test_vocabularies_equal(tmp_path):
    """The four special tokens, the embedded CTC char vocabulary offset by
    them, a local vocab.json, and transcripts encoded (spaces to '|',
    unknown characters to <unk>)."""
    import json

    assert tvocab.WAV2VEC2_CTC_CHAR_VOCAB == jvocab.WAV2VEC2_CTC_CHAR_VOCAB
    path = tmp_path / "vocab.json"
    path.write_text(json.dumps({"<pad>": 0, "|": 1, "A": 2, "<unk>": 3}))
    for make in (lambda m: m.BaseVocabulary(),
                 lambda m: m.UppercasedCharVocabulary(),
                 lambda m: m.UppercasedCharVocabulary(str(path))):
        got, want = make(tvocab), make(jvocab)
        assert vars(got) == vars(want)
    got, want = tvocab.UppercasedCharVocabulary(), \
        jvocab.UppercasedCharVocabulary()
    for text in ("hello  world", "It's 5 o'clock!", "", "  Zq x  "):
        assert got.encode_transcript(text) == want.encode_transcript(text)


@pytest.mark.parametrize("texts", [
    ["HELLO WORLD", "", "ABCDEFGHIJKLMNOPQRSTUVWXYZ" * 3],
    ["a b", "x"]])
def test_collate_tokens_equal(texts):
    """Transcript tokens padded with <PAD>, each row cut to its own conv
    frame count (clamped at 0 for a window shorter than the receptive
    field), and the targets padded with the vocabulary's <PAD>."""
    rng = np.random.RandomState(2)
    lengths = (16000, 300, 6000)[:len(texts)]
    examples = [(rng.randn(n).astype(np.float32) * 0.1,
                 np.ones(max(1, n // 320), np.float32), 0, n // 320)
                for n in lengths]
    kw = dict(pad_token_id=2, device_normalize=True, transcripts=texts)
    got = tcollate.collate(examples, 4, 16000, 50, **kw,
                           ctc_vocab=tvocab.UppercasedCharVocabulary())
    want = jcollate.collate(examples, 4, 16000, 50, **kw,
                            ctc_vocab=jvocab.UppercasedCharVocabulary())
    assert got.tokens is not None and got.tokens.dtype == want.tokens.dtype
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.target, want.target)


def _probs(seed: int, n: int = 6000) -> np.ndarray:
    """A speech-like frame-probability curve: smooth runs above and below
    the thresholds with noise."""
    rng = np.random.RandomState(seed)
    base = np.repeat(rng.rand(n // 50 + 1) > 0.3, 50)[:n].astype(float)
    return np.clip(0.8 * base + 0.3 * rng.randn(n) * rng.rand(n), 0, 1)


def _spans(segments):
    return [(s.start, s.end, s.duration, s.offset) for s in segments]


ALGOS = {
    "pthr": dict(max_segment_length=28, min_segment_length=0.2,
                 max_lerp_range=4, min_lerp_range=0.4, threshold=0.1,
                 moving_average_window=0.1),
    "pdac": dict(max_segment_length=10, min_segment_length=0.2,
                 threshold=0.5),
    "strm": dict(max_segment_length=10, min_segment_length=0.2,
                 min_pause_length=0.2, threshold=0.5),
}


@pytest.mark.parametrize("algo", list(ALGOS))
def test_algorithms_equal(algo):
    rows_t, rows_j = [], []
    for seed in range(4):
        probs = _probs(seed)
        got = getattr(talgo, algo)(probs.copy(), **ALGOS[algo])
        want = getattr(jalgo, algo)(probs.copy(), **ALGOS[algo])
        assert _spans(got) == _spans(want) and got
        talgo.update_yaml_content(rows_t, got, f"talk{seed}.wav")
        jalgo.update_yaml_content(rows_j, want, f"talk{seed}.wav")
    assert rows_t == rows_j


def test_config_compose_equal(tmp_path):
    overrides = ["algorithm=dac", "batch_size=3", "+runtime.device=cpu",
                 "algorithm.max_segment_length=10"]
    got = tconfig.compose(CONF, "segment", overrides)
    want = jconfig.compose(CONF, "segment", overrides)
    assert tconfig.to_plain(got) == jconfig.to_plain(want)
    assert got.runtime.device == "cpu"
    jconfig.save_config(want, tmp_path / "c.yaml")
    loaded = tconfig.load_config(tmp_path / "c.yaml")
    assert tconfig.to_plain(tconfig.merge(loaded, got)) == jconfig.to_plain(
        jconfig.merge(jconfig.load_config(tmp_path / "c.yaml"), want))
    assert tconfig.to_plain(tconfig.resolve(loaded)) == jconfig.to_plain(
        jconfig.resolve(jconfig.load_config(tmp_path / "c.yaml")))


SWEEP_ARGVS = [
    ["-m", "outputs=/o", "algorithm=dac", "algorithm.max_segment_length=10,12",
     "algorithm.threshold=0.2,0.5,0.8", "+runtime.device=cpu"],
    ["--multirun", "st_metrics=[bleu,bertscore]", "a={x: 1, y: 2},b",
     "~c=1", "+d.e=3,4"],
    ["outputs=/o", "ckpt=epoch-15_best_eval_f1", "st_metrics=[bleu,b]",
     "--flag", "x"],
    ["-m"],
]


@pytest.mark.parametrize("argv", SWEEP_ARGVS)
def test_sweep_parsing_equal(argv):
    """parse_cli, _split_sweep, expand_sweeps and hydra_override_dirname
    (with the conf files' exclude lists) against the JAX CLI's."""
    got, want = tcommon.parse_cli(argv), jcommon.parse_cli(argv)
    assert got == want
    jobs = tcommon.expand_sweeps(got[1])
    assert jobs == jcommon.expand_sweeps(want[1])
    for ov in got[1]:
        value = ov.partition("=")[2]
        assert tcommon._split_sweep(value) == jcommon._split_sweep(value)
    for app in ("segment", "inference", "online"):
        exclude = jconfig.compose(CONF, app, [], resolve_interp=False).select(
            "hydra.job.config.override_dirname.exclude_keys")
        for job in jobs:
            assert (tcommon.hydra_override_dirname(job, exclude)
                    == jcommon.hydra_override_dirname(job, exclude))
    with pytest.raises(ValueError, match="multirun"):
        tcommon.parse_cli(["algorithm.threshold=0.2,0.8"])
    with pytest.raises(ValueError, match="multirun"):
        jcommon.parse_cli(["algorithm.threshold=0.2,0.8"])


@pytest.mark.parametrize("overrides", [
    [], ["+hop_secs=2"], ["+hop_secs=2", "+lookahead_secs=0.5"],
    ["+lookahead_secs=1"]])
def test_hop_conf_equal(overrides):
    """The online hop mode's kwargs from conf/online.yaml and overrides."""
    got = tcommon.hop_conf(tconfig.compose(CONF, "online", overrides,
                                           resolve_interp=False))
    want = jcommon.hop_conf(jconfig.compose(CONF, "online", overrides,
                                            resolve_interp=False))
    assert got == want


@pytest.mark.parametrize("vocab", ["base", "char"])
def test_pdac_with_logits_equal(vocab):
    """argtrim, split_and_argtrim and pdac_with_logits over frame logits
    whose argmax runs through <B> stretches, against the JAX copies."""
    rows_t, rows_j = [], []
    make = {"base": "BaseVocabulary", "char": "UppercasedCharVocabulary"}
    tv = getattr(tvocab, make[vocab])()
    jv = getattr(jvocab, make[vocab])()
    for seed in range(3):
        probs = _probs(seed, 3000)
        rng = np.random.RandomState(seed)
        logits = rng.randn(3000, tv.vocab_size)
        logits[:, 0] += 4 * (probs < 0.3)  # <B> where the probs are low
        got = talgo.pdac_with_logits(probs.copy(), logits.copy(), tv,
                                     max_segment_length=8)
        want = jalgo.pdac_with_logits(probs.copy(), logits.copy(), jv,
                                      max_segment_length=8)
        assert _spans(got) == _spans(want) and len(got) > 2
        sgm = talgo.Segment(0, 3000, probs=probs, logits=logits)
        jsgm = jalgo.Segment(0, 3000, probs=probs, logits=logits)
        assert _spans([talgo.argtrim(sgm, tv)]) == _spans(
            [jalgo.argtrim(jsgm, jv)])
        assert _spans(talgo.split_and_argtrim(sgm, 1500, tv)) == _spans(
            jalgo.split_and_argtrim(jsgm, 1500, jv))
        talgo.update_yaml_content(rows_t, got, f"talk{seed}.wav")
        jalgo.update_yaml_content(rows_j, want, f"talk{seed}.wav")
    assert rows_t == rows_j


# ------------------------------------- the ST harness and the data tools

def test_fbank_equal():
    """fbank80 arrays (an impulse train with a DC offset, and noise) and
    the mel filterbank."""
    from wav2vecsegmenter_tpu.stpipe import fbank as jfbank
    from wav2vecsegmenter_tpu_torch.stpipe import fbank as tfbank

    rng = np.random.RandomState(7)
    noise = (rng.randn(23456) * 0.2).astype(np.float32)
    impulses = np.full(9000, 0.05, np.float32)
    impulses[::400] = 0.9
    for wav in (noise, impulses, noise[:300]):
        np.testing.assert_array_equal(tfbank.fbank80(wav),
                                      jfbank.fbank80(wav))
    np.testing.assert_array_equal(tfbank.mel_filterbank(80, 512, 16000),
                                  jfbank.mel_filterbank(80, 512, 16000))


@pytest.mark.parametrize("n", [0, 4096, 12345])
def test_flac_equal(n):
    """The port's native encoder = its Python encoder = the JAX package's
    Python encoder (which the JAX tests hold equal to its native one); a
    silent block; the decode round trip; a corrupted byte fails the CRC."""
    from wav2vecsegmenter_tpu.stpipe import flac as jflac
    from wav2vecsegmenter_tpu_torch.data import native_audio
    from wav2vecsegmenter_tpu_torch.stpipe import flac as tflac

    rng = np.random.RandomState(n)
    x = (rng.randn(n) * 0.3).astype(np.float32)
    x[: min(n, 5000)] = 0.0  # a constant block
    assert native_audio.available()
    got = tflac.encode_flac(x)
    assert got == tflac._encode_flac_py(tflac.to_int16(x), 16000)
    assert got == jflac._encode_flac_py(jflac.to_int16(x), 16000)
    samples, sr = tflac.decode_flac(got)
    assert sr == 16000
    np.testing.assert_array_equal(samples, tflac.to_int16(x))
    if n:
        bad = bytearray(got)
        bad[-3] ^= 0x40
        with pytest.raises(ValueError, match="CRC"):
            tflac.decode_flac(bytes(bad))


@pytest.mark.parametrize("use_audio_input", [0, 1])
def test_prepare_custom_dataset_equal(tmp_path, monkeypatch,
                                      use_audio_input):
    """The fairseq dataset of a segmentation (two talks, a segment too
    short for the manifest, unsorted offsets): the TSV and the zip, byte
    for byte (the zip entries' times pinned), fbank features or FLAC."""
    import time

    import yaml

    from wav2vecsegmenter_tpu.data import native_audio as jnative
    from wav2vecsegmenter_tpu.stpipe.manifest import (
        prepare_custom_dataset as jprep)
    from wav2vecsegmenter_tpu_torch.stpipe.manifest import (
        prepare_custom_dataset as tprep)

    # the JAX encoder's Python path (its native one builds in native/)
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    rows = [{"duration": 1.5, "offset": 2.0, "speaker_id": "spk1",
             "wav": "a.wav"},
            {"duration": 2.0, "offset": 0.1, "speaker_id": "spk1",
             "wav": "a.wav"},
            {"duration": 0.01, "offset": 3.9, "speaker_id": "spk1",
             "wav": "a.wav"},
            {"duration": 1.0, "offset": 0.5, "speaker_id": "spk2",
             "wav": "b.wav"}]
    wav_dir = tmp_path / "wav"
    wav_dir.mkdir()
    make_speechlike_wav(wav_dir / "a.wav", duration_secs=4.2, seed=1)
    make_speechlike_wav(wav_dir / "b.wav", duration_secs=2.0, seed=2)
    out = {}
    for side, prep in (("jax", jprep), ("port", tprep)):
        (tmp_path / side).mkdir()
        with open(tmp_path / side / "segs.yaml", "w") as f:
            yaml.dump(rows, f)
        tsv = prep(tmp_path / side / "segs.yaml", wav_dir, "de",
                   use_audio_input)
        zipname = "flac.zip" if use_audio_input else "fbank80.zip"
        out[side] = (tsv.read_text().replace(str(tmp_path / side), "<d>"),
                     (tmp_path / side / zipname).read_bytes())
    assert out["port"] == out["jax"]
    assert out["port"][0].count("\n") == 4  # the short segment dropped


def test_xml_and_generation_equal(tmp_path):
    """original_segmentation_to_xml's pair (an empty src/tgt pair
    dropped), format_generation_output, and fairseq_generate_cmd in both
    styles."""
    import yaml

    from wav2vecsegmenter_tpu.stpipe import eval_st as jeval
    from wav2vecsegmenter_tpu.stpipe import generation as jgen
    from wav2vecsegmenter_tpu.stpipe import xml as jxml
    from wav2vecsegmenter_tpu_torch.stpipe import eval_st as teval
    from wav2vecsegmenter_tpu_torch.stpipe import generation as tgen
    from wav2vecsegmenter_tpu_torch.stpipe import xml as txml

    seg = [{"duration": 2.0, "offset": 0.0, "wav": "t1.wav"},
           {"duration": 2.0, "offset": 2.0, "wav": "t1.wav"},
           {"duration": 1.0, "offset": 4.0, "wav": "t1.wav"},
           {"duration": 2.0, "offset": 0.0, "wav": "t2.wav"}]
    for side, mod, gen in (("jax", jxml, jgen), ("port", txml, tgen)):
        d = tmp_path / side
        d.mkdir()
        with open(d / "dev.yaml", "w") as f:
            yaml.dump(seg, f)
        (d / "dev.en").write_text("hello there\nsecond\n\nother talk\n")
        (d / "dev.de").write_text("hallo da\nzweite\nnur de\nanderer\n")
        assert [p.name for p in mod.original_segmentation_to_xml(
            d / "dev.yaml", d / "dev.en", d / "dev.de", d)] == [
            "dev.en.xml", "dev.de.xml"]
        (d / "translations.txt").write_text(
            "S-1 x\nH-1 -0.5 foo\nD-1 -0.5 zweite zeile\nD-0 -0.3 hallo\n"
            "D-2 -0.9\nD-10 -0.1 zehn\n")
        gen.format_generation_output(d / "translations.txt")
    for name in ("dev.en.xml", "dev.de.xml", "translations_formatted.txt"):
        assert (tmp_path / "port" / name).read_bytes() == (
            tmp_path / "jax" / name).read_bytes(), name

    def conf(cls, model_dir):
        return cls({"st_model_dir": model_dir, "st_ckpt": "c.pt",
                    "cust_seg_yaml": "custom_segments.yaml",
                    "fairseq_root": "/fsq"})

    for model_dir in ("/m/whatever", "/m/joint-s2t-mustc-en-de",
                      "/m/mustc_multilingual_st"):
        for style in ("train", "cli"):
            if style == "cli" and model_dir.endswith("whatever"):
                for mod, cls in ((teval, tconfig.Config),
                                 (jeval, jconfig.Config)):
                    with pytest.raises(ValueError, match="Unknown model"):
                        mod.fairseq_generate_cmd(conf(cls, model_dir),
                                                 tmp_path, style)
                continue
            assert teval.fairseq_generate_cmd(
                conf(tconfig.Config, model_dir), tmp_path, style) == \
                jeval.fairseq_generate_cmd(
                    conf(jconfig.Config, model_dir), tmp_path, style)


@pytest.mark.parametrize("depth", [0, 3, 6])
def test_pdac_tree_equal(depth):
    """pdac_tree's nodes (the soft trims, the empty placeholder nodes),
    update_tree_yaml_content's rows and visualize_tree's text."""
    rows_t, rows_j = [], []
    for seed in range(3):
        probs = _probs(seed, 3000)
        got = talgo.pdac_tree(probs.copy(), 18, 0.2, 0.5, 0.1, depth)
        want = jalgo.pdac_tree(probs.copy(), 18, 0.2, 0.5, 0.1, depth)
        assert _spans(got) == _spans(want) and len(got) >= 1
        assert talgo.visualize_tree(got, 4) == jalgo.visualize_tree(want, 4)
        talgo.update_tree_yaml_content(rows_t, got, f"t{seed}.wav", 18, 0.2)
        jalgo.update_tree_yaml_content(rows_j, want, f"t{seed}.wav", 18, 0.2)
    assert rows_t == rows_j and (depth == 0 or len(rows_t) > 6)


@pytest.mark.parametrize("with_text", [False, True])
def test_prepare_dataset_for_segmentation_equal(tmp_path, with_text):
    """The talks and segments TSVs of a MuST-C style yaml, with and without
    the transcripts' column."""
    import yaml

    from wav2vecsegmenter_tpu.data.prep import (
        prepare_dataset_for_segmentation as jprep)
    from wav2vecsegmenter_tpu_torch.data.prep import (
        prepare_dataset_for_segmentation as tprep)

    wav_dir = tmp_path / "wav"
    wav_dir.mkdir()
    make_speechlike_wav(wav_dir / "a.wav", duration_secs=5.0, seed=1)
    make_speechlike_wav(wav_dir / "b.wav", duration_secs=3.0, seed=2)
    rows = [{"duration": 2.0, "offset": 0.5, "wav": "a.wav"},
            {"duration": 9.0, "offset": 3.0, "wav": "a.wav"},
            {"duration": 1.2, "offset": 0.25, "wav": "b.wav"}]
    with open(tmp_path / "dev.yaml", "w") as f:
        yaml.dump(rows, f)
    (tmp_path / "dev.en").write_text("one two\n three \nfour\n")
    txt = tmp_path / "dev.en" if with_text else None
    got = tprep(tmp_path / "dev.yaml", wav_dir, tmp_path / "port", None, txt)
    want = jprep(tmp_path / "dev.yaml", wav_dir, tmp_path / "jax", None, txt)
    for a, b in zip(got, want):
        assert a.name == b.name
        assert a.read_bytes() == b.read_bytes()


def test_score_functions_equal(tmp_path):
    """sacreBLEU corpus and sentence scores, the parallel reader, and the
    optional scorers' RuntimeError where they are not installed."""
    from wav2vecsegmenter_tpu.stpipe import score as jscore
    from wav2vecsegmenter_tpu_torch.stpipe import score as tscore

    ref, hyp = tmp_path / "ref", tmp_path / "hyp"
    ref.write_text("das ist ein test\nund noch einer hier\nkurz\n")
    hyp.write_text("das ist test\nund noch einer hier\nlang\n")
    assert str(tscore.score_sacrebleu(str(ref), str(hyp))) == str(
        jscore.score_sacrebleu(str(ref), str(hyp)))
    assert tscore.score_sentence_bleu(str(ref), str(hyp),
                                      str(tmp_path / "t")) == \
        jscore.score_sentence_bleu(str(ref), str(hyp), str(tmp_path / "j"))
    assert (tmp_path / "t").read_text() == (tmp_path / "j").read_text()
    assert tscore.get_parallel(ref, hyp) == jscore.get_parallel(ref, hyp)
    import importlib.util

    for mod in (tscore, jscore):
        for package, call in (
                ("bert_score", lambda: mod.score_bertscore(
                    str(ref), str(hyp), "de")),
                ("bleurt", lambda: mod.score_bleurt(str(ref), str(hyp),
                                                    "/x")),
                ("bert_score", lambda: mod.score_sentence_bertscore(
                    str(ref), str(hyp), None, "de"))):
            if importlib.util.find_spec(package) is None:
                with pytest.raises(RuntimeError, match="not installed"):
                    call()


def test_wandblog_equal():
    """The port's ``core/wandblog.py``: the JAX module's functions, text for
    text (the module docstring and logger name are its own)."""
    import inspect

    from wav2vecsegmenter_tpu.core import wandblog as jwandb
    from wav2vecsegmenter_tpu_torch.core import wandblog as twandb

    for name in ("init_wandb", "st_results_tables"):
        assert inspect.getsource(getattr(twandb, name)) == \
            inspect.getsource(getattr(jwandb, name)), name
