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
