"""The port's spans (``core.trace``) on the CPU at the tiny size: off, the
recorder records nothing and adds no autograd node; on, under
``torch.profiler``, an LNA micro-step records its five parts under
``train.step`` with one micro-step id, each a range of the profiler's
trace; the positional conv's backward span brackets its
``ConvolutionBackward0`` and nothing outside the conv; the attention
backward's span carries its forward call's shape; the store keeps its
spans until ``stop_trace`` and no more than its bound; the reader's spans
come from its threads; a micro-step's numbers are equal bit for bit with the
recorder on and off; and the loop's and the sweep's timing lists fill."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from wav2vecsegmenter_tpu_torch.cli import common as tcommon
from wav2vecsegmenter_tpu_torch.cli import train as tcli
from wav2vecsegmenter_tpu_torch.core import trace
from wav2vecsegmenter_tpu_torch.data.collate import collate, out_len_for
from wav2vecsegmenter_tpu_torch.data.windows import (
    BatchIterator, FixedSegmentationDatasetNoTarget)
from wav2vecsegmenter_tpu_torch.models import wav2vec2 as tw2v
from wav2vecsegmenter_tpu_torch.models.shas import SHAS
from wav2vecsegmenter_tpu_torch.ops.attention import attention_cross
from wav2vecsegmenter_tpu_torch.train import loss as tloss
from wav2vecsegmenter_tpu_torch.train import step as tstep

from .helpers import TINY_W2V, make_speechlike_wav
from .torch_tiny import threads_per_worker  # noqa: F401

# SpecAugment on, so that the positional conv's input takes a gradient
# (through the trained ``masked_spec_embed``), as in the LNA recipe
CFG = dataclasses.replace(TINY_W2V, apply_spec_augment=True,
                          mask_time_length=4)
STEP_PARTS = ("train.upload", "train.forward", "train.backward",
              "train.grad_norm", "train.optimizer")
BCE = {"_target_": "torch.nn.BCEWithLogitsLoss", "tag": "bce",
       "pos_weight": None, "ma_window": None, "reduction": "none"}
PTHR = {"tag": "pthr", "max_segment_length": 18, "min_segment_length": 0.2,
        "threshold": 0.5}


@pytest.fixture(autouse=True)
def empty_store():
    trace.clear()
    yield
    trace.clear()


def profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _model() -> SHAS:
    model = SHAS(wav2vec_keep_layers=2, n_transformer_enc_layers=1,
                 n_transformer_enc_heads=4, init_dropout=0.0,
                 finetune_wav2vec=True, wav2vec_ft_layers=2, w2v_cfg=CFG)
    tw2v.init_from_numpy(model, seed=0)
    return model


def _batch(seed: int = 1):
    """A device-normalize batch of 3 rows: two speech windows with targets
    and a padding row."""
    rng = np.random.RandomState(seed)
    examples = []
    for length in (16000, 11000):
        n_out = out_len_for(length)
        target = np.zeros(n_out, np.float32)
        start = rng.randint(0, n_out // 2)
        target[start:start + n_out // 3] = 1.0
        examples.append(((rng.randn(length) * 0.1).astype(np.float32),
                         target, 0, n_out))
    return collate(examples, 3, 16000, out_len_for(16000),
                   device_normalize=True)


def _step(update_freq: int = 2):
    """(step, model, optimizer) of a tiny LNA micro-step, its dropout and
    SpecAugment drawn from a fixed seed."""
    model = _model()
    params = model.set_requires_grad()
    opt = tstep.AccumulatingAdamW(params, 1e-3, 10, update_freq)
    loss_fn, tag, _ = tloss.build_loss(BCE, 0.3)
    step = tstep.make_train_step(model, loss_fn, 0, opt, torch.float32,
                                 torch.Generator().manual_seed(0), tag)
    return step, model, opt


def _nodes(tensor) -> list[str]:
    """The names of the autograd nodes behind ``tensor``, each once."""
    seen, todo, names = set(), [tensor.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(fn.name())
        todo.extend(f for f, _ in fn.next_functions)
    return names


def _loss(model, batch, generator_seed: int = 0):
    b = tstep.batch_to_device(batch, torch.device("cpu"))
    out = model.train_forward(b["audio"], b["in_lengths"], b["out_mask"],
                              torch.Generator().manual_seed(generator_seed))
    loss_fn, tag, _ = tloss.build_loss(BCE, 0.3)
    return tstep.frame_loss(model, loss_fn, tag, None, b, out, 0.3)[0]


def test_off_records_nothing_and_adds_no_node(monkeypatch):
    model = _model()
    model.set_requires_grad()
    plain = _nodes(_loss(model, _batch()))
    with trace.recording():
        marked = _nodes(_loss(model, _batch()))
    assert sorted(set(marked) - set(plain)) == [
        "_CloseOnBackwardBackward", "_OpenOnBackwardBackward"]
    assert len(marked) == len(plain) + 2
    assert not trace.on()

    def no_span(*args, **kwargs):
        raise AssertionError("a span was allocated with the recorder off")

    monkeypatch.setattr(trace, "Span", no_span)
    step, _, _ = _step()
    step(_batch(), 0.3)
    assert trace.spans() == []
    assert len(_nodes(_loss(model, _batch()))) == len(plain)


@pytest.mark.parametrize("update_freq", [1, 2])
def test_micro_step_spans(update_freq):
    """One micro-step: ``train.step`` and its five parts, one micro-step
    id, each a range of the profiler's trace; the k-th micro-step (here
    the first with update_freq 1) also ``train.optimizer.apply``."""
    step, _, _ = _step(update_freq)
    with profiled() as prof:
        step(_batch(), 0.3)
    spans = trace.spans()
    by_name = {s.name: s for s in spans}
    names = {"train.step", *STEP_PARTS}
    if update_freq == 1:
        names.add("train.optimizer.apply")
        assert by_name["train.optimizer.apply"].parent \
            == by_name["train.optimizer"].id
    assert names <= set(by_name)
    assert ("train.optimizer.apply" in by_name) == (update_freq == 1)
    assert len({s.micro_step for s in spans}) == 1
    for name in STEP_PARTS:
        assert by_name[name].parent == by_name["train.step"].id
    parts = sorted((by_name[n] for n in STEP_PARTS), key=lambda s: s.start)
    assert [s.name for s in parts] == list(STEP_PARTS)
    assert all(a.end <= b.start for a, b in zip(parts, parts[1:]))
    ranges = {e.name for e in prof.events()}
    assert names <= ranges
    # the next micro-step takes the next id
    with profiled():
        step(_batch(2), 0.3)
    ids = sorted({s.micro_step for s in trace.spans()})
    assert len(ids) == 2 and ids[1] == ids[0] + 1


def test_pos_conv_bwd_brackets_the_conv_backward():
    """The span opens when the conv's output gradient arrives and closes
    when its input's leaves: it encloses the profiler's
    ``ConvolutionBackward0``, and autograd runs no node between its two
    markers that is not the positional conv's own."""
    step, model, _ = _step()
    with profiled() as prof:
        step(_batch(), 0.3)
    (pos,) = [s for s in trace.spans() if s.name == "models.pos_conv.bwd"]
    assert pos.thread == "MainThread"      # the CPU's autograd runs here
    events = prof.events()
    (rng,) = [e for e in events if e.name == "models.pos_conv.bwd"]
    conv = [e for e in events if e.name == "ConvolutionBackward0"]
    assert conv and all(rng.time_range.start <= e.time_range.start
                        and e.time_range.end <= rng.time_range.end
                        for e in conv)
    prefix = "autograd::engine::evaluate_function: "
    order = [e.name[len(prefix):] for e in sorted(
        (e for e in events if e.name.startswith(prefix)),
        key=lambda e: e.time_range.start)]
    i = order.index("_OpenOnBackwardBackward")
    j = order.index("_CloseOnBackwardBackward")
    # the conv's own graph, built alone on a leaf input
    enc = model.wav2vec_model.model.encoder
    x = torch.randn(2, 9, CFG.hidden_size, requires_grad=True)
    own = set(_nodes(tw2v._positional_conv(x, enc.pos_conv_embed, CFG,
                                           torch.float32)))
    between = order[i + 1:j]
    assert "ConvolutionBackward0" in between
    assert set(between) <= own, set(between) - own


@pytest.mark.parametrize("kind", ["self", "cross"])
def test_attention_bwd_span_carries_the_call(kind):
    """The forward call's shape and valid key counts ride on the backward's
    span: the encoder's packed calls and the head's in a micro-step, and a
    cross-attention call of other query and key lengths."""
    if kind == "self":
        step, _, _ = _step()
        batch = _batch()
        with profiled():
            step(batch, 0.3)
        spans = [s for s in trace.spans() if s.name == "ops.attention.bwd"]
        assert len(spans) == CFG.num_layers + 1
        b = batch.audio.shape[0]
        enc = [s.attrs for s in spans if s.attrs["heads"] == CFG.num_heads
               and s.attrs["d"] == CFG.hidden_size // CFG.num_heads]
        assert len(enc) >= CFG.num_layers
        for a in (s.attrs for s in spans):
            assert a["b"] == b and a["t_q"] == a["t_k"]
            valid = a["key_mask"].sum(1).tolist()
            assert len(valid) == b and max(valid) <= a["t_k"]
            assert valid[-1] == 0          # the padding row
        return
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 5, 2, 16, generator=g, requires_grad=True)
    kv = torch.randn(2, 7, 2, 2, 16, generator=g, requires_grad=True)
    mask = torch.tensor([[True] * 7, [True] * 4 + [False] * 3])
    with profiled() as prof:
        attention_cross(q, kv, mask).square().sum().backward()
    (s,) = trace.spans()
    assert s.name == "ops.attention.bwd"
    assert {k: v for k, v in s.attrs.items() if k != "key_mask"} == {
        "b": 2, "t_q": 5, "t_k": 7, "heads": 2, "d": 16}
    assert s.attrs["key_mask"] is mask     # held, not reduced
    assert s.attrs["key_mask"].sum(1).tolist() == [7, 4]
    assert "ops.attention.bwd" in {e.name for e in prof.events()}


@pytest.mark.parametrize("end", ["stop_trace", "overflow"])
def test_store_is_bounded_and_emptied(tmp_path, monkeypatch, end):
    """``spans()`` reads without taking out; ``stop_trace`` empties the
    store, and between them it keeps only the newest ``STORE_SPANS``."""
    monkeypatch.setattr(trace, "_store",
                        trace.collections.deque(maxlen=3))
    prof = trace.start_trace(tmp_path)
    for i in range(5 if end == "overflow" else 2):
        with trace.span(f"s{i}"):
            pass
    names = [s.name for s in trace.spans()]
    assert names == [s.name for s in trace.spans()]     # still there
    if end == "overflow":
        assert names == ["s2", "s3", "s4"]
        trace.stop_trace(prof)
        return
    assert names == ["s0", "s1"]
    trace.stop_trace(prof)
    assert trace.spans() == [] and not trace.on()
    assert list(tmp_path.glob("*.pt.trace.json"))


def test_reader_spans(tmp_path):
    """``data.read`` from the reader's producer thread, one a batch, in
    ``read_seconds``; ``data.wait`` in the consumer, one a take from the
    queue (the batches and the end), in ``wait_seconds``."""
    wav = tmp_path / "a.wav"
    make_speechlike_wav(wav, duration_secs=47.3, seed=0)
    ds = FixedSegmentationDatasetNoTarget(wav, 20.0, 2)
    ds.fixed_length_segmentation(0)
    loader = BatchIterator(ds, 1, 20.0)
    with profiled():
        batches = list(loader)
    spans = trace.spans()
    reads = [s for s in spans if s.name == "data.read"]
    waits = [s for s in spans if s.name == "data.wait"]
    assert len(reads) == len(batches) == len(loader) > 1
    assert {s.thread for s in reads} == {"batch-producer"}
    assert {s.thread for s in waits} == {"MainThread"}
    assert len(waits) == len(batches) + 1
    assert loader.read_seconds == [s.seconds for s in reads]
    assert loader.wait_seconds == [s.seconds for s in waits]


def test_numbers_equal_with_the_recorder_on_and_off():
    """Three micro-steps (an update on the second) from one seed: losses,
    grad norms, gradients and parameters bitwise equal."""
    def run(record: bool):
        step, model, _ = _step(update_freq=2)
        out = []
        with trace.recording() if record else trace.OFF:
            for i in range(3):
                m = step(_batch(i), 0.3)
                out.append((m["loss"], m["grad_norm"], m["grads"]))
        return out, [p.detach().clone() for p in model.parameters()]

    (off, p_off), (on, p_on) = run(False), run(True)
    assert not trace.on()
    assert {s.name for s in trace.spans()} >= {"models.pos_conv.bwd",
                                               "ops.attention.bwd",
                                               *STEP_PARTS}
    for (l0, g0, gr0), (l1, g1, gr1) in zip(off, on):
        assert torch.equal(l0, l1) and torch.equal(g0, g1)
        assert all(torch.equal(a, b) for a, b in zip(gr0, gr1))
    assert all(torch.equal(a, b) for a, b in zip(p_off, p_on))


def _corpus(root):
    """Two talks with true segments, in the data prep's TSV layout (an
    index column first)."""
    talks, segs = ["\tid\tpath\ttotal_frames"], ["\ttalk_id\tstart\tend"]
    for i, secs in enumerate((9.3, 6.1)):
        path = root / f"ted_{i}.wav"
        make_speechlike_wav(path, duration_secs=secs, seed=i)
        talks.append(f"{i}\tted_{i}\t{path}\t{int(secs * 16000)}")
        for j, s0 in enumerate(np.arange(0.2, secs - 1.0, 2.7)):
            segs.append(f"{len(segs) - 1}\tted_{i}\t{int(s0 * 16000)}\t"
                        f"{int(min(s0 + 2.1, secs) * 16000)}")
    (root / "talks.tsv").write_text("\n".join(talks) + "\n")
    (root / "segments.tsv").write_text("\n".join(segs) + "\n")
    return str(root / "talks.tsv"), str(root / "segments.tsv")


def test_history_and_read_seconds_fill(tmp_path, monkeypatch):
    """The trainer's history keeps a fetch, read and step time a
    micro-step, from the reader's spans, and its profiled micro-steps'
    trace carries the program's spans; ``segment_wavs(read_seconds=)``
    keeps a read time a batch."""
    talks, segments = _corpus(tmp_path)
    w2v = tmp_path / "w2v"
    w2v.mkdir()
    (w2v / "config.json").write_text(
        '{"hidden_size": 64, "num_hidden_layers": 2, '
        '"num_attention_heads": 1, "intermediate_size": 128}')
    monkeypatch.chdir(tmp_path)
    out = tcli.main([
        "exp_name=run", "batch_size=2", "segment_length=2", "max_epochs=1",
        "update_freq=2", "print_every_steps=1",
        f"task.model.wav2vec_model_name={w2v}",
        "task.model.n_transformer_enc_heads=1",
        "task.model.finetune_wav2vec=true", "task.model.wav2vec_ft_layers=1",
        f"data.train.talk_list={talks}",
        f"data.train.segments_list={segments}",
        f"data.eval.talk_list={talks}",
        f"data.eval.segments_list={segments}",
        "runtime.profile_steps=2", "+runtime.device=cpu"])
    hist = out["history"]
    n = len(hist["loss"])
    assert n == sum(out["steps_per_epoch"]) > 2
    for key in ("step_seconds", "fetch_seconds", "read_seconds"):
        assert len(hist[key]) == n and all(s >= 0 for s in hist[key]), key
    assert all(f <= s for f, s in zip(hist["fetch_seconds"],
                                      hist["step_seconds"]))
    (trace_file,) = (tmp_path / "run" / "profile").glob("*.pt.trace.json")
    text = trace_file.read_text()
    for name in ("data.wait", *STEP_PARTS):
        assert f'"{name}"' in text, name

    model = _model().eval()
    reads: list = []
    rows = tcommon.segment_wavs(model, [tmp_path / "ted_0.wav"], PTHR, 2,
                                2.0, 1, torch.device("cpu"), torch.float32,
                                read_seconds=reads)
    ds = FixedSegmentationDatasetNoTarget(tmp_path / "ted_0.wav", 2.0, 1)
    ds.fixed_length_segmentation(0)
    assert rows and len(reads) == len(BatchIterator(ds, 2, 2.0)) > 1
    assert all(s >= 0 for s in reads)
