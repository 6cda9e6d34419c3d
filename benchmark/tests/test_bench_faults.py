"""The timed path broken underneath, a run driven as the command drives
it (the look for a card skipped): ``correct`` comes out false, once for
each fault a cell can have.  The exchange between chips does not arise:
every cell runs on one chip."""

from __future__ import annotations

import torch

import test_bench_dryrun as dry


def test_train_state_unchanged(tiny_bench, monkeypatch):
    """A step that returns its state unchanged: the optimizer applies
    nothing."""
    from wav2vecsegmenter_tpu_torch.train import step

    def unchanged(self):
        for acc in self._acc:
            acc.zero_()
        self.updates += 1
        self.mini_step = 0

    monkeypatch.setattr(step.AccumulatingAdamW, "_apply", unchanged)
    line = dry.tiny_run(tiny_bench, "tiny.lna")
    assert not line["correct"], line["checks"]


def test_train_half_batch(tiny_bench, monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from wav2vecsegmenter_tpu_torch.train import step

    orig = step.compute_bce_loss

    def half(logits, target, out_mask, loss_fn, ma):
        h = max(1, logits.shape[0] // 2)
        return orig(logits[:h], target[:h], out_mask[:h], loss_fn, ma)

    monkeypatch.setattr(step, "compute_bce_loss", half)
    line = dry.tiny_run(tiny_bench, "tiny.lna")
    assert not line["correct"], line["checks"]


class _ReversedGrad(torch.autograd.Function):
    """The identity, whose backward returns its gradient reversed along
    the last axis: of the right size, in the wrong order."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.flip(-1)


def test_wrong_attention_backward_shows_in_grad_dir_gap(tiny_bench,
                                                        monkeypatch):
    """A wrong backward of the encoder's attention (K10's place): the
    gradient of its packed projections reversed.  The losses of the first
    update do not see it; the printed gradient direction gap does, by
    orders of magnitude over a sound run's (it is not compared: on the
    card a sound seed's nearly cancelling bias gradient reads above the
    control)."""
    from wav2vecsegmenter_tpu_torch.models import wav2vec2

    sound = dry.tiny_run(tiny_bench, "tiny.lna")
    orig = wav2vec2.attention_packed
    monkeypatch.setattr(wav2vec2, "attention_packed",
                        lambda proj, *args, **kwargs: orig(
                            _ReversedGrad.apply(proj), *args, **kwargs))
    line = dry.tiny_run(tiny_bench, "tiny.lna")
    assert line["checks"]["loss_gap"]["value"] < 1e-5
    assert line["info"]["grad_dir_gap"] > 0.5
    assert line["info"]["grad_dir_gap"] > 1000 * sound["info"]["grad_dir_gap"]


def test_control_runs_and_reads_higher(tiny_bench):
    """The control path at a tiny size: the reference in fp8 in the
    program's place, reading further from the float32 reference than the
    program.  Whether it fails the limits is read at the cell's own size
    (test_bench_card.py)."""
    sound = dry.tiny_run(tiny_bench, "tiny.lna")
    control = dry.tiny_run(tiny_bench, "tiny.lna", control=True)
    assert control["checks"]["loss_gap"]["value"] \
        > 100 * sound["checks"]["loss_gap"]["value"]
    torch.manual_seed(0)
