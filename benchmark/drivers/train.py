"""Driver of a training run's micro-steps: the micro-step that
``train.loop.train`` runs, built by the functions it calls
(``cli.common.build_model``, ``train.loop.train_generator``,
``train.loss.build_loss``, ``train.step.AccumulatingAdamW`` and
``make_train_step``), fed by the random loader over the traffic's corpus,
and ending as the loop's does, in the loss, the gradient norm and the
frame logits on the host.  Evaluations and checkpoints are left out.

Set-up builds the step once and drives it through its first
``check.updates`` optimizer updates of ``update_freq`` micro-steps each,
which also warms up every shape; the window continues the same step on
the same loader, and ends with the first micro-step that finishes after
its ``seconds``.

Correct: the first update against the float32 reference
(``reference.train``), which works the epoch's batches out again from the
corpus and the loader's seed and draws the same dropout masks: each
micro-step's loss and frame logits, and the median trained leaf's change
after the update.  Printed beside them: each trained leaf's gradient of
the first micro-step by the norm of its difference from the reference's
(direction as well as size; the worst leaf's name on standard error), and
the norm of the first update's gradient as the optimizer got it (from
AdamW's first moment).  The limits file says which numbers decide.  The compared micro-steps
are set-up's: the same step object and loader that the window then
drives, through the window's own call.  With ``control`` the reference
computed in float8 stands in the program's place.
"""

from __future__ import annotations

import gc
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

from benchlib import corpus, hooks, model as bmodel, trace as btrace
from benchlib.checks import Checks, diff_gaps, leaf_gaps
from reference import train as rtrain

BETA1 = 0.9


def run(ctx) -> dict:
    from wav2vecsegmenter_tpu_torch.config import Config
    from wav2vecsegmenter_tpu_torch.train.loop import train_generator
    from wav2vecsegmenter_tpu_torch.train.loss import build_loss
    from wav2vecsegmenter_tpu_torch.train.step import (AccumulatingAdamW,
                                                       make_train_step)

    tr, cfg = ctx.traffic, ctx.config
    s_weights, s_talks, s_loader, s_dropout = corpus.sub_seeds(ctx.seed, 4)
    model, dtype, sd = bmodel.build(cfg, s_weights, ctx.device)
    device = next(model.parameters()).device
    params = model.set_requires_grad()
    names = [n for n, _ in model.named_parameters() if model._trains(n)]
    ctx.phase("model")
    tmp = tempfile.TemporaryDirectory()
    talks = corpus.write_talks(Path(tmp.name), tr, s_talks, device)
    talk_list, seg_list = corpus.write_lists(Path(tmp.name), talks,
                                             tr["listed"])
    config = Config({"task": Config({"train_generator": {
        "_target_": "lib.dataset.RandomDataloaderGenerator"}}),
        "data": Config({"train": {"talk_list": talk_list,
                                  "segments_list": seg_list,
                                  "segment_length": tr["segment_length"]}})})
    gen = train_generator(config, tr["batch_size"], s_loader,
                          pin_memory=device.type == "cuda")
    ctx.phase("corpus")
    loader = gen.generate()
    ctx.phase("loader")
    k, updates = tr["update_freq"], tr["check"]["updates"]
    total = int(tr["max_epochs"] * len(loader) / k * 1.01)
    optimizer = AccumulatingAdamW(params, tr["learning_rate"], total, k)
    generator = torch.Generator(device=device).manual_seed(s_dropout)
    loss_fn, tag, _ = build_loss(cfg["loss"],
                                 gen.dataset.pos_class_percentage)
    step = make_train_step(model, loss_fn, 0, optimizer, dtype, generator,
                           tag)
    spans = btrace.Spans(annotate=bool(ctx.trace))
    batches = iter(loader)

    def micro_step():
        with spans.span("fetch"):
            batch = next(batches)
        with spans.span("train_step"):
            metrics = step(batch, loss_fn.pos_weight)
        with spans.span("loss_to_host"):
            loss = float(metrics["loss"])       # waits for the device
            float(metrics["grad_norm"])
        mask = torch.from_numpy(batch.out_mask)
        return loss, torch.where(mask, metrics["logits"].float().cpu(),
                                 0.0), metrics["grads"]

    ctx.phase("step built")
    losses, grad_norms, logits = [], {}, []
    for u in range(updates):
        for j in range(k):
            loss, lg, grads = micro_step()
            losses.append(loss)
            if u == 0:
                logits.append(lg)
            if u == 0 and j == 0:   # kept on the host for the comparison
                step1 = {n: g.float().cpu() for n, g in zip(names, grads)}
        if u == 0:
            # the gradient the optimizer got (none where it stepped none)
            state = optimizer.adamw.state
            grad_norms = rtrain.norms({
                n: state[p]["exp_avg"] / (1 - BETA1) if "exp_avg" in state[p]
                else torch.zeros_like(p) for n, p in zip(names, params)})
    del grads
    change = rtrain.norms({n: p.detach() - sd[n]
                           for n, p in zip(names, params)})
    spans.seconds.clear()

    calls = hooks.OpCalls(ctx.family)
    prof = None
    with _traced(ctx, calls) as prof:
        t0 = time.perf_counter()
        ctx.window_started(t0)
        end, n = t0 + ctx.window_seconds, 0
        while True:
            micro_step()
            n += 1
            t1 = time.perf_counter()
            if t1 >= end:
                break
    window_s = t1 - t0
    out = {"attempted": n,
           "e2e": {tr["end_to_end"]: window_s / n * 1e3},
           "memory_peak": ctx.memory_peak()}
    if ctx.trace:
        intervals = btrace.device_intervals(prof)
        busy_s = btrace.busy_ms(intervals) / 1e3
        flops = ctx.family.train_step_flops(
            tr["batch_size"], int(tr["segment_length"] * 16000), cfg) * n
        out.update(busy_s=busy_s, window_s=window_s,
                   breakdown=btrace.breakdown(prof, intervals),
                   readings={"spans": spans.seconds, "busy_s": busy_s, "window_s": window_s,
                             "units": n, "bounds_ms": calls.bound_ms(),
                             "kernels_ms": btrace.device_kernels_ms(prof),
                             "model_flops": flops})
        del prof

    # correctness: the program's state freed, the reference in float32
    batches.close()
    del step, optimizer, model, params
    gc.collect()
    ctx.phase("reference")
    epoch = rtrain.Epoch(talks, tr["listed"], tr["segment_length"],
                         tr["batch_size"], s_loader)
    args = (sd, cfg, epoch, updates, k, tr["learning_rate"],
            tr["max_epochs"], s_dropout, device)
    with ctx.float32():
        ref = rtrain.run(*args)
        if ctx.control:
            got = rtrain.run(*args, quant=True)
            losses, step1, grad_norms, change, logits = (
                got["losses"], got["step_grads"], got["grad_norms"],
                got["change_norms"], got["logits"])
        diff1 = rtrain.norms({n: step1[n].to(device) - g
                              for n, g in ref["step_grads"].items()})
    ctx.phase("reference done")
    med = statistics.median(ref["grad_norms"].values())
    moving = {n for n, g in ref["grad_norms"].items() if g >= 1e-3 * med}
    loss = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    grad = leaf_gaps(grad_norms, ref["grad_norms"])
    direction = diff_gaps(diff1, rtrain.norms(ref["step_grads"]), moving)
    change = leaf_gaps(change, ref["change_norms"], moving)
    checks = Checks(ctx.limits)
    diff = torch.stack(logits) - torch.stack(ref["logits"])
    checks.add("loss_gap", max(loss[:k]))
    checks.add("logit_rel_gap", float(diff.square().mean().sqrt()
                                      / torch.stack(ref["logits"]).square()
                                      .mean().sqrt()))
    checks.add("change_gap", statistics.median(change))
    worst = max(direction, key=direction.get)
    print(f"worst gradient leaf: {worst} {direction[worst]!r}",
          file=sys.stderr)
    checks.add("grad_dir_gap", direction[worst])
    checks.info.update(grad_dir_gap_median=statistics.median(
                           direction.values()),
                       grad_gap=statistics.median(grad),
                       grad_gap_worst=max(grad),
                       change_gap_worst=max(change))
    tmp.cleanup()
    out.update(checks=checks, failed=len(checks.failed()))
    return out


def _traced(ctx, calls):
    """The window's profiler and op-call records in a traced run."""
    import contextlib

    @contextlib.contextmanager
    def block():
        if not ctx.trace:
            yield None
            return
        with calls.record(), torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            yield prof

    return block()
