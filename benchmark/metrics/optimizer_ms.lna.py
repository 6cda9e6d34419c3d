"""train/step (AccumulatingAdamW): the gradient norm, the accumulation and,
on every k-th micro-step, AdamW, device ms a micro-step: the stream's time
over the program's ``train.grad_norm`` and ``train.optimizer`` spans
(``core.trace``) over the window's micro-steps, so the updates that fell
in the window are shared over its micro-steps.  It reads the stream's
time, not the host's: the host's walk over the leaves (ROADMAP L7) shows
here only where the stream waits for it, not while it queues behind the
positional conv's backward."""

NAMES = ("train.grad_norm", "train.optimizer")


def read(r):
    try:
        from wav2vecsegmenter_tpu_torch.core import trace
        spans = [s for s in trace.spans() if s.name in NAMES]
    except (ImportError, AttributeError):   # a program without the recorder
        return None
    if not spans or not r["units"]:
        return None
    return sum(s.device_seconds for s in spans) / r["units"] * 1e3
