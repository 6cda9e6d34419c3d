"""train/step -> models/: the forward and the loss, device ms a micro-step:
the stream's time over the program's ``train.forward`` spans
(``core.trace``: from the stream reaching the span's start to the end of
the work it enqueued, idle stretches inside it included) over the
window's micro-steps."""


def read(r):
    try:
        from wav2vecsegmenter_tpu_torch.core import trace
        spans = [s for s in trace.spans() if s.name == "train.forward"]
    except (ImportError, AttributeError):   # a program without the recorder
        return None
    if not spans or not r["units"]:
        return None
    return sum(s.device_seconds for s in spans) / r["units"] * 1e3
