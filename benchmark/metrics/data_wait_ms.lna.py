"""data/ (the training loader): ms a micro-step waits for its batch, the
host time of the program's ``data.wait`` spans (``core.trace``: around the
consumer's take from the reader's queue) over the window's micro-steps."""


def read(r):
    try:
        from wav2vecsegmenter_tpu_torch.core import trace
        spans = [s for s in trace.spans() if s.name == "data.wait"]
    except (ImportError, AttributeError):   # a program without the recorder
        return None
    if not spans or not r["units"]:
        return None
    return sum(s.seconds for s in spans) / r["units"] * 1e3
