"""models/wav2vec2's positional conv (cuDNN): its backward, device ms a
micro-step: the stream's time over the program's ``models.pos_conv.bwd``
spans (``core.trace``: opened on the autograd thread when the conv's
output gradient arrives, closed when its input gradient leaves, so the
GELU's, the bias's, the conv's and the weight norm's gradients) over the
window's micro-steps."""


def read(r):
    try:
        from wav2vecsegmenter_tpu_torch.core import trace
        spans = [s for s in trace.spans() if s.name == "models.pos_conv.bwd"]
    except (ImportError, AttributeError):   # a program without the recorder
        return None
    if not spans or not r["units"]:
        return None
    return sum(s.device_seconds for s in spans) / r["units"] * 1e3
