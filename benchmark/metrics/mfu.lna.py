"""The whole micro-step: the model operations of the window's micro-steps
(the forward, and the backward the trained parameters need:
``flops/wav2vec2.train_step_flops``) over the window times the bf16 peak,
989 TFLOP/s."""

PEAK = 989e12


def read(r):
    return r["model_flops"] / (r["window_s"] * PEAK) * 100
