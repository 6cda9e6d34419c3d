"""Smoke run of the PyTorch port (wav2vecsegmenter_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases, each printed on its own line; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds the kernels of wav2vecsegmenter_tpu_torch/ops/csrc
   (one process per source file, in parallel); the line carries ptxas's
   registers and spills of every kernel (the bf16 conv and LayerNorm
   kernels must show none: checked after the kernel phase);
3. kernels: each hand kernel against its plain PyTorch version on the card,
   at the shapes the segmentation and training paths give it, float32
   (TF32 off) and bf16, with ragged lengths; times from CUDA events,
   beside the kernel's bound (the larger of its bytes over 3.35 TB/s and
   its operations over the peak rate of their type) and, where one PyTorch
   call computes the same function, that call's time (for the attention backward: the SDPA call's forward +
   backward less its forward); each output is held to the tolerances of
   its own dtype.  The bf16 attention backward rows first run the forward
   under grad, whose softmax statistics are held against their plain
   version, and add the forward's time with and without them and the
   profiler's device time of each of K10's three kernels; the FFN rows
   (the full batch, the tail bucket and the remainder ladder's 1, 2 and 4
   windows) add the cuBLAS chain linear -> GELU -> linear as a reference
   time and the device time of the two GEMM launches; the conv rows
   (layers 0-6 of a batch) run twice, bitwise, are timed three times (the
   median on record) and add the cuDNN chain conv1d -> layer_norm -> gelu
   as a reference time and the device time of the conv kernels; the
   LayerNorm rows (K1 at h = 1024 and 512, the tail bucket's rows and a
   width with a masked tail; K2 at conv layers 0, 1 and 6's outputs) run
   twice, bitwise, are timed three times (K1 in turns with F.layer_norm)
   and add the profiler's device time of the kernel and, for K1, of
   F.layer_norm and both calls' host time a call; the LayerNorm backward
   (K9: h = 1024 and, last, A4's 512, the masked-tail width and the
   variant without dx) runs twice, bitwise, is timed three times against
   its library call, in turns, and adds the profiler's device time of each
   of its kernels and of the library call;
4. slice: a full-width SHAS (xls-r-300m geometry, 15 encoder layers, SFC
   1 x 8 heads, seeded random weights, output layer x40) segments two
   synthetic talks through cli.common.segment_wavs at batch 14 in bf16 with
   pTHR, in the default configuration (fused conv layers and FFN): once
   through the kernels (launch counters reset just before), once eager
   (counters must not move), once in float32; then once in the JAX
   package's A/B configuration W2VSEG_CONVFUSE=0 W2VSEG_FFNFUSE=0 through
   the kernels (counters reset just before; the path of the conv epilogue
   kernel).  The kernels' bf16 probabilities must be as close to the
   float32 ones as the eager path's (within KERNEL_SLACK), the kernels and
   eager no further apart than bf16 is from float32, the two
   configurations within BF16_PAIR of their distance to float32, six
   conv_bias_ln_gelu launches (layers 1-6) to each conv_audio_ln_gelu,
   34 layer_norm launches a batch in both configurations and 7
   bias_layer_norm_gelu launches a batch in the unfused one;
5. batch: one full batch of 14 x 20 s windows timed in both configurations
   with the kernels, and eager, in turns (``--profile`` adds torch.profiler
   tables of one batch in each configuration on standard error);
6. train: the same full-width SHAS trains its SFC head on a frozen backbone
   through the port's loop (``train.loop.train``) on a synthetic corpus
   written to a temporary directory, batch 14, 20 s windows,
   update_freq=2, two epochs of three micro-steps (a full accumulation and
   an epoch-end flush each): bf16 through the kernels (launch counters
   reset just before; the path of the backward kernels K9 and K10, and
   K9 without dx on the head's first LayerNorm, whose input is the frozen
   backbone's), bf16
   eager (counters must not move), float32 through the kernels and
   float32 eager, from the same weights and generator seed.  Checked:
   finite losses, the backbone bitwise unchanged, the head moved, the
   kernels' bf16 first-micro-step head gradients as close to the float32
   ones as the eager bf16 gradients (within KERNEL_SLACK), and the
   float32 kernels and eager gradients within F32_GRAD (``--profile``
   adds a fifth run, bf16 with the kernels, and a torch.profiler table of
   its second micro-step on standard error);
7. a JSON line of every kernel (launches on the path that runs it, error,
   times, bound), the nvidia-smi line, and the last line:
   {"ok": true, "device": {...}}.

The kernel phase runs each backward kernel twice on the same inputs: the
outputs must be bitwise equal (no atomics).  The attention rows (bf16 on
the tensor-core kernels, float32 on the scalar ones) include a batch row
whose keys are all masked, compared in full: its outputs must also be the
uniform average of its in-range values.

Needs CUDA; exits non-zero without it.  Imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from wav2vecsegmenter_tpu_torch.cli.common import segment_wavs
from wav2vecsegmenter_tpu_torch.models.shas import SHAS
from wav2vecsegmenter_tpu_torch.models.wav2vec2 import init_from_numpy
from wav2vecsegmenter_tpu_torch.ops import _build, backend
from wav2vecsegmenter_tpu_torch.ops import attention as attn
from wav2vecsegmenter_tpu_torch.ops import convfuse as conv
from wav2vecsegmenter_tpu_torch.ops import ffn as tffn
from wav2vecsegmenter_tpu_torch.ops import layernorm as ln
from wav2vecsegmenter_tpu_torch.ops.timing import (cuda_ms, device_ms,
                                                    device_busy_ms, host_us)

B = 14              # conf/segment.yaml batch_size
T, T_TAIL = 999, 1099   # frames of a 20 s window and of the 22 s tail bucket
L_AUDIO = 320000    # samples of a 20 s window
F32_ATOL = 1e-4     # float32, TF32 off: summation order only
BF16_ATOL = 2 ** -5  # one bf16 step at |y| in [4, 8): independent roundings
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): memory, bf16 tensor
# cores, float32 outside the tensor cores (the scalar kernels' arithmetic)
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bf16_tc": 989e12, "f32": 67e12}
# scalar operations an element of a LayerNorm (mean, variance, normalise,
# scale, bias), of its backward (the statistics again, x-hat, g*scale, the
# two row means, dx, the two column sums) and of a GELU (erf counted as
# one) take
LN_OPS, LN_BWD_OPS, GELU_OPS = 8, 14, 4
# the backward kernels' sums (over ~14k rows for dscale/dbias, ~1k keys or
# queries for dq/dk/dv) run in other orders than the plain versions':
# relative slack on top of the absolute tolerances, by the output's dtype
# (a bf16 output: one bf16 step of the value, where the float32 sum rounds
# to either side; dscale and dbias are float32 in both arms)
BWD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
# the bf16 forward's softmax statistics under grad, (m, l) of a query row,
# against their plain version: float32 sums of the same terms in another
# order (m is up to a few tens in log2 units; l a sum of up to T terms)
STATS_ATOL, STATS_RTOL = 1e-4, 1e-4
# float32 train arm: the kernels' and the eager path's first-micro-step
# head gradients, relative L2 distance
F32_GRAD = 1e-4
# conf/algorithm/pthr.yaml
PTHR = {"tag": "pthr", "max_segment_length": 28, "min_segment_length": 0.2,
        "max_lerp_range": 4, "min_lerp_range": 0.4, "threshold": 0.1,
        "moving_average_window": 0.1}
# The bf16 envelope the JAX package measured on a TPU against float32
# (PARITY.md: mean 2.7e-3, p99 0.055).  Reported, not asserted: PyTorch
# rounds to bf16 after every op where XLA rounds once per fusion, and two
# bf16 runs that differ only in summation order part to the bf16 noise
# floor through 15 layers.  Asserted instead: the kernels add no error to
# the bf16 path (their distance to the float32 run is within KERNEL_SLACK of
# the plain path's), and the kernels and the plain path, which round at the
# same points, differ by no more than bf16 differs from float32.
JAX_ENVELOPE = {"mean": 3e-3, "p99": 0.055}
KERNEL_SLACK = 1.25
# Two bf16 paths that round at different points each sit at about the
# bf16-vs-float32 distance d from the float32 run, with independent noise,
# so about sqrt(2) d from each other: the bound between the default and the
# unfused configuration.
BF16_PAIR = 2 ** 0.5
# the JAX package's A/B arm (the unfused configuration): conv layers as
# GEMMs + the bias -> LayerNorm -> GELU kernel, the FFN as GEMMs around a
# GELU
UNFUSED = {"W2VSEG_CONVFUSE": "0", "W2VSEG_FFNFUSE": "0"}

CSRC = "wav2vecsegmenter_tpu_torch/ops/csrc/"
SOURCES = {  # kernel: (source, the TPU kernel it replaces)
    "layer_norm": (CSRC + "layernorm.cu",
                   "wav2vecsegmenter_tpu/ops/layernorm.py:34"),
    "bias_layer_norm_gelu": (CSRC + "layernorm.cu",
                             "wav2vecsegmenter_tpu/ops/layernorm.py:195"),
    "attention_packed": (CSRC + "attention.cu",
                         "wav2vecsegmenter_tpu/ops/attention.py:327"),
    "attention_bthd": (CSRC + "attention.cu",
                       "wav2vecsegmenter_tpu/ops/attention.py:89"),
    "ffn": (CSRC + "ffn.cu", "wav2vecsegmenter_tpu/ops/ffn.py:73"),
    "conv_bias_ln_gelu": (CSRC + "convfuse.cu",
                          "wav2vecsegmenter_tpu/ops/convfuse.py:127 "
                          "(and :100, :161)"),
    "conv_audio_ln_gelu": (CSRC + "convfuse.cu",
                           "wav2vecsegmenter_tpu/ops/convfuse.py:161"),
    "layer_norm_bwd": (CSRC + "layernorm_bwd.cu",
                       "wav2vecsegmenter_tpu/ops/layernorm.py:42"),
    "attention_bwd": (CSRC + "attention_bwd.cu",
                      "wav2vecsegmenter_tpu/ops/attention.py:111"),
}
# kernels of the default configuration's path; bias_layer_norm_gelu runs on
# the A/B arm's
DEFAULT_PATH = ("layer_norm", "attention_packed", "attention_bthd", "ffn",
                "conv_bias_ln_gelu", "conv_audio_ln_gelu")
UNFUSED_PATH = ("layer_norm", "attention_packed", "attention_bthd",
                "bias_layer_norm_gelu")
# the trainer's path: the default configuration's forward kernels and the
# head's backward kernels
TRAIN_PATH = DEFAULT_PATH + ("layer_norm_bwd", "attention_bwd")
# conv layers 2-5 of a 14 x 20 s batch (t_in, k, s); layers 1 and 6 have
# rows of their own, as has the raw-audio layer 0
CONV_MIDDLE = ((31999, 3, 2), (15999, 3, 2), (7999, 3, 2), (3999, 2, 2))
# the conv kernels by name (bf16: wgmma + TMA, tensor-core taps; float32:
# the scalar oracle kernels), for the profiler's device times and the
# build phase's spill check
CONV_KERNELS = ("conv_wg_kernel", "conv_audio_tc_kernel",
                "conv_ln_gelu_kernel", "conv_audio_kernel")
# the LayerNorm kernels by name (bf16: the vector kernel; float32: the
# simple oracle kernel) and F.layer_norm's, for the profiler's device times
# (the bf16 kernel also for the spill check)
LN_KERNELS = ("ln_vec_kernel", "ln_rows_kernel")
LIB_LN_KERNELS = ("layer_norm_kernel",)
# K9's kernels (bf16: the vector kernel, also for the spill check; float32:
# the simple oracle kernel; both: the cross-block pass), for the profiler's
# device times; the library call's device time sums every kernel it runs
LN_BWD_KERNELS = ("ln_bwd_vec_kernel", "ln_bwd_rows_kernel",
                  "ln_bwd_reduce_kernel")
# a K1 row width with a masked tail: not a multiple of 8, a partial pass
LN_TAIL_H = 1020
# LayerNorm launches a batch: the feature projection, two in each of the 15
# encoder layers and three in the SFC head; the unfused arm's conv epilogue
# runs once a conv layer.  The slice segments its two talks in two batches.
LN_PER_BATCH, CONV_LAYERS, SLICE_BATCHES = 34, 7, 2


def phase(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


@contextlib.contextmanager
def env(values: dict):
    """Set environment variables for the block (the port reads its
    configuration flags at call time)."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def ragged_mask(t: int, g: torch.Generator, dev) -> torch.Tensor:
    """[B, t] key mask: one row at t, one at about t/2, one at 1 frame, the
    rest random."""
    lengths = torch.randint(1, t + 1, (B,), generator=g)
    lengths[:3] = torch.tensor([t, t // 2, 1])
    return (torch.arange(t)[None, :] < lengths[:, None]).to(dev)


def bound(nbytes: float, *ops: tuple[str, float]) -> tuple[float, str]:
    """(ms, 'bytes' or 'operations'): the least time the card could take,
    the larger of the bytes over the memory rate and the operations, given
    as (rate, count) pairs, over the peak rate of their type (summed)."""
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    ops_ms = sum(n / PEAK_OPS[kind] for kind, n in ops) * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def _kernel_name(mangled: str) -> str:
    """A kernel's name and the start of its template arguments from its
    mangled name in an anonymous namespace (_ZN<n><namespace><n><name>...),
    e.g. "attn_bwd_dq_tc_kernel ILi64EE"."""
    import re

    m = re.match(r"_ZN(\d+)", mangled)
    if m is None:
        return mangled[:48]
    rest = mangled[m.end() + int(m.group(1)):]
    m = re.match(r"(\d+)", rest)
    if m is None:
        return mangled[:48]
    n = int(m.group(1))
    name = rest[m.end():m.end() + n]
    return f"{name} {rest[m.end() + n:][:64]}"


def ptxas_report(log: str) -> dict:
    """nvcc's -Xptxas=-v log -> {kernel: "N registers, spills S/L bytes"}
    (ptxas prints a kernel's spills before its registers)."""
    import re

    report, name, spills = {}, None, "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spills = _kernel_name(m.group(1)), "?"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            report[name] = f"{m.group(1)} registers, spills {spills} bytes"
            name = None
    return report


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def as_tuple(out) -> tuple:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def check_kernels(dev) -> dict:
    g = torch.Generator(device="cpu").manual_seed(0)
    gd = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=gd, device=dev) * std
                + mean).to(dtype)

    def tc(dtype):  # the product's rate: tensor cores in bf16
        return "bf16_tc" if dtype == torch.bfloat16 else "f32"

    def ln_case(h, rows, gelu, dtype):
        x = randn(rows, h, std=2.0, mean=0.5, dtype=dtype)
        scale, bias = randn(h, std=0.1, mean=1.0), randn(h, std=0.1)
        moved = nbytes(x, x, scale, bias)
        # every LayerNorm row twice (bitwise), three timings (the median on
        # record), and the profiler's device time of the kernel; for K1
        # also F.layer_norm's, and both calls' host time a call (a short
        # kernel's events time is its host path's where that is longer)
        iters = 3 if rows > B * 32000 else 50
        if gelu:
            cb = randn(h, std=0.3)
            args = (x, cb, scale, bias)
            fn = lambda: ln.bias_layer_norm_gelu(*args)  # noqa: E731
            return dict(fn=fn,
                        plain=lambda: ln.bias_layer_norm_gelu_plain(*args),
                        bound=bound(moved + nbytes(cb), (
                            "f32", rows * h * (1 + LN_OPS + GELU_OPS))),
                        library=None, twice=True, repeats=3, iters=iters,
                        extra=lambda: {"device_ms": device_ms(fn, iters,
                                                              LN_KERNELS)})
        lib_scale, lib_bias = scale.to(dtype), bias.to(dtype)
        fn = lambda: ln.layer_norm(x, scale, bias)  # noqa: E731

        def library():
            return F.layer_norm(x, (h,), lib_scale, lib_bias, ln.EPS)

        return dict(fn=fn,
                    plain=lambda: ln.layer_norm_plain(x, scale, bias),
                    bound=bound(moved, ("f32", rows * h * LN_OPS)),
                    library=library, twice=True, repeats=3, iters=iters,
                    extra=lambda: {
                        "device_ms": device_ms(fn, iters, LN_KERNELS),
                        "library_device_ms": device_ms(library, iters,
                                                       LIB_LN_KERNELS),
                        "host_us": host_us(fn, iters),
                        "library_host_us": host_us(library, iters)})

    def pairs(mask):
        # (query, key) pairs per head that need the products: the valid
        # keys of every query row, and a batch-padding row's in-range keys
        # (its output averages them: PV, and no QK, is needed there)
        t = mask.shape[1]
        valid = float(t * mask.sum().double())
        return valid, float(t * t * int((~mask.any(1)).sum()))

    def attn_bound(q, mask, heads, d, dtype):
        # QK and PV (2 * D FLOP a pair each) over the pairs that need them
        valid, empty = pairs(mask)
        flops = heads * d * (4 * valid + 2 * empty)
        return bound(4 * nbytes(q), (tc(dtype), flops))

    def sdpa(q, k, v, mask):  # [B, T, H, D] views -> the library call
        m = mask[:, None, None, :]
        return lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=m)

    def uniform_row(v, heads, d):
        # the batch-padding row 3 (every key masked) must average its
        # in-range values with equal weights: its error against that mean
        want = v[3].float().mean(0)
        return lambda out: float((out.view(B, -1, heads, d)[3].float()
                                  - want).abs().max())

    def packed_case(t, dtype):
        proj = randn(B, t, 3 * 1024, dtype=dtype)
        mask = ragged_mask(t, g, dev)
        mask[3] = False  # a batch-padding row: every key masked
        q, k, v = attn._unpack_qkv(proj, 16)
        return dict(fn=lambda: attn.attention_packed(proj, mask, 16),
                    plain=lambda: attn.attention_packed_plain(
                        proj, mask, 16, 64 ** -0.5),
                    uniform=uniform_row(v, 16, 64),
                    bound=attn_bound(q, mask, 16, 64, dtype),
                    library=sdpa(q, k, v, mask))

    def bthd_case(t, dtype):
        qkv = randn(B, t, 3, 8, 128, dtype=dtype)  # the SFC's view layout
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        mask = ragged_mask(t, g, dev)
        mask[3] = False
        return dict(fn=lambda: attn.attention_bthd(q, k, v, mask),
                    plain=lambda: attn.attention_bthd_plain(
                        q, k, v, mask, 128 ** -0.5),
                    uniform=uniform_row(v, 8, 128),
                    bound=attn_bound(q, mask, 8, 128, dtype),
                    library=sdpa(q, k, v, mask))

    def ln_bwd_case(h, rows, dtype, need_dx=True):
        x = randn(rows, h, std=2.0, mean=0.5, dtype=dtype)
        gr = randn(rows, h, dtype=dtype)
        scale = randn(h, std=0.1, mean=1.0)
        lib_w = scale.to(dtype)
        lib_b = torch.zeros(h, device=dev, dtype=dtype)
        _, mean, rstd = torch.ops.aten.native_layer_norm(x, [h], lib_w, lib_b,
                                                         ln.EPS)
        # x and g read, dx written (where asked), scale read, dscale and
        # dbias written
        moved = nbytes(x, gr, scale) + 2 * h * 4 + (nbytes(x) if need_dx
                                                    else 0)
        # without dx the wrapper returns None in its place: held here, the
        # rows compare dscale and dbias
        # (the rows with dx pass no flag, so that this script also times
        # an earlier checkout's kernel on the same inputs)
        kw = {} if need_dx else {"need_dx": False}
        check(need_dx or ln.layer_norm_bwd(x, scale, gr, **kw)[0] is None,
              "layer_norm_bwd wrote a dx it was not asked for")
        keep = slice(0 if need_dx else 1, None)
        fn = lambda: ln.layer_norm_bwd(x, scale, gr, **kw)[keep]  # noqa: E731

        def library():
            return torch.ops.aten.native_layer_norm_backward(
                gr, x, [h], mean, rstd, lib_w, lib_b, [need_dx, True, True])

        # K9 sits within a few percent of its library call: 50 launches a
        # timing, three timings of each in turns, the spread reported
        return dict(fn=fn,
                    plain=lambda: ln.layer_norm_bwd_plain(x, scale, gr,
                                                          **kw)[keep],
                    bound=bound(moved, ("f32", rows * h * LN_BWD_OPS)),
                    library=library, rtol=BWD_RTOL, twice=True, iters=50,
                    repeats=3,
                    extra=lambda: {
                        "device_ms": device_ms(fn, 50, LN_BWD_KERNELS),
                        "device_ms_total": device_ms(fn, 50, ("",))[""],
                        # the second kernel's launch overlaps the first's
                        # tail: the call's time on the device, overlap once
                        "device_busy_ms": device_busy_ms(fn, 50),
                        "library_device_ms": device_ms(library, 50,
                                                       ("",))[""],
                        "host_us": host_us(fn, 50),
                        "library_host_us": host_us(library, 50)})

    def attn_bwd_case(t, heads, d, dtype):
        qkv = randn(B, t, 3, heads, d, dtype=dtype)  # the head's gradient
        q, k, v = qkv.unbind(2)
        do = randn(B, t, heads, d, dtype=dtype)
        mask = ragged_mask(t, g, dev)
        mask[3] = False  # a batch-padding row: every key masked
        scale = d ** -0.5
        # S = QK^T, dV = P^T dO, dP = dO V^T, dQ = dS K, dK = dS^T Q over
        # the valid keys of every query row; all but S over the padding
        # row's keys (its P is uniform)
        valid, empty = pairs(mask)
        flops = heads * d * (10 * valid + 8 * empty)
        # the SDPA call's backward: forward + backward less the forward
        leaves = [a.transpose(1, 2).detach().requires_grad_()
                  for a in (q, k, v)]
        do_t = do.transpose(1, 2)

        def lib_fwd():
            return F.scaled_dot_product_attention(
                *leaves, attn_mask=mask[:, None, None, :])

        case = dict(plain=lambda: attn.attention_bwd_plain(q, k, v, mask,
                                                           do, scale),
                    # the TPU kernel's function: q, k, v and do in, dq, dk
                    # and dv out (the bf16 kernels' extra reads of the
                    # forward's output and statistics are not counted)
                    bound=bound(7 * nbytes(q), (tc(dtype), flops)),
                    library=lambda: torch.autograd.grad(lib_fwd(), leaves,
                                                        do_t),
                    library_less=lib_fwd, rtol=BWD_RTOL, twice=True)
        if dtype != torch.bfloat16:  # the scalar kernels recompute it all
            case.update(fn=lambda: attn.attention_bwd(q, k, v, mask, do,
                                                      scale))
            return case
        # bf16: the forward under grad writes the statistics the backward
        # reads, once, outside the timed region; they are held against
        # their plain version, and the forward with them is timed against
        # the inference forward
        o, stats = attn._attention_bthd(q, k, v, mask, scale,
                                        with_stats=True)
        want = attn.attention_stats_plain(q, k, mask, scale)
        stats_err = (stats - want).abs()
        check(bool((stats_err <= STATS_ATOL + STATS_RTOL * want.abs()).all()),
              f"attention statistics [{B},{t},{heads},{d}]: max abs err "
              f"{stats_err.max().item()}")

        case.update(
            fn=lambda: attn.attention_bwd(q, k, v, mask, do, scale, o, stats),
            extra=lambda: {
                "stats_max_abs_err": stats_err.max().item(),
                "fwd_ms": cuda_ms(lambda: attn.attention_bthd(q, k, v, mask,
                                                              scale), 10),
                "fwd_stats_ms": cuda_ms(lambda: attn._attention_bthd(
                    q, k, v, mask, scale, with_stats=True), 10),
                "device_ms": device_ms(
                    lambda: attn.attention_bwd(q, k, v, mask, do, scale, o,
                                               stats), 10,
                    ("attn_bwd_rows_kernel", "attn_bwd_dq_tc_kernel",
                     "attn_bwd_dkdv_tc_kernel"))})
        return case

    def ffn_case(t, dtype, windows=B):
        x = randn(windows, t, 1024, dtype=dtype)
        w1, b1 = randn(4096, 1024, std=0.03), randn(4096, std=0.1)
        w2, b2 = randn(1024, 4096, std=0.015), randn(1024, std=0.1)
        rows = windows * t
        moved = 2 * nbytes(x) + (w1.numel() + w2.numel()) * x.element_size() \
            + nbytes(b1, b2)
        args = (x, w1, b1, w2, b2)
        # a reference point, not the library column: the cuBLAS chain of
        # three calls in x's type
        lw1, lb1, lw2, lb2 = (a.to(dtype) for a in (w1, b1, w2, b2))

        def chain():
            return F.linear(F.gelu(F.linear(x, lw1, lb1)), lw2, lb2)

        return dict(fn=lambda: tffn.ffn(*args),
                    plain=lambda: tffn.ffn_plain(*args),
                    bound=bound(moved, (tc(dtype), 4 * rows * 1024 * 4096),
                                ("f32", rows * 4096 * (1 + GELU_OPS))),
                    library=None,
                    extra=lambda: {"cublas_chain_ms": cuda_ms(chain, 10),
                                   "device_ms": device_ms(
                                       lambda: tffn.ffn(*args), 10,
                                       ("ffn_wg_kernel", "ffn_gemm_kernel"))})

    def conv_case(t, c, k, s, dtype):
        x = randn(B, t, c, dtype=dtype)
        w = randn(512, c, k, std=(c * k) ** -0.5)
        cb, scale, bias = (randn(512, std=0.3), randn(512, std=0.1, mean=1.0),
                           randn(512, std=0.1))
        args = (x, w, cb, scale, bias, s)
        rows = B * ((t - k) // s + 1)
        moved = nbytes(x) + rows * 512 * x.element_size() \
            + w.numel() * x.element_size() + nbytes(cb, scale, bias)
        product = 2 * rows * k * c * 512
        epilogue = rows * 512 * (1 + LN_OPS + GELU_OPS)
        # a reference point, not the library column: the cuDNN chain of
        # three calls in x's type, conv1d on the channels-first view ->
        # layer_norm -> gelu
        lw, lcb, lsc, lbi = (a.to(dtype) for a in (w, cb, scale, bias))

        def chain():
            y = F.conv1d(x.transpose(1, 2), lw, lcb, stride=s)
            return F.gelu(F.layer_norm(y.transpose(1, 2), (512,), lsc, lbi,
                                       ln.EPS))

        # every conv row twice (bitwise), three timings (the median on
        # record), and the profiler's device time of the conv kernels
        return dict(fn=lambda: conv.conv_bias_ln_gelu(*args),
                    plain=lambda: conv.conv_bias_ln_gelu_plain(*args),
                    bound=bound(moved, (tc(dtype), product),
                                ("f32", epilogue)),
                    library=None, twice=True, repeats=3,
                    extra=lambda: {"cudnn_chain_ms": cuda_ms(chain, 3),
                                   "device_ms": device_ms(
                                       lambda: conv.conv_bias_ln_gelu(*args),
                                       3, CONV_KERNELS)})

    cases = []  # (kernel, label, dtype, case)
    for dtype in (torch.float32, torch.bfloat16):
        for h in (1024, 512):
            cases.append(("layer_norm", f"[{B}*{T},{h}]", dtype,
                          lambda h=h, d=dtype: ln_case(h, B * T, False, d)))
        for t in (63999, T):
            cases.append(("bias_layer_norm_gelu", f"[{B},{t},512]", dtype,
                          lambda t=t, d=dtype: ln_case(512, B * t, True, d)))
        for t in (T, T_TAIL):
            cases.append(("attention_packed", f"[{B},{t},3072]x16", dtype,
                          lambda t=t, d=dtype: packed_case(t, d)))
        for t in (T, T_TAIL):
            cases.append(("attention_bthd", f"[{B},{t},8,128]", dtype,
                          lambda t=t, d=dtype: bthd_case(t, d)))
        for t in (T, T_TAIL):
            cases.append(("ffn", f"[{B},{t},1024]x4096", dtype,
                          lambda t=t, d=dtype: ffn_case(t, d)))
        # conv layer 1 (k=3, s=2) and layer 6 (k=2, s=2); layer 0's raw audio
        for t, k, s in ((63999, 3, 2), (1999, 2, 2)):
            cases.append(("conv_bias_ln_gelu", f"[{B},{t},512] k={k} s={s}",
                          dtype,
                          lambda t=t, k=k, s=s, d=dtype: conv_case(
                              t, 512, k, s, d)))
        cases.append(("conv_audio_ln_gelu", f"[{B},{L_AUDIO}] k=10 s=5", dtype,
                      lambda d=dtype: conv_case(L_AUDIO, 1, 10, 5, d)))
        cases.append(("layer_norm_bwd", f"[{B}*{T},1024]", dtype,
                      lambda d=dtype: ln_bwd_case(1024, B * T, d)))
        for heads, d in ((8, 128), (16, 64)):
            cases.append(("attention_bwd", f"[{B},{T},{heads},{d}]", dtype,
                          lambda h=heads, dd=d, dt=dtype: attn_bwd_case(
                              T, h, dd, dt)))
    # the remainder ladder's 1, 2 and 4 windows, last, so that the rows
    # above draw the same inputs from the shared stream as in earlier runs
    for dtype in (torch.float32, torch.bfloat16):
        for w in (1, 2, 4):
            cases.append(("ffn", f"[{w},{T},1024]x4096", dtype,
                          lambda d=dtype, w=w: ffn_case(T, d, w)))
    # conv layers 2-5, after every earlier row for the same reason
    for dtype in (torch.float32, torch.bfloat16):
        for t, k, s in CONV_MIDDLE:
            cases.append(("conv_bias_ln_gelu", f"[{B},{t},512] k={k} s={s}",
                          dtype,
                          lambda t=t, k=k, s=s, d=dtype: conv_case(
                              t, 512, k, s, d)))
    # K1 at the tail bucket's ragged row count and at a width with a
    # masked tail (not a multiple of 8: element-wise loads and stores), K2
    # at conv layer 1's output (the unfused arm), after every earlier row
    # for the same reason
    for dtype in (torch.float32, torch.bfloat16):
        for rows, h in ((B * T_TAIL, 1024), (B * T, LN_TAIL_H)):
            cases.append(("layer_norm", f"[{B}*{rows // B},{h}]", dtype,
                          lambda h=h, r=rows, d=dtype: ln_case(h, r, False,
                                                               d)))
        cases.append(("bias_layer_norm_gelu", f"[{B},31999,512]", dtype,
                      lambda d=dtype: ln_case(512, B * 31999, True, d)))
    # K9 at A4's feature-projection width and at a width with a masked
    # tail, then without dx (the head's first LayerNorm in training), after
    # every earlier row for the same reason
    for h, need_dx in ((512, True), (LN_TAIL_H, True), (1024, False)):
        for dtype in (torch.float32, torch.bfloat16):
            cases.append(("layer_norm_bwd",
                          f"[{B}*{T},{h}]" + ("" if need_dx else " no dx"),
                          dtype, lambda h=h, d=dtype, n=need_dx: ln_bwd_case(
                              h, B * T, d, n)))

    results: dict = {}
    for name, label, dtype, make in cases:
        case = make()
        got, ref = as_tuple(case["fn"]()), as_tuple(case["plain"]())
        again = as_tuple(case["fn"]()) if case.get("twice") else None
        torch.cuda.synchronize()
        # each output is held to the limits of its own dtype: K9's dscale
        # and dbias are float32 column sums whatever x's dtype
        tols = {torch.float32: F32_ATOL, torch.bfloat16: BF16_ATOL}
        rtols = case.get("rtol", {})
        err, ok, limits = 0.0, True, []
        for a, b in zip(got, ref):
            check(torch.isfinite(a).all().item(), f"{name} {label}: non-finite")
            tol, rtol = tols[a.dtype], rtols.get(a.dtype, 0.0)
            limits.append((tol, rtol))
            diff = (a.float() - b.float()).abs()
            lim = tol + rtol * b.float().abs()
            err = max(err, diff.max().item())
            ok = ok and bool((diff <= lim).all())
        if case.get("uniform") is not None:
            uniform_err = case["uniform"](got[0])
            err = max(err, uniform_err)
            ok = ok and uniform_err <= tols[got[0].dtype]
        deterministic = (None if again is None else
                         all(torch.equal(a, b) for a, b in zip(got, again)))
        del got, ref, again
        big = "63999" in label or str(L_AUDIO) in label
        iters = case.get("iters", 3 if big else 10)

        def library():
            if case["library"] is None:
                return None
            ms_ = cuda_ms(case["library"], iters)
            if case.get("library_less") is not None:
                ms_ -= cuda_ms(case["library_less"], iters)
            return ms_

        # with repeats, the kernel and its library call in turns; the
        # median of each goes on record, every timing into the phase line
        runs = {"ms": [], "library_ms": []}
        for r in range(case.get("repeats", 1)):
            for key in (("ms", "library_ms") if r % 2 == 0
                        else ("library_ms", "ms")):
                runs[key].append(cuda_ms(case["fn"], iters) if key == "ms"
                                 else library())
        ms = float(np.median(runs["ms"]))
        library_ms = (None if runs["library_ms"][0] is None
                      else float(np.median(runs["library_ms"])))
        plain_ms = cuda_ms(case["plain"], iters)
        extra = case["extra"]() if case.get("extra") is not None else {}
        if case.get("repeats", 1) > 1:
            extra.update(ms_repeats=runs["ms"],
                         library_ms_repeats=runs["library_ms"])
        bound_ms, bound_by = case["bound"]
        dname = str(dtype).replace("torch.", "")
        phase("kernel", name=name, shape=label, dtype=dname, max_abs_err=err,
              limits=limits, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
              bound_by=bound_by, library_ms=library_ms,
              deterministic=deterministic, iters=iters, **extra)
        check(ok, f"{name} {label} {dname}: max abs err {err} beyond "
                  f"the (atol, rtol) limits {limits}")
        check(deterministic is not False,
              f"{name} {label} {dname}: two runs differ")
        del case
        torch.cuda.empty_cache()
        # the record keeps the main path's dtype (bf16) at its first shape
        if dtype == torch.bfloat16 and name not in results:
            results[name] = {"max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by, "library_ms": library_ms}
    return results


def write_talk(path: Path, secs: float, seed: int) -> None:
    """Speech-like audio: amplitude-modulated noise with a pause every 3.5 s
    and slowly varying loudness, 16 kHz 16-bit mono."""
    rng = np.random.RandomState(seed)
    n = int(secs * 16000)
    t = np.arange(n) / 16000
    x = rng.randn(n) * 0.1 * ((t % 3.5) < 3.0)
    x *= 0.6 + 0.4 * np.sin(2 * np.pi * t / 7.3 + seed)
    pcm = np.clip(x * 32768.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(pcm.tobytes())


def run_slice(dev) -> tuple[dict, dict, SHAS]:
    model = SHAS(device=dev)  # conf/task/shas.yaml: xls-r-300m, 15 layers
    init_from_numpy(model, seed=0)
    with torch.no_grad():
        model.seg_model.output_layer.weight.mul_(40.0)
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    cfg = model.w2v_cfg
    check(cfg.hidden_size == 1024 and cfg.num_layers == 15
          and cfg.num_heads == 16 and cfg.ffn_dim == 4096, "not full width")

    with tempfile.TemporaryDirectory() as tmp:
        secs = {"talk1.wav": 65.0, "talk2.wav": 41.0}
        wavs = [Path(tmp) / name for name in secs]
        for seed, w in enumerate(wavs):
            write_talk(w, secs[w.name], seed)
        audio_secs = sum(secs.values())

        def run(mode: str, dtype=torch.bfloat16, flags: dict | None = None):
            backend.set_kernels(mode)
            before = backend.launch_counts()
            probs: dict = {}
            with env(flags or {}):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rows = segment_wavs(model, wavs, PTHR, B, 20.0, 1, dev, dtype,
                                    talk_probs=probs)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            backend.set_kernels("auto")
            if mode == "eager":
                check(backend.launch_counts() == before,
                      "the eager run launched kernels")
            return rows, probs, wall

        # warm-up: cuBLAS/cuDNN handles, pinned memory, kernels
        run("auto")
        run("auto", flags=UNFUSED)
        run("eager")
        backend.reset_launch_counts()
        rows_k, probs_k, wall = run("auto")
        counts = backend.launch_counts()
        walls = {"auto": [wall], "eager": [], "unfused": []}
        rows_e, probs_e, wall = run("eager")
        walls["eager"].append(wall)
        backend.reset_launch_counts()
        rows_u, probs_u, wall = run("auto", flags=UNFUSED)
        counts_unfused = backend.launch_counts()
        walls["unfused"].append(wall)
        for mode in ("eager", "unfused", "auto", "auto", "unfused", "eager"):
            walls[mode].append(
                run("auto", flags=UNFUSED)[2] if mode == "unfused"
                else run(mode)[2])
        _, probs_f32, _ = run("auto", torch.float32)  # the float32 oracle

    for name in DEFAULT_PATH:
        check(counts.get(name, 0) > 0,
              f"kernel {name} never launched on the default path")
    # six conv layers on conv_bias_ln_gelu for each raw-audio layer 0
    check(counts["conv_bias_ln_gelu"] == 6 * counts["conv_audio_ln_gelu"],
          f"conv launches {counts['conv_bias_ln_gelu']} / "
          f"{counts['conv_audio_ln_gelu']}, not six layers to one")
    for name in UNFUSED_PATH:
        check(counts_unfused.get(name, 0) > 0,
              f"kernel {name} never launched on the unfused path")
    check(counts["layer_norm"] == LN_PER_BATCH * SLICE_BATCHES
          and counts_unfused["layer_norm"] == LN_PER_BATCH * SLICE_BATCHES,
          f"layer_norm launches {counts['layer_norm']} / "
          f"{counts_unfused['layer_norm']}, not {LN_PER_BATCH} a batch")
    check(counts_unfused["bias_layer_norm_gelu"]
          == CONV_LAYERS * SLICE_BATCHES,
          f"bias_layer_norm_gelu launches "
          f"{counts_unfused['bias_layer_norm_gelu']}, not {CONV_LAYERS} a "
          f"batch")
    for rows in (rows_k, rows_e, rows_u):
        check({r["wav"] for r in rows} == {w.name for w in wavs},
              "a talk got no segments")
    names = list(secs)
    for probs in (probs_k, probs_e, probs_u, probs_f32):
        for name in names:
            p = probs[name]
            # one frame per 1/49.95 s, the output frame rate
            check(p.shape == (round(secs[name] * 49.95),), "probs shape")
            check(bool(np.isfinite(p).all()), "non-finite probs")

    def dprob(a, b):
        d = np.concatenate([np.abs(a[n] - b[n]) for n in names])
        return {"mean": float(d.mean()), "p99": float(np.percentile(d, 99)),
                "max": float(d.max()), "frames": int(d.size)}

    k_vs_e = dprob(probs_k, probs_e)
    k_vs_f = dprob(probs_k, probs_f32)
    e_vs_f = dprob(probs_e, probs_f32)
    u_vs_k = dprob(probs_u, probs_k)
    u_vs_f = dprob(probs_u, probs_f32)
    med = {m: float(np.median(w)) for m, w in walls.items()}
    phase("slice", params=n_params, segments_kernels=len(rows_k),
          segments_eager=len(rows_e), segments_unfused=len(rows_u),
          prob_range=[float(min(p.min() for p in probs_k.values())),
                      float(max(p.max() for p in probs_k.values()))],
          dprob_kernels_vs_eager=k_vs_e, dprob_kernels_vs_f32=k_vs_f,
          dprob_eager_vs_f32=e_vs_f, dprob_unfused_vs_kernels=u_vs_k,
          dprob_unfused_vs_f32=u_vs_f,
          jax_envelope_met=all(k_vs_e[q] <= JAX_ENVELOPE[q]
                               for q in JAX_ENVELOPE),
          audio_secs=audio_secs, wall_secs_kernels=walls["auto"],
          wall_secs_eager=walls["eager"], wall_secs_unfused=walls["unfused"],
          audio_per_wall_kernels=audio_secs / med["auto"],
          audio_per_wall_eager=audio_secs / med["eager"],
          audio_per_wall_unfused=audio_secs / med["unfused"],
          launches=counts, launches_unfused=counts_unfused)
    for q in ("mean", "p99"):
        check(k_vs_f[q] <= KERNEL_SLACK * e_vs_f[q],
              f"kernels add error: {q} dprob to float32 {k_vs_f[q]} vs "
              f"{e_vs_f[q]} on the plain path")
        check(k_vs_e[q] <= e_vs_f[q],
              f"kernel vs eager {q} dprob {k_vs_e[q]} exceeds the bf16 "
              f"envelope {e_vs_f[q]}")
        pair = BF16_PAIR * max(k_vs_f[q], u_vs_f[q])
        check(u_vs_k[q] <= pair,
              f"unfused vs default {q} dprob {u_vs_k[q]} exceeds the bf16 "
              f"envelope of two bf16 paths {pair}")
    return counts, counts_unfused, model


def time_batch(dev, model, profile: bool) -> None:
    """One full batch (14 windows of 20 s) through the engine: the default
    configuration with the kernels, the unfused one with the kernels, and
    eager, in turns; with ``profile``, a torch.profiler table of one batch
    in each configuration goes to standard error."""
    from wav2vecsegmenter_tpu_torch.data.windows import BatchIterator
    from wav2vecsegmenter_tpu_torch.infer.pipeline import WindowInference

    rng = np.random.RandomState(2)
    env_ = (np.arange(L_AUDIO) / 16000 % 3.5) < 3.0
    examples = [((rng.randn(L_AUDIO) * 0.1 * env_).astype(np.float32), None,
                 0, 999) for _ in range(B)]
    batch, = BatchIterator(examples, B, 20.0)  # a list serves as dataset
    engine = WindowInference(model, dev, torch.bfloat16)

    def once(arm):
        backend.set_kernels("eager" if arm == "eager" else "auto")
        with env(UNFUSED if arm == "unfused" else {}):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.run_batch(batch).numpy()
            ms = (time.perf_counter() - t0) * 1e3
        backend.set_kernels("auto")
        return ms

    ms = {"auto": [], "unfused": [], "eager": []}
    for arm in ms:
        once(arm)
    torch.cuda.reset_peak_memory_stats()
    for arm in ("auto", "unfused", "eager", "eager", "unfused", "auto",
                "auto", "unfused", "eager"):
        ms[arm].append(once(arm))
    med = {arm: float(np.median(v)) for arm, v in ms.items()}
    phase("batch", windows=B, audio_secs=B * 20.0, ms_kernels=ms["auto"],
          ms_unfused_kernels=ms["unfused"], ms_eager=ms["eager"],
          audio_per_wall_kernels=B * 20.0 / (med["auto"] / 1e3),
          audio_per_wall_unfused=B * 20.0 / (med["unfused"] / 1e3),
          audio_per_wall_eager=B * 20.0 / (med["eager"] / 1e3),
          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof

        for arm in ("auto", "unfused"):
            with prof(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as p:
                once(arm)
            print(f"batch profile, {arm} arm", file=sys.stderr)
            print(p.key_averages().table(sort_by="cuda_time_total",
                                         row_limit=40),
                  file=sys.stderr, flush=True)


# conf/task/shas.yaml: the frozen-backbone task the trainer runs
SHAS_TASK = {
    "autoregression": False,
    "model": {"wav2vec_model_name": "facebook/wav2vec2-xls-r-300m",
              "wav2vec_keep_layers": 15, "finetune_wav2vec": False,
              "wav2vec_ft_layers": 99, "finetune_w2v_feat_enc": False,
              "finetune_w2v_ffn": False, "ffn_adapter": True,
              "n_transformer_enc_layers": 1, "n_transformer_enc_heads": 8,
              "init_dropout": 0.1},
    "train_generator": {},
    "eval_generator": {"inference_times": 1},
    "loss": {"_target_": "torch.nn.BCEWithLogitsLoss", "tag": "bce",
             "pos_weight": None, "ma_window": None, "reduction": "none"},
}
# six 100 s talks: 36 random 20 s windows an epoch, three micro-steps of 14
TRAIN_TALKS, TRAIN_SECS, TRAIN_WINDOW = 6, 100.0, 20


def write_corpus(root: Path) -> tuple[str, str]:
    """Synthetic talks and their true segments (the speech bursts of
    write_talk), as the data prep writes the TSVs (an index column)."""
    talks = ["\tid\tpath\ttotal_frames"]
    segments = ["\ttalk_id\tstart\tend"]
    for i in range(TRAIN_TALKS):
        path = root / f"talk{i}.wav"
        write_talk(path, TRAIN_SECS, seed=10 + i)
        talks.append(f"{i}\ttalk{i}\t{path}\t{int(TRAIN_SECS * 16000)}")
        for s0 in np.arange(0.0, TRAIN_SECS, 3.5):
            end = min(s0 + 3.0, TRAIN_SECS)
            segments.append(f"{len(segments) - 1}\ttalk{i}\t"
                            f"{int(s0 * 16000)}\t{int(end * 16000)}")
    (root / "talks.tsv").write_text("\n".join(talks) + "\n")
    (root / "segments.tsv").write_text("\n".join(segments) + "\n")
    return str(root / "talks.tsv"), str(root / "segments.tsv")


def run_train(dev, profile: bool) -> dict:
    """The train phase; returns the launch counts of the kernels' bf16
    run.  With ``profile``, one more bf16 run with the kernels prints a
    torch.profiler table of its second micro-step (steady state, with an
    optimizer update) on standard error."""
    from wav2vecsegmenter_tpu_torch.cli.common import build_model
    from wav2vecsegmenter_tpu_torch.config import Config, merge
    from wav2vecsegmenter_tpu_torch.train.loop import train

    def grad_dist(a, b) -> float:
        num = sum((x - y).square().sum() for x, y in zip(a, b))
        den = sum(y.square().sum() for y in b)
        return float(torch.sqrt(num / den))

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        talks, segments = write_corpus(Path(tmp))
        split = {"talk_list": talks, "segments_list": segments,
                 "segment_length": TRAIN_WINDOW}

        def run(mode: str, dtype: str, on_step_extra=None):
            config = merge(Config(), {
                "exp_name": f"{mode}_{dtype}", "batch_size": B,
                "learning_rate": 2.5e-4, "max_epochs": 2, "update_freq": 2,
                "segment_length": TRAIN_WINDOW, "print_every_steps": 100,
                "save_ckpts": False, "task": SHAS_TASK,
                "data": {"train": split, "eval": split},
                "runtime": {"device": dev.type, "compute_dtype": dtype,
                            "kernels": mode, "seed": 0}})
            first: list = []

            def on_step(metrics):
                if not first:
                    first.extend(g.detach().float().clone()
                                 for g in metrics["grads"])
                if on_step_extra is not None:
                    on_step_extra()

            before = backend.launch_counts()
            out = train(config, work_dir=tmp, on_step=on_step)
            backend.set_kernels("auto")
            if mode == "eager":
                check(backend.launch_counts() == before,
                      "the eager train run launched kernels")
            check(bool(np.isfinite(out["history"]["loss"]).all()),
                  f"non-finite train loss ({mode}, {dtype})")
            check(out["steps_per_epoch"] == [3, 3] and out["updates"] == 4,
                  f"not two epochs of a full accumulation and a flush: "
                  f"{out['steps_per_epoch']}, {out['updates']} updates")
            return out, first

        backend.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        out_k, grads_k = run("auto", "bfloat16")
        counts = backend.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        model = out_k.pop("model")
        fresh = build_model(SHAS_TASK["model"], dev)
        init_from_numpy(fresh, seed=0)
        for key, value in fresh.wav2vec_model.state_dict().items():
            check(torch.equal(value, model.wav2vec_model.state_dict()[key]),
                  f"the frozen backbone moved: {key}")
        head = model.seg_model.state_dict()
        moved = max(float((value - head[key]).abs().max())
                    for key, value in fresh.seg_model.state_dict().items())
        check(moved > 0, "the head did not move")
        del model, fresh, head
        out_e, grads_e = run("eager", "bfloat16")
        out_e.pop("model")
        out_f, grads_f = run("auto", "float32")
        out_f.pop("model")
        out_fe, grads_fe = run("eager", "float32")
        out_fe.pop("model")
        torch.cuda.empty_cache()
        if profile:
            from torch.profiler import ProfilerActivity, schedule
            from torch.profiler import profile as prof

            def table(p):  # deep enough to list K9's two kernels
                print(p.key_averages().table(sort_by="cuda_time_total",
                                             row_limit=60),
                      file=sys.stderr, flush=True)

            # steps end at on_step: the first micro-step warms up, the
            # second is recorded
            with prof(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA],
                      schedule=schedule(wait=0, warmup=1, active=1,
                                        repeat=1),
                      on_trace_ready=table) as p:
                run("auto", "bfloat16", on_step_extra=p.step)[0].pop("model")
            torch.cuda.empty_cache()

    for name in TRAIN_PATH:
        check(counts.get(name, 0) > 0,
              f"kernel {name} never launched on the train path")
    # one K10 launch a micro-step (the head's one attention), and K5 15
    # times a forward of the 15-layer backbone (micro-steps and eval)
    micro_steps = len(out_k["history"]["loss"])
    check(counts["attention_bwd"] == micro_steps,
          f"attention_bwd launched {counts['attention_bwd']} times in "
          f"{micro_steps} micro-steps")
    check(counts["ffn"] % 15 == 0,
          f"ffn launched {counts['ffn']} times, not 15 a forward")
    # K9 three times a micro-step (the head's norm1, norm2 and final
    # LayerNorm), norm1's without dx: its input is the frozen backbone's
    check(counts["layer_norm_bwd"] == 3 * micro_steps
          and counts["layer_norm_bwd_no_dx"] == micro_steps,
          f"layer_norm_bwd launched {counts['layer_norm_bwd']} times, "
          f"{counts['layer_norm_bwd_no_dx']} without dx, in {micro_steps} "
          f"micro-steps")
    k_vs_f, e_vs_f = grad_dist(grads_k, grads_f), grad_dist(grads_e, grads_f)
    f32_k_vs_e = grad_dist(grads_f, grads_fe)

    def ms(out, key="step_seconds"):
        # median over the micro-steps after the first (the warm-up)
        return float(np.median(out["history"][key][1:]) * 1e3)

    phase("train", seconds=time.perf_counter() - t0,
          micro_steps=len(out_k["history"]["loss"]),
          updates=out_k["updates"], loss_kernels=out_k["history"]["loss"],
          loss_eager=out_e["history"]["loss"],
          loss_f32=out_f["history"]["loss"],
          grad_norm_kernels=out_k["history"]["grad_norm"],
          ms_per_micro_step_kernels=ms(out_k),
          ms_per_micro_step_eager=ms(out_e),
          ms_per_micro_step_f32=ms(out_f),
          ms_per_micro_step_f32_eager=ms(out_fe),
          fetch_ms_per_micro_step_kernels=ms(out_k, "fetch_seconds"),
          step_ms_kernels=[t * 1e3 for t in out_k["history"]["step_seconds"]],
          eval_kernels=out_k["eval"], eval_eager=out_e["eval"],
          eval_f32=out_f["eval"], peak_mem_gb=peak_gb,
          grad_dist_kernels_vs_f32=k_vs_f, grad_dist_eager_vs_f32=e_vs_f,
          grad_dist_f32_kernels_vs_eager=f32_k_vs_e, head_moved=moved,
          layer_norm_bwd_launches=counts["layer_norm_bwd"],
          layer_norm_bwd_no_dx=counts["layer_norm_bwd_no_dx"],
          launches=counts)
    check(k_vs_f <= KERNEL_SLACK * e_vs_f,
          f"kernels add error to the head gradients: {k_vs_f} from float32 "
          f"vs {e_vs_f} on the plain path")
    check(f32_k_vs_e <= F32_GRAD,
          f"float32 kernels vs eager head gradients {f32_k_vs_e} > {F32_GRAD}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _build.library()
    ptxas = ptxas_report(_build.build_log)
    phase("build", seconds=time.perf_counter() - t0,
          nvcc_seconds=_build.build_seconds, ptxas=ptxas)

    kernels = check_kernels(dev)
    # the bf16 conv and LayerNorm kernels (K9's too): no spills (checked
    # after the
    # kernel rows, so that this script run on an earlier checkout still
    # times its kernels before it stops here)
    for name in CONV_KERNELS[:2] + LN_KERNELS[:1] + LN_BWD_KERNELS[:1]:
        found = [v for k, v in ptxas.items() if k.startswith(name + " ")]
        check(bool(found) and all(v.endswith("spills 0/0 bytes")
                                  for v in found),
              f"{name}: {found or 'not in the ptxas report'}")
    counts, counts_unfused, model = run_slice(dev)
    time_batch(dev, model, profile="--profile" in sys.argv)
    del model
    torch.cuda.empty_cache()
    counts_train = run_train(dev, profile="--profile" in sys.argv)

    def launches(name):
        if name in DEFAULT_PATH:
            return counts[name]
        if name in UNFUSED_PATH:
            return counts_unfused[name]
        return counts_train[name]

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches(name), **kernels[name]}
        for name, (src, rep) in SOURCES.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
