"""Smoke run of the PyTorch port (wav2vecsegmenter_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds the kernels of wav2vecsegmenter_tpu_torch/ops/csrc;
3. kernels: each hand kernel against its plain PyTorch version on the card,
   at the shapes the segmentation path gives it, float32 (TF32 off) and
   bf16, with ragged lengths; times from CUDA events;
4. slice: a full-width SHAS (xls-r-300m geometry, 15 encoder layers, SFC
   1 x 8 heads, seeded random weights, output layer x40) segments two
   synthetic talks through cli.common.segment_wavs at batch 14 in bf16 with
   pTHR: once through the kernels (launch counters reset just before), once
   eager (counters must not move), once in float32; the kernels' bf16
   probabilities must be as close to the float32 ones as the eager path's
   (within KERNEL_SLACK), and the two bf16 runs no further apart than bf16
   is from float32;
5. batch: one full batch of 14 x 20 s windows timed with kernels and eager
   in turns (``--profile`` adds a torch.profiler table on standard error);
6. the last line: {"ok": true, "device": {...}}.

Needs CUDA; exits non-zero without it.  Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

import numpy as np
import torch

from wav2vecsegmenter_tpu_torch.cli.common import segment_wavs
from wav2vecsegmenter_tpu_torch.models.shas import SHAS
from wav2vecsegmenter_tpu_torch.models.wav2vec2 import init_from_numpy
from wav2vecsegmenter_tpu_torch.ops import _build, backend
from wav2vecsegmenter_tpu_torch.ops import attention as attn
from wav2vecsegmenter_tpu_torch.ops import layernorm as ln

B = 14              # conf/segment.yaml batch_size
T, T_TAIL = 999, 1099   # frames of a 20 s window and of the 22 s tail bucket
F32_ATOL = 1e-4     # float32, TF32 off: summation order only
BF16_ATOL = 2 ** -5  # one bf16 step at |y| in [4, 8): independent roundings
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
# the plain path's), and the two bf16 paths differ by no more than bf16
# differs from float32.
JAX_ENVELOPE = {"mean": 3e-3, "p99": 0.055}
KERNEL_SLACK = 1.25

SOURCES = {
    "layer_norm": ("wav2vecsegmenter_tpu_torch/ops/csrc/layernorm.cu",
                   "wav2vecsegmenter_tpu/ops/layernorm.py:34"),
    "bias_layer_norm_gelu": ("wav2vecsegmenter_tpu_torch/ops/csrc/layernorm.cu",
                             "wav2vecsegmenter_tpu/ops/layernorm.py:195"),
    "attention_packed": ("wav2vecsegmenter_tpu_torch/ops/csrc/attention.cu",
                         "wav2vecsegmenter_tpu/ops/attention.py:327"),
    "attention_bthd": ("wav2vecsegmenter_tpu_torch/ops/csrc/attention.cu",
                       "wav2vecsegmenter_tpu/ops/attention.py:89"),
}


def phase(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call from CUDA events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def ragged_mask(t: int, g: torch.Generator, dev) -> torch.Tensor:
    """[B, t] key mask: one row at t, one at about t/2, one at 1 frame, the
    rest random."""
    lengths = torch.randint(1, t + 1, (B,), generator=g)
    lengths[:3] = torch.tensor([t, t // 2, 1])
    return (torch.arange(t)[None, :] < lengths[:, None]).to(dev)


def check_kernels(dev) -> dict:
    g = torch.Generator(device="cpu").manual_seed(0)
    gd = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gd, device=dev).to(dtype)

    def ln_case(h, rows_shape, gelu, dtype):
        x = randn(*rows_shape, h, dtype=torch.float32).mul_(2).add_(0.5).to(dtype)
        scale = randn(h, dtype=torch.float32).mul_(0.1).add_(1.0)
        bias = randn(h, dtype=torch.float32).mul_(0.1)
        if gelu:
            cb = randn(h, dtype=torch.float32).mul_(0.3)
            args = (x, cb, scale, bias)
            return ln.bias_layer_norm_gelu, ln.bias_layer_norm_gelu_plain, args
        return ln.layer_norm, ln.layer_norm_plain, (x, scale, bias)

    def packed_case(t, dtype):
        proj = randn(B, t, 3 * 1024, dtype=dtype)
        mask = ragged_mask(t, g, dev)
        return (lambda: attn.attention_packed(proj, mask, 16),
                lambda: attn.attention_packed_plain(proj, mask, 16, 64 ** -0.5),
                mask)

    def bthd_case(t, dtype):
        qkv = randn(B, t, 3, 8, 128, dtype=dtype)  # the SFC's view layout
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        mask = ragged_mask(t, g, dev)
        return (lambda: attn.attention_bthd(q, k, v, mask),
                lambda: attn.attention_bthd_plain(q, k, v, mask, 128 ** -0.5),
                mask)

    cases = []  # (kernel, label, kernel fn, plain fn, valid query rows)
    for dtype in (torch.float32, torch.bfloat16):
        for h in (1024, 512):
            fn, plain, args = ln_case(h, (B * T,), False, dtype)
            cases.append(("layer_norm", f"[{B}*{T},{h}]", dtype,
                          lambda fn=fn, a=args: fn(*a),
                          lambda p=plain, a=args: p(*a), None))
        for t in (63999, T):
            fn, plain, args = ln_case(512, (B, t), True, dtype)
            cases.append(("bias_layer_norm_gelu", f"[{B},{t},512]", dtype,
                          lambda fn=fn, a=args: fn(*a),
                          lambda p=plain, a=args: p(*a), None))
        for t in (T, T_TAIL):
            fn, plain, mask = packed_case(t, dtype)
            cases.append(("attention_packed", f"[{B},{t},3072]x16", dtype,
                          fn, plain, mask))
        fn, plain, mask = bthd_case(T, dtype)
        cases.append(("attention_bthd", f"[{B},{T},8,128]", dtype, fn, plain,
                      mask))

    results: dict = {}
    for name, label, dtype, fn, plain, rows in cases:
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        check(torch.isfinite(got).all().item(), f"{name} {label}: non-finite")
        diff = (got.float() - ref.float()).abs()
        if rows is not None:
            diff = diff[rows]
        err = diff.max().item()
        tol = F32_ATOL if dtype == torch.float32 else BF16_ATOL
        big = name == "bias_layer_norm_gelu" and label.startswith(f"[{B},63999")
        ms = cuda_ms(fn, 3 if big else 10)
        plain_ms = cuda_ms(plain, 3 if big else 10)
        dname = str(dtype).replace("torch.", "")
        phase("kernel", name=name, shape=label, dtype=dname, max_abs_err=err,
              tol=tol, ms=ms, plain_ms=plain_ms)
        check(err <= tol, f"{name} {label} {dname}: max abs err {err} > {tol}")
        del got, ref, diff
        # the record keeps the main path's dtype (bf16) at its first shape
        if dtype == torch.bfloat16 and name not in results:
            results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
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


def run_slice(dev) -> dict:
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

        def run(mode: str, dtype=torch.bfloat16):
            backend.set_kernels(mode)
            before = backend.launch_counts()
            probs: dict = {}
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

        run("auto")  # warm-up: cuBLAS/cuDNN handles, pinned memory, kernels
        run("eager")
        backend.reset_launch_counts()
        rows_k, probs_k, wall = run("auto")
        counts = backend.launch_counts()
        walls = {"auto": [wall], "eager": []}
        rows_e, probs_e, wall = run("eager")
        walls["eager"].append(wall)
        for mode in ("eager", "auto", "auto", "eager"):  # alternate turns
            walls[mode].append(run(mode)[2])
        _, probs_f32, _ = run("auto", torch.float32)  # the float32 oracle

    for name in SOURCES:
        check(counts.get(name, 0) > 0, f"kernel {name} never launched")
    for rows in (rows_k, rows_e):
        check({r["wav"] for r in rows} == {w.name for w in wavs},
              "a talk got no segments")
    names = list(secs)
    for probs in (probs_k, probs_e, probs_f32):
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
    wall_k, wall_e = (float(np.median(walls[m])) for m in ("auto", "eager"))
    phase("slice", params=n_params, segments_kernels=len(rows_k),
          segments_eager=len(rows_e),
          prob_range=[float(min(p.min() for p in probs_k.values())),
                      float(max(p.max() for p in probs_k.values()))],
          dprob_kernels_vs_eager=k_vs_e, dprob_kernels_vs_f32=k_vs_f,
          dprob_eager_vs_f32=e_vs_f,
          jax_envelope_met=all(k_vs_e[q] <= JAX_ENVELOPE[q]
                               for q in JAX_ENVELOPE),
          audio_secs=audio_secs, wall_secs_kernels=walls["auto"],
          wall_secs_eager=walls["eager"],
          audio_per_wall_kernels=audio_secs / wall_k,
          audio_per_wall_eager=audio_secs / wall_e, launches=counts)
    for q in ("mean", "p99"):
        check(k_vs_f[q] <= KERNEL_SLACK * e_vs_f[q],
              f"kernels add error: {q} dprob to float32 {k_vs_f[q]} vs "
              f"{e_vs_f[q]} on the plain path")
        check(k_vs_e[q] <= e_vs_f[q],
              f"kernel vs eager {q} dprob {k_vs_e[q]} exceeds the bf16 "
              f"envelope {e_vs_f[q]}")
    return counts, model


def time_batch(dev, model, profile: bool) -> None:
    """One full batch (14 windows of 20 s) through the engine, kernels and
    eager in turns; with ``profile``, a torch.profiler table of one
    kernel-mode batch goes to standard error."""
    from wav2vecsegmenter_tpu_torch.data.windows import BatchIterator
    from wav2vecsegmenter_tpu_torch.infer.pipeline import WindowInference

    rng = np.random.RandomState(2)
    n = 320000
    env = (np.arange(n) / 16000 % 3.5) < 3.0
    examples = [((rng.randn(n) * 0.1 * env).astype(np.float32), None,
                 0, 999) for _ in range(B)]
    batch, = BatchIterator(examples, B, 20.0)  # a list serves as dataset
    engine = WindowInference(model, dev, torch.bfloat16)

    def once(mode):
        backend.set_kernels(mode)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_batch(batch).numpy()
        ms = (time.perf_counter() - t0) * 1e3
        backend.set_kernels("auto")
        return ms

    ms = {"auto": [], "eager": []}
    once("auto")
    once("eager")
    for mode in ("auto", "eager", "eager", "auto", "auto", "eager"):
        ms[mode].append(once(mode))
    phase("batch", windows=B, audio_secs=B * 20.0, ms_kernels=ms["auto"],
          ms_eager=ms["eager"],
          audio_per_wall_kernels=B * 20.0 / (np.median(ms["auto"]) / 1e3),
          audio_per_wall_eager=B * 20.0 / (np.median(ms["eager"]) / 1e3),
          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof

        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            once("auto")
        print(p.key_averages().table(sort_by="cuda_time_total", row_limit=40),
              file=sys.stderr, flush=True)


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
    ptxas = [l.strip() for l in _build.build_log.splitlines()
             if "registers" in l or "spill" in l]
    phase("build", seconds=time.perf_counter() - t0,
          nvcc_seconds=_build.build_seconds, ptxas=ptxas)

    kernels = check_kernels(dev)
    counts, model = run_slice(dev)
    time_batch(dev, model, profile="--profile" in sys.argv)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], **kernels[name]}
        for name, (src, rep) in SOURCES.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
