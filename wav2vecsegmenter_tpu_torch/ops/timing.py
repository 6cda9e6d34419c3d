"""Timing helpers of the measurement scripts (``chip_smoke.py`` and
``ops.tile_sweep``) on a CUDA card: CUDA events, torch.profiler device
times and the host's time a call.  Nothing on the segment or train path
imports this module."""

from __future__ import annotations

import time

import torch


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


def device_ms(fn, iters: int, names: tuple[str, ...]) -> dict:
    """Mean device milliseconds per call of the kernels whose names hold
    each of ``names``, from a torch.profiler trace of ``iters`` calls after
    one warm call: the device's own time, where CUDA events around a short
    kernel would also count the host's launch gaps."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for event in prof.key_averages():
        us = getattr(event, "self_device_time_total",
                     getattr(event, "self_cuda_time_total", 0.0))
        for name in names:
            if name in event.key:
                out[name] += us / 1e3 / iters
    return out


def host_us(fn, iters: int) -> float:
    """Mean host microseconds per call: the time ``iters`` calls take to
    enqueue their work, after one warm call, without waiting for the
    device (where it exceeds the device time, CUDA events measure it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us
