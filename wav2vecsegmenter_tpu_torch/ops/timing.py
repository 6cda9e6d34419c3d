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


def device_busy_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call during which at least one of its
    kernels runs (the union of the kernels' intervals), from a
    torch.profiler trace of ``iters`` calls after one warm call: where a
    call's kernels overlap (programmatic dependent launch), this, and not
    the sum of their device times, is the call's time on the device."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return busy_ms(prof) / iters


def _annotation(event) -> bool:
    """A user annotation (a profiler step, a record_function range), which
    the trace mirrors onto the device's timeline over its whole span."""
    return bool(getattr(event, "is_user_annotation", False))


def busy_ms(prof) -> float:
    """Device milliseconds of a finished torch.profiler trace during which
    at least one device activity (a kernel, a copy) runs: the union of
    their intervals."""
    from torch.autograd import DeviceType

    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in prof.events()
                              if e.device_type == DeviceType.CUDA
                              and not _annotation(e)):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy / 1e3


def top_device_ops(prof, n: int) -> dict:
    """The ``n`` host-side ops of a finished torch.profiler trace (CPU and
    CUDA activities) whose own launches took the most device time: {name:
    device ms}, and the sum over every op under ``"total"`` (each kernel
    counts once, for the op that launched it)."""
    from torch.autograd import DeviceType

    rows = [(e.key, getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0)) / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and not _annotation(e)]
    rows.sort(key=lambda r: -r[1])
    return {**dict(rows[:n]), "total": sum(ms for _, ms in rows)}


def device_kernels_ms(prof) -> dict:
    """{kernel: device ms} of a finished torch.profiler trace, every
    device activity (kernels, copies) summed by its name shortened to the
    function (template arguments and parameters cut, so a template's
    instances count together), most first: the kernels launched through
    ctypes, which no torch op encloses, count here too."""
    import re

    from torch.autograd import DeviceType

    out: dict = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or _annotation(e):
            continue
        name = re.sub(r"^void |\(anonymous namespace\)::", "", e.key)
        name = re.split(r"[<(]", name, maxsplit=1)[0] or e.key[:64]
        out[name] = out.get(name, 0.0) + getattr(
            e, "self_device_time_total",
            getattr(e, "self_cuda_time_total", 0.0)) / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


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
