"""Spans recorded from the benchmark's own files, and the reading of a
finished ``torch.profiler`` trace.

The union of the device's intervals (``device_intervals``, ``busy_ms``)
and ``device_kernels_ms`` are frozen copies of ``busy_ms`` and
``device_kernels_ms`` of ``wav2vecsegmenter_tpu_torch/ops/timing.py`` at
commit 3acaaec, so that a later change to the program's ``ops/`` cannot
move the yardstick.
"""

from __future__ import annotations

import contextlib
import re
import time

import torch

# harness spans appear in the trace under this prefix
SPAN_PREFIX = "bench::"


class Spans:
    """Host spans by name (seconds), recorded around calls into the
    program; under ``annotate`` each span is also a ``record_function``
    range in the profiler's trace, so that idle gaps can be named by it."""

    def __init__(self, annotate: bool = False) -> None:
        self.annotate = annotate
        self.seconds: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = (torch.profiler.record_function(SPAN_PREFIX + name)
               if self.annotate else contextlib.nullcontext())
        with ctx:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.seconds.setdefault(name, []).append(
                    time.perf_counter() - t0)


def _annotation(event) -> bool:
    """A user annotation (a profiler step, a record_function range), which
    the trace mirrors onto the device's timeline over its whole span."""
    return bool(getattr(event, "is_user_annotation", False))


def _device_us(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def busy_ms(intervals: list) -> float:
    """Device milliseconds during which at least one device activity (a
    kernel, a copy) runs: the length of the union of their intervals
    (:func:`device_intervals`)."""
    return sum(b - a for a, b in intervals) / 1e3


def device_intervals(prof) -> list[tuple[float, float]]:
    """The union of the device activities' intervals (microseconds),
    sorted and merged."""
    from torch.autograd import DeviceType

    merged: list[list[float]] = []
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in prof.events()
                              if e.device_type == DeviceType.CUDA
                              and not _annotation(e)):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], stop)
        else:
            merged.append([start, stop])
    return [(a, b) for a, b in merged]


def device_kernels_ms(prof) -> dict:
    """{kernel: device ms} of a finished torch.profiler trace, every
    device activity (kernels, copies) summed by its name shortened to the
    function (template arguments and parameters cut, so a template's
    instances count together), most first: the kernels launched through
    ctypes, which no torch op encloses, count here too."""
    from torch.autograd import DeviceType

    out: dict = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or _annotation(e):
            continue
        name = re.sub(r"^void |\(anonymous namespace\)::", "", e.key)
        name = re.split(r"[<(]", name, maxsplit=1)[0] or e.key[:64]
        out[name] = out.get(name, 0.0) + _device_us(e) / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def idle_gaps(prof, intervals: list, n: int) -> list[list]:
    """The ``n`` longest gaps between device activities, each named by
    what the host was doing at its middle: the innermost harness span and
    the innermost host op that enclose it.  [[name, seconds], ...]."""
    from torch.autograd import DeviceType

    gaps = sorted(((b0, a1) for (_, b0), (a1, _) in
                   zip(intervals, intervals[1:]) if a1 > b0),
                  key=lambda g: g[0] - g[1])[:n]
    if not gaps:
        return []
    host = [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events() if e.device_type == DeviceType.CPU]
    out = []
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        span = op = None
        for start, end, name in host:
            if not start <= mid <= end:
                continue
            if name.startswith(SPAN_PREFIX):
                if span is None or end - start < span[1] - span[0]:
                    span = (start, end, name[len(SPAN_PREFIX):])
            elif op is None or end - start < op[1] - op[0]:
                op = (start, end, name)
        label = " > ".join(x[2] for x in (span, op) if x) or "no host op"
        out.append([label, (g1 - g0) / 1e6])
    return out


def breakdown(prof, intervals: list) -> dict:
    """The ``breakdown`` of a traced run: the ten device operations that
    took most time, and the ten longest idle gaps."""
    ops = list(device_kernels_ms(prof).items())[:10]
    return {"device_ops": [[name, ms / 1e3] for name, ms in ops],
            "idle_gaps": idle_gaps(prof, intervals, 10)}
