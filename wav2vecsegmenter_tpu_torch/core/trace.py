"""Traces of a run: ``torch.profiler`` sessions and the program's spans.

``start_trace`` / ``stop_trace`` (the JAX package's
``jax.profiler.start_trace`` / ``stop_trace``) record host (CPU) activity,
and the card's kernels where there is one.  A stopped trace is one Chrome
trace file, ``<dir>/rank<r>.<ns>.pt.trace.json``, written by
``tensorboard_trace_handler``: one file a rank under a mesh.

**Spans.**  ``span(name, **attrs)`` marks a part of the program's work
where it happens (``data.wait``, ``train.forward``, ``ops.attention.bwd``,
...).  One recorder in the process keeps them in memory, each a
:class:`Span`: its name, its start and end on the host clock
(``time.perf_counter``), its thread's name, its parent (the innermost span
open on its thread when it opened), the micro-step it belongs to (the
count of ``micro_step_done`` calls before it opened: the spans of one
train step and the ``data.wait`` before it share one), and its ``attrs``.
While it is open a span is also a ``torch.profiler.record_function``
range of the same name, so a profiler's trace carries it beside the
kernels, on one clock.  A span opened with ``device=True`` (those whose
device time a metric reads) also records, where CUDA is initialized, a
timing ``torch.cuda.Event`` on the current stream at each end: its device
time runs from when the stream reached its start until the stream
finished the work it enqueued.  The events are read only when a span's
device time is (``Span.device_seconds``), after the work, and dropped
then; on the CPU, where work runs as it is issued, the device time is the
host time.

The recorder is on while a ``torch.profiler`` session runs in the process
or while a caller holds ``recording()``; nothing else turns it on.  Off,
a span site costs a test of those two flags: it allocates no span,
records no event and, for ``backward_span``, adds no autograd node.
``start_trace``, ``stop_trace`` and ``clear()`` empty the store; between
them it keeps the newest ``STORE_SPANS`` spans, which ``spans()`` reads
without taking them out (every metric of a window reads them all).  A
span given ``into`` (a list) is a host timer besides: its seconds go to
that list, on or off (the reader's ``data.read`` and ``data.wait``).

Launch counts stay where they are counted (``ops.backend.count_launch``).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

_held = 0              # callers inside ``recording()``
_micro_step = 0        # ``micro_step_done`` calls so far
_ids = itertools.count()
STORE_SPANS = 1 << 16  # spans kept: a traced window holds ~40 a micro-step
_store: collections.deque = collections.deque(maxlen=STORE_SPANS)
_open = threading.local()
OFF = contextlib.nullcontext()


def on() -> bool:
    """Whether span sites record: a profiler session runs in the process
    (its Python-level flag, seen from every thread) or a caller holds
    ``recording()``."""
    return bool(_held) or getattr(_autograd_profiler, "_is_profiler_enabled",
                                  False) or torch.autograd._profiler_enabled()


@contextlib.contextmanager
def recording():
    """The recorder on for the block, with no profiler running."""
    global _held
    _held += 1
    try:
        yield
    finally:
        _held -= 1


def micro_step_done() -> None:
    """Spans opened from now on belong to the next micro-step."""
    global _micro_step
    _micro_step += 1


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


class Span:
    """One recorded span; a context manager while it is open."""

    __slots__ = ("id", "name", "parent", "micro_step", "thread", "attrs",
                 "start", "end", "_into", "_device", "_range", "_events",
                 "_device_s")

    def __init__(self, name: str, into: list | None, device: bool,
                 attrs: dict) -> None:
        self.name = name
        self.attrs = attrs
        self._into = into
        self._device = device
        self._events = self._device_s = self.end = None

    def __enter__(self) -> Span:
        # the range opens first and closes last, so that the host's
        # timeline between consecutive or nested spans' ranges is as short
        # as it can be: a device gap there is named by no span
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.id = next(_ids)
        self.micro_step = _micro_step
        self.thread = threading.current_thread().name
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        if self._device and torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self._events is not None:
            self._events[1].record()
        self.end = time.perf_counter()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if self._into is not None:
            self._into.append(self.end - self.start)
            self._into = None
        _store.append(self)
        self._range.__exit__(None, None, None)
        self._range = None

    @property
    def seconds(self) -> float:
        """Host seconds."""
        return self.end - self.start

    @property
    def device_seconds(self) -> float:
        """Device seconds: the stream's time from the span's start to the
        end of the work it enqueued; the host seconds where no events were
        recorded (the CPU, a span not opened with ``device=True``).  Waits
        for that work."""
        if self._device_s is None:
            if self._events is None:
                return self.seconds
            start, end = self._events
            end.synchronize()
            self._device_s = start.elapsed_time(end) / 1e3
            self._events = None
        return self._device_s


class _Timer:
    """A span given ``into`` while the recorder is off: host seconds
    only."""

    __slots__ = ("_into", "_t0")

    def __init__(self, into: list) -> None:
        self._into = into

    def __enter__(self) -> None:
        self._t0 = time.perf_counter()

    def __exit__(self, *exc) -> None:
        self._into.append(time.perf_counter() - self._t0)


def span(name: str, into: list | None = None, device: bool = False,
         **attrs):
    """A context manager around a part of the work: a recorded
    :class:`Span` while the recorder is on (with its device time where
    ``device``), else nothing (``OFF``), or, given ``into``, a host timer
    appending its seconds there."""
    if not on():
        return OFF if into is None else _Timer(into)
    return Span(name, into, device, attrs)


class _OpenOnBackward(torch.autograd.Function):
    """Identity whose backward opens the span of ``backward_span``."""

    @staticmethod
    def forward(ctx, y, name, pending):
        ctx.span_name, ctx.pending = name, pending
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        s = span(ctx.span_name, device=True)
        if s is not OFF:
            ctx.pending.append(s.__enter__())
        return grad, None, None


class _CloseOnBackward(torch.autograd.Function):
    """Identity whose backward closes the span ``_OpenOnBackward`` opened."""

    @staticmethod
    def forward(ctx, x, pending):
        ctx.pending = pending
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        while ctx.pending:
            ctx.pending.pop().__exit__(None, None, None)
        return grad, None


def backward_span(name: str, fn, x: torch.Tensor, *args) -> torch.Tensor:
    """``fn(x, *args)`` whose backward is recorded as the span ``name``,
    with its device time: the output's gradient arriving opens it, on the
    autograd engine's thread, and ``x``'s gradient leaving closes it, so it
    brackets the backward of every node between them.  Two identity nodes
    mark the ends, placed only while the recorder is on and ``x`` takes a
    gradient."""
    if not (on() and torch.is_grad_enabled() and x.requires_grad):
        return fn(x, *args)
    pending: list = []
    return _OpenOnBackward.apply(
        fn(_CloseOnBackward.apply(x, pending), *args), name, pending)


def spans() -> list[Span]:
    """The recorded spans, in the order they closed; the store keeps
    them."""
    return list(_store)


def clear() -> None:
    """Empty the store."""
    _store.clear()


def start_trace(out_dir):
    """A running trace that writes into ``out_dir`` when stopped; the
    span store starts empty."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    from .runtime import rank

    clear()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(
                       str(out_dir), worker_name=f"rank{rank()}"))
    prof.start()
    return prof


def stop_trace(prof) -> None:
    """Wait for the card's queued work, stop the trace and write it; the
    span store is emptied (the trace file carries the spans' ranges)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    prof.stop()
    clear()
