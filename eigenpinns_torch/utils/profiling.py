"""The port's tracer: named spans and counters inside the program, and a
`torch.profiler` trace around any code block.

Tracing is on while a `torch.profiler` runs (`trace()` below, or any
other profiler, one that records CUDA activity alone included) and off
otherwise. Off, `span` returns one shared no-op context manager and
`count` returns at once: no allocation, no CUDA event, no profiler
range. On, a span records its name, its parent (the innermost span open
in its thread) and its host start and end by `time.time_ns()`, the
clock of the profiler's device events; with CUDA initialised, also a
pair of timing events on the current stream, whose interval
(`device_ms`) is the stream's time from reaching the span's start to
reaching its end, the card's idle inside it included. The events are
resolved when the records are read, so a span adds no host sync. Inside
`trace()`, which records CPU activity, a span also opens a
`record_function` range of its name, so the spans show in its Chrome
trace; under any other profiler it opens none (a range costs ~14 us).

    with span("lobpcg.gram"):
        G = U.T @ V
    count("sync.eigh")
    records(), counters()   # kept in memory until read; reset() clears
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time

import torch

_profiler_enabled = torch.autograd._profiler_enabled


class _Off:
    """The span while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_closed: list = []       # (name, parent, start_ns, end_ns, events), unread
_read: list = []         # the records of the closed spans read so far
_counts: collections.Counter = collections.Counter()
_open = threading.local()                  # .stack: this thread's open spans
_ranges = 0                                # depth of open trace() blocks
_streams: dict = {}


def _current_stream():
    """The current CUDA stream, one Python object per stream: building one
    (`torch.cuda.current_stream()`) costs ~7 us of host time on an H100
    machine, a third of a span's."""
    key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.Stream(
            stream_id=key[0], device_index=key[1], device_type=key[2])
    return stream


class _Span:
    """One span while tracing is on."""

    __slots__ = ("name", "parent", "start_ns", "_events", "_range")

    def __init__(self, name: str):
        self.name = name
        self.parent = self._events = self._range = None

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        if stack:
            self.parent = stack[-1].name
        stack.append(self)
        if _ranges:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = time.time_ns()
        if torch.cuda.is_initialized():
            # The events' C base class: unlike `torch.cuda.Event`, no
            # Python object for the garbage collector to walk, which a
            # window's ~10^5 spans make it do often.
            stream = _current_stream()
            start = torch._C._CudaEventBase(enable_timing=True)
            start.record(stream)
            self._events = (start, torch._C._CudaEventBase(
                enable_timing=True), stream)
        return self

    def __exit__(self, *exc):
        events = self._events
        if events is not None:
            events[1].record(events[2])
            events = events[:2]
        end_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _open.stack.pop()
        _closed.append((self.name, self.parent, self.start_ns, end_ns,
                        events))
        return False


def span(name: str):
    """A context manager that records its block as the span `name` while
    tracing is on; off, the shared no-op."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Adds `n` to the counter `name` while tracing is on."""
    if _profiler_enabled():
        _counts[name] += n


def records() -> list:
    """Every span closed while tracing was on since the last `reset()`, in
    closing order: {name, parent, start_ns, end_ns (host, Unix ns),
    device_ms (None without CUDA)}. The first read of a span waits for
    its end event."""
    for name, parent, start_ns, end_ns, events in _closed:
        device_ms = None
        if events is not None:
            start, end = events
            end.synchronize()
            device_ms = start.elapsed_time(end)
        _read.append({"name": name, "parent": parent, "start_ns": start_ns,
                      "end_ns": end_ns, "device_ms": device_ms})
    _closed.clear()
    return [dict(r) for r in _read]


def counters() -> dict:
    """The counters counted while tracing was on since the last
    `reset()`."""
    return dict(_counts)


def reset() -> None:
    """Forgets every closed span and every counter."""
    _closed.clear()
    _read.clear()
    _counts.clear()


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Capture a torch.profiler trace of the block (CPU activity, and the
    card's when CUDA is available), the port's spans as ranges in it, and
    write it to `<log_dir>/trace_<pid>_<time>.json` as a Chrome trace
    (viewable in Perfetto or chrome://tracing); with `log_dir` None, only
    yield the profiler."""
    global _ranges
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        _ranges += 1
        try:
            yield prof
        finally:
            _ranges -= 1
    if log_dir is not None:
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))
