"""Spans, counters, phase timers and profiler helpers.

* :func:`span` records a named region of the program: its name, start and
  end (``time.time_ns``, the clock the profiler's trace is stamped with, up
  to one offset), thread, parent span and request; :func:`count` adds to a
  named counter. Both record only while tracing is on: while a torch
  profiler records (on any thread: the process-wide flag that the render
  thread also sees) or after :func:`enable`. Off, a span is one flag check
  (no clock read, no ``record_function``, no allocation) and a counter does
  nothing. Under a profiler each span also enters ``record_function``, so
  the kernels launched inside it are attributed to its name in the trace.
  :func:`take` returns and clears what was recorded;
  :func:`export_chrome_trace` writes it as a Chrome trace.
* :class:`PhaseTimers` accumulates the host time of named phases, each also
  a span; the render thread records ``dispatch`` and ``fetch``. It never
  synchronizes a device: the device time of a phase comes from a trace.
* :func:`trace` profiles the host and, where there is one, the CUDA device,
  and writes a Chrome trace; :func:`annotated_ms` reads ranges' device time
  from the profiler's events.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from pathlib import Path
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

from minipath_tpu_torch.utils.stats import Stats

# Spans a record keeps at most; past it the oldest are dropped.
MAX_SPANS = 1 << 18


class Span(NamedTuple):
    name: str
    start_ns: int  # time.time_ns()
    end_ns: int
    thread: int  # threading.get_ident()
    id: int
    parent: int | None  # the enclosing span's id
    request: int  # shared by every span of one render() or render_frame_pt call


class Record(NamedTuple):
    spans: list  # of Span, in the order they ended
    counters: dict  # name -> total


_OFF = contextlib.nullcontext()


class Recorder:
    """Spans and counters kept in memory until :meth:`take`."""

    def __init__(self):
        self.enabled = False
        self._spans = deque(maxlen=MAX_SPANS)
        self._host: dict = {}
        self._device: dict = {}  # (name, device) -> accumulating tensor
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)

    def recording(self) -> bool:
        """True while spans and counters are recorded."""
        return self.enabled or _autograd_profiler._is_profiler_enabled

    def new_request(self) -> int:
        """A fresh request id (see :meth:`span`)."""
        return next(self._ids)

    def current(self) -> int | None:
        """The id of the innermost span open on this thread, if any: the
        ``parent`` a span on another thread names to join this one."""
        stack = getattr(self._local, "stack", None)
        return stack[-1][0] if stack else None

    def span(self, name: str, request: int | None = None, parent: int | None = None):
        """A context manager recording a span called ``name``. Its parent is
        ``parent``, else the innermost span open on this thread; its request
        is ``request``, else its parent's on this thread, else a new one."""
        if not (self.enabled or _autograd_profiler._is_profiler_enabled):
            return _OFF
        return _OpenSpan(self, name, request, parent)

    def count(self, name: str, value) -> None:
        """Add ``value`` (a Python number, or a 0-d tensor summed where it
        lies, with no host sync) to the counter ``name``."""
        if not (self.enabled or _autograd_profiler._is_profiler_enabled):
            return
        with self._lock:
            if not isinstance(value, torch.Tensor):
                self._host[name] = self._host.get(name, 0) + value
                return
            key = (name, value.device)
            held = self._device.get(key)
            if held is None:
                self._device[key] = value.to(torch.float64 if value.is_floating_point() else torch.int64, copy=True)
            else:
                held.add_(value)

    def take(self) -> Record:
        """What was recorded since the last take, cleared; the device
        counters are read here (one host sync each)."""
        with self._lock:
            spans, self._spans = list(self._spans), deque(maxlen=MAX_SPANS)
            counters, device = self._host, self._device
            self._host, self._device = {}, {}
        for (name, _), total in device.items():
            counters[name] = counters.get(name, 0) + total.item()
        return Record(spans, counters)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _add(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)


class _OpenSpan:
    __slots__ = ("rec", "name", "request", "parent", "id", "range", "start")

    def __init__(self, rec: Recorder, name: str, request, parent):
        self.rec, self.name, self.request, self.parent = rec, name, request, parent

    def __enter__(self):
        stack = self.rec._stack()
        if stack:
            if self.parent is None:
                self.parent = stack[-1][0]
            if self.request is None:
                self.request = stack[-1][1]
        if self.request is None:
            self.request = self.rec.new_request()
        self.id = next(self.rec._ids)
        stack.append((self.id, self.request))
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        self.rec._stack().pop()
        self.rec._add(Span(self.name, self.start, end, threading.get_ident(), self.id, self.parent, self.request))
        return False


#: The process's recorder: the program's spans and counters go here.
RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
take = RECORDER.take
recording = RECORDER.recording
new_request = RECORDER.new_request
current = RECORDER.current


def enable() -> None:
    """Record spans and counters with no profiler running."""
    RECORDER.enabled = True


def disable() -> None:
    RECORDER.enabled = False


def export_chrome_trace(record: Record, path) -> None:
    """Write ``record`` as a Chrome trace: a complete event a span (its id,
    parent and request in ``args``) and a counter event a counter at the
    end. As in ``torch.profiler``'s traces, ``ts`` is in microseconds since
    ``baseTimeNanoseconds``, here the first span's start."""
    base = min((s.start_ns for s in record.spans), default=time.time_ns())
    end = max((s.end_ns for s in record.spans), default=base)
    pid = os.getpid()
    events = [
        {"ph": "X", "cat": "minipath", "name": s.name, "pid": pid, "tid": s.thread, "ts": (s.start_ns - base) / 1e3,
         "dur": (s.end_ns - s.start_ns) / 1e3, "args": {"id": s.id, "parent": s.parent, "request": s.request}}
        for s in record.spans
    ]
    events += [{"ph": "C", "cat": "minipath", "name": name, "pid": pid, "tid": 0, "ts": (end - base) / 1e3,
                "args": {name: value}} for name, value in sorted(record.counters.items())]
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"traceEvents": events, "displayTimeUnit": "ms", "baseTimeNanoseconds": base}))


class PhaseTimers:
    """Host time per named phase; each phase is also a span called
    ``prefix + name``."""

    def __init__(self, prefix: str = ""):
        self._prefix = prefix
        self._stats: dict[str, Stats] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time the enclosed block on the host's clock."""
        t0 = time.perf_counter()
        try:
            with span(self._prefix + name):
                yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self._stats.setdefault(name, Stats()).add_sample(seconds)

    def stats(self, name: str) -> Stats:
        return self._stats.get(name, Stats())

    def total(self, name: str) -> float:
        return self._stats[name].total if name in self._stats else 0.0

    def summary(self) -> dict:
        return {
            name: {
                "count": s.count,
                "total_s": round(s.total, 6),
                "avg_ms": round(1e3 * s.avg, 3) if s.count else None,
                "max_ms": round(1e3 * s.max, 3) if s.count else None,
            }
            for name, s in sorted(self._stats.items())
        }

    def __str__(self) -> str:
        lines = []
        for name, s in sorted(self._stats.items()):
            lines.append(f"{name}: n={s.count} total={s.total:.3f}s avg={1e3*s.avg:.1f}ms")
        return "\n".join(lines) or "no phases recorded"


@contextlib.contextmanager
def trace(log_dir):
    """Profile the enclosed block on the host and, where CUDA is available,
    on the device; write the Chrome trace to ``log_dir/trace.json``. Yields
    the ``torch.profiler.profile`` object, whose ``key_averages()`` and
    ``events()`` the caller may read after the block."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def annotated_ms(events, names, device: bool) -> list:
    """``(name, ms)`` of every profiled range whose name is in ``names``, in
    the order the ranges started. ``events`` is
    ``torch.profiler.profile(...).events()``.

    With ``device``, a range's milliseconds are the device time of the
    kernels, copies and fills whose launch (the CUDA runtime call, matched to
    its kernel by correlation id) fell inside it, counted to the innermost
    such range. A kernel launched outside any torch operator, as the
    traversal kernels are through ctypes, counts too, where the profiler's
    own ``device_time_total`` leaves it out. Without ``device``, a range's
    host time."""
    ranges = sorted((e for e in events if e.name in names and e.device_type == torch.autograd.DeviceType.CPU),
                    key=lambda e: e.time_range.start)
    if not device:
        return [(e.name, e.cpu_time_total / 1e3) for e in ranges]
    launched_at = {e.id: e.time_range.start for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("cuda")}
    kernels = [(k, launched_at[k.id]) for k in events
               if k.device_type == torch.autograd.DeviceType.CUDA and k.name not in names and k.id in launched_at]
    us = [0.0] * len(ranges)
    for k, at in kernels:
        inner = None
        for i, r in enumerate(ranges):  # sorted by start: the last that holds the launch is the innermost
            if r.time_range.start <= at <= r.time_range.end:
                inner = i
        if inner is not None:
            us[inner] += k.time_range.elapsed_us()
    return [(r.name, t / 1e3) for r, t in zip(ranges, us)]
