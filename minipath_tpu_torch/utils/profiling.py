"""Phase timing and profiler annotations.

* :class:`PhaseTimers` accumulates named wall-clock phases (built on the same
  :class:`~minipath_tpu_torch.utils.stats.Stats` streaming accumulator the
  BVH statistics use); the render thread records dispatch/fetch phases.
  PyTorch returns before a CUDA device has finished, so a phase given a CUDA
  ``device`` synchronizes it before reading the clock: the phase then times
  the device work it enqueued, not only the enqueue.
* :func:`trace` profiles the host and, where there is one, the CUDA device,
  and writes a Chrome trace.
* :func:`annotate` names a region; ``torch.profiler`` attributes the kernels
  launched inside it to that name. Without a profiler running it costs a few
  microseconds of host time and no device work or host sync.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch

from minipath_tpu_torch.utils.stats import Stats


class PhaseTimers:
    """Accumulates wall-clock durations per named phase."""

    def __init__(self):
        self._stats: dict[str, Stats] = {}

    @contextlib.contextmanager
    def phase(self, name: str, device=None):
        """Time the enclosed block; with a CUDA ``device``, synchronize it
        at both ends so the phase holds exactly its own device work."""
        sync = device is not None and torch.device(device).type == "cuda"
        if sync:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                torch.cuda.synchronize(device)
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


def annotate(name: str):
    """Named region annotation shown in profiler traces: a context manager."""
    return torch.profiler.record_function(name)


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
