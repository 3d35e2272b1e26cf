"""The program's own spans and counters, laid on the device trace's clock.

While a torch profiler records, the port keeps spans (name, start and end
in ``time.time_ns``, thread, parent, request) and counters in memory
(``minipath_tpu_torch/utils/profiling.py``). The readers take that record
once, after the profiled stretch. The spans opened on the profiling thread
are ranges of the trace as well; the median gap between their two stamps is
the one offset that puts every span on the trace's timeline, the render
thread's included, which the profiler does not trace. A program without the
recorder gives no record, and the readers then read nothing.
"""

from __future__ import annotations

import statistics

from benchmark.harness.profile import merged

# Spans the program opens on the caller's thread, which is the profiled one.
ANCHORS = ("render.start", "render.wait", "render.image", "pt.frame", "pt.chunk")


def record(ctx):
    """The program's record of the profiled stretch, ``(spans, counters)``,
    taken once and shared by the readers; None where there is none."""
    if "program_record" not in ctx.cache:
        ctx.cache["program_record"] = _take() if ctx.trace is not None else None
    return ctx.cache["program_record"]


def _take():
    try:
        from minipath_tpu_torch.utils import profiling
    except ImportError:
        return None
    take = getattr(profiling, "take", None)
    if take is None:
        return None
    rec = take()
    return rec if rec.spans or rec.counters else None


def offset_us(trace, spans) -> float | None:
    """Trace time minus program time, in microseconds: the median over the
    anchors, paired in order of start by name where both sides hold the
    same number; None where no anchor pairs."""
    gaps = []
    for name in ANCHORS:
        mine = sorted(s.start_ns for s in spans if s.name == name)
        theirs = sorted(start for n, start, _ in trace.ranges if n == name)
        if mine and len(mine) == len(theirs):
            gaps += [t - m / 1e3 for m, t in zip(mine, theirs)]
    return statistics.median(gaps) if gaps else None


def mapped(ctx, name: str) -> list | None:
    """``(start_us, end_us)`` on the trace's timeline of every span called
    ``name``; None where there is no record, no anchor or no such span."""
    rec = record(ctx)
    if rec is None:
        return None
    off = offset_us(ctx.trace, rec.spans)
    if off is None:
        return None
    out = sorted((s.start_ns / 1e3 + off, s.end_ns / 1e3 + off) for s in rec.spans if s.name == name)
    return out or None


def launched_inside_s(trace, spans) -> float:
    """Seconds of device activity whose launch (the CUDA runtime call,
    traced on every thread) fell inside one of ``spans``."""
    return sum(e[2] for e in trace.device
               if len(e) > 3 and e[3] is not None and any(s <= e[3] <= t for s, t in spans)) / 1e6


def idle_inside_s(trace, spans) -> float:
    """Seconds of the traced window inside ``spans`` in which no kernel,
    copy or fill ran. The spans of one name do not overlap."""
    busy = merged(trace.device)
    idle = 0.0
    for s, t in spans:
        s, t = max(s, trace.start_us), min(t, trace.end_us)
        if t <= s:
            continue
        idle += (t - s) - sum(max(0.0, min(t, b1) - max(s, b0)) for b0, b1 in busy)
    return idle / 1e6


def counter(ctx, name: str):
    """The program's counter ``name`` over the profiled stretch, or None."""
    rec = record(ctx)
    return None if rec is None else rec.counters.get(name)
