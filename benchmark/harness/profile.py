"""The device trace of a profiled stretch, reduced to what the readers use.

``torch.profiler`` records the host and the card over a stretch of whole
requests that the harness marks with the range ``bench.window``; the Chrome
trace it exports is read back here. Device activity is every kernel, copy
and fill; the traced window is the mark's extent; busy time is the union of
device activity inside it.
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path
from typing import NamedTuple

import torch

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Trace(NamedTuple):
    start_us: float
    end_us: float
    device: list  # (name, start_us, dur_us[, launched_us]) of each device activity in the window
    host: list  # (name, start_us, dur_us) of host events in the window
    ranges: list = []  # (name, start_us, end_us) of the program's annotated ranges

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def busy_s(self) -> float:
        return sum(e - s for s, e in merged(self.device)) / 1e6

    def device_s(self, match) -> float:
        """Seconds of device activity whose name ``match`` accepts."""
        return sum(e[2] for e in self.device if match(e[0])) / 1e6

    def ranged_s(self, name: str) -> float:
        """Seconds of device activity whose launch (the CUDA runtime call,
        matched to it by correlation id) fell inside a range called
        ``name``: the rule of the port's ``utils/profiling.py::annotated_ms``,
        which also counts kernels launched outside any torch operator, as
        the traversal kernels are."""
        spans = [(s, e) for n, s, e in self.ranges if n == name]
        return sum(e[2] for e in self.device
                   if len(e) > 3 and e[3] is not None and any(s <= e[3] <= t for s, t in spans)) / 1e6


def merged(device) -> list:
    """The union of device intervals as sorted disjoint ``(start, end)``."""
    out = []
    for _, s, d, *_ in sorted(device, key=lambda e: e[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s + d)
        else:
            out.append([s, s + d])
    return out


@contextlib.contextmanager
def profiled(path: Path):
    """Profile the block; yields a list that receives the :class:`Trace`.
    The caller marks its stretch with ``torch.profiler.record_function(WINDOW)``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    out = []
    with profile(activities=acts) as prof:
        yield out
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    out.append(read(path))


def read(path: Path) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    marks = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"]
    if not marks:
        raise ValueError(f"{path}: no {WINDOW} range")
    start = min(float(e["ts"]) for e in marks)
    end = max(float(e["ts"]) + float(e["dur"]) for e in marks)

    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}

    def inside(cats):
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in cats:
                continue
            s, d = float(e["ts"]), float(e.get("dur", 0.0))
            s0, s1 = max(s, start), min(s + d, end)
            if s1 > s0 or (d == 0 and start <= s <= end):
                yield e, (e["name"], s0, max(s1 - s0, 0.0))

    device = [(*t, launched.get(e.get("args", {}).get("correlation"))) for e, t in inside(DEVICE_CATS)]
    host = [t for _, t in inside(HOST_CATS) if t[0] != WINDOW]
    ranges = [(t[0], t[1], t[1] + t[2]) for e, t in inside(("user_annotation",)) if t[0] != WINDOW]
    return Trace(start, end, device, host, ranges)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps,
    each named by the innermost host event that spans its middle, or else
    as after the host event that ended last before it. The CUDA runtime's
    calls are traced on every thread, torch's operators on the profiling
    one."""
    by_name: dict = {}
    for n, _, d, *_ in trace.device:
        by_name[n] = by_name.get(n, 0.0) + d / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = merged(trace.device)
    edges = [trace.start_us] + [x for iv in busy for x in iv] + [trace.end_us]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        over = [h for h in trace.host if h[1] <= mid <= h[1] + h[2]]
        before = [h for h in trace.host if h[1] + h[2] < mid]
        if over:
            name = max(over, key=lambda h: h[1])[0]
        elif before:
            name = "after " + max(before, key=lambda h: h[1] + h[2])[0]
        else:
            name = "host"
        named.append([name, (g1 - g0) / 1e6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
