"""Rays K3's lean instances traced a second of their device time, in
millions: the program's counters ``pt.live_lanes`` (closest-hit rays, the
live lanes of each bounce) and ``pt.shadow_rays`` (any-hit rays, the NEE
candidates) over the device time of ``traverse_q_kernel<true, *>``
(``k3pt_ms``'s match), in the profiled frames: ``k2_mrays_s`` for a cell
whose lean scene is a ``QPTScene``. It tells K3 tracing faster from K3
tracing fewer rays (``k3.rays`` counts the padded packets past the live
prefix too)."""

from benchmark.harness import spans
from benchmark.harness.k3pt import K3PT


def read(ctx):
    live, shadow = spans.counter(ctx, "pt.live_lanes"), spans.counter(ctx, "pt.shadow_rays")
    if live is None or ctx.trace is None:
        return None
    seconds = ctx.trace.device_s(K3PT.search)
    return (live + (shadow or 0)) / seconds / 1e6 if seconds > 0 else None
