"""Rays K2 traced a second of its device time, in millions: the program's
counters ``pt.live_lanes`` (closest-hit rays, the live lanes of each
bounce) and ``pt.shadow_rays`` (any-hit rays, the NEE candidates) over the
device time of ``traverse_kernel<true, *>`` (``k2_ms``'s match), in the
profiled frames. It tells K2 tracing faster from K2 tracing fewer rays."""

from benchmark.harness import spans
from benchmark.harness.stats import K2


def read(ctx):
    live, shadow = spans.counter(ctx, "pt.live_lanes"), spans.counter(ctx, "pt.shadow_rays")
    if live is None or ctx.trace is None:
        return None
    seconds = ctx.trace.device_s(K2.search)
    return (live + (shadow or 0)) / seconds / 1e6 if seconds > 0 else None
