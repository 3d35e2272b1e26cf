"""Rays K3 traced a second of its device time, in millions: the program's
counter ``k3.rays`` (the rays of each K3 call, from the batch's shape) over
the device time of every K3 instance (``traverse_q_kernel<*>``), in the
profiled frames. It tells K3 tracing faster from K3 tracing fewer rays. A
program without the counter reads nothing."""

from benchmark.harness import spans
from benchmark.harness.roofline_q import K3_ANY


def read(ctx):
    rays = spans.counter(ctx, "k3.rays")
    if rays is None or ctx.trace is None:
        return None
    seconds = ctx.trace.device_s(K3_ANY.search)
    return rays / seconds / 1e6 if seconds > 0 else None
