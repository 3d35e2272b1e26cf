"""Device ms a frame of the work launched inside the program's
``pt.shadow_batch`` ranges (the NEE shadow batch around K2's any-hit trace:
its sort key, ``torch.sort``, the gathers and parking of the segments, and
the scatter of the answers back to the lanes), in the profiled frames. A
program without the span reads nothing."""

from benchmark.harness.stats import per_request_ms


def read(ctx):
    return per_request_ms(ctx, lambda t: t.ranged_s("pt.shadow_batch"))
