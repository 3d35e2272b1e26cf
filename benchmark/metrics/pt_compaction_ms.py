"""Device ms a frame of the work launched inside the program's
``pt.compaction`` ranges (the sort of the path states between bounces), in
the profiled frames."""

from benchmark.harness.stats import per_request_ms


def read(ctx):
    return per_request_ms(ctx, lambda t: t.ranged_s("pt.compaction"))
