"""Device ms a frame of every kernel, copy and fill other than K3 in the
profiled frames of a cell that path traces over the quantized layout: the
wavefront loop's ray generation, shading, NEE and MIS, roulette,
compaction, shadow batch and accumulation (``pt_glue_ms`` for a K3 cell)."""

from benchmark.harness.roofline_q import K3_ANY
from benchmark.harness.stats import per_request_ms


def read(ctx):
    return per_request_ms(ctx, lambda t: t.device_s(lambda name: not K3_ANY.search(name)))
