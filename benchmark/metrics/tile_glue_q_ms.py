"""Device ms a frame of every kernel, copy and fill other than K3 in the
profiled frames of a cell whose traversal is K3: ray generation, strata,
shading, accumulation, the byte conversion and the copies."""

from benchmark.harness.roofline_q import K3_ANY
from benchmark.harness.stats import per_request_ms


def read(ctx):
    return per_request_ms(ctx, lambda t: t.device_s(lambda name: not K3_ANY.search(name)))
