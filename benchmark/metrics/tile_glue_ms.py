"""Device ms a frame of every kernel, copy and fill other than K1 in the
profiled frames: ray generation, strata, shading, accumulation, the byte
conversion and the copies."""

from benchmark.harness.stats import K1, per_request_ms


def read(ctx):
    return per_request_ms(ctx, lambda t: t.device_s(lambda name: not K1.search(name)))
