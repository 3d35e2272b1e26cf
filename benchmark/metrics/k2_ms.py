"""Device ms a frame of K2, closest-hit and any-hit
(``traverse_kernel<true, *>``), in the profiled frames."""

from benchmark.harness.stats import K2, per_request_ms


def read(ctx):
    return per_request_ms(ctx, lambda t: t.device_s(K2.search))
