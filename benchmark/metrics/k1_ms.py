"""Device ms a frame of the K1 kernel (``traverse_kernel<false, false>``)
in the profiled frames."""

from benchmark.harness.stats import K1, per_request_ms


def read(ctx):
    return per_request_ms(ctx, lambda t: t.device_s(K1.search))
