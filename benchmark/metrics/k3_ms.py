"""Device ms a frame of the K3 kernel's full closest-hit instance
(``traverse_q_kernel<false, false>``) in the profiled frames."""

from benchmark.harness.roofline_q import K3
from benchmark.harness.stats import per_request_ms


def read(ctx):
    return per_request_ms(ctx, lambda t: t.device_s(K3.search))
