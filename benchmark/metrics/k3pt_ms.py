"""Device ms a frame of K3's lean instances, closest-hit and any-hit
(``traverse_q_kernel<true, *>``), in the profiled frames of a cell that
path traces over the quantized layout."""

from benchmark.harness.k3pt import K3PT
from benchmark.harness.stats import per_request_ms


def read(ctx):
    return per_request_ms(ctx, lambda t: t.device_s(K3PT.search))
