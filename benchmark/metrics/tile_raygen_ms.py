"""Device ms a frame of the work launched inside the program's
``render.ray_gen`` spans (the tile integrator's camera rays, strata and
their packing for K1), in the profiled frames. The spans are the render
thread's, laid on the trace's clock (``harness/spans.py``)."""

from benchmark.harness import spans
from benchmark.harness.stats import per_request_ms


def read(ctx):
    ray_gen = spans.mapped(ctx, "render.ray_gen")
    if ray_gen is None:
        return None
    return per_request_ms(ctx, lambda t: spans.launched_inside_s(t, ray_gen))
