"""Device ms a frame of the work launched inside the program's ``pt.shade``
ranges (a bounce's shading: the bounce-shading kernel and the uniforms it
reads on a card, and the add of the NEE light after the shadow trace), in the
profiled frames. A program without the span reads nothing."""

from benchmark.harness.stats import per_request_ms


def read(ctx):
    return per_request_ms(ctx, lambda t: t.ranged_s("pt.shade"))
