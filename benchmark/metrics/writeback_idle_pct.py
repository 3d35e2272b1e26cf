"""Share of the profiled stretch, in percent, in which no kernel, copy or
fill ran on the card while the render thread was inside a
``render.write_back`` span: the host writing a dispatch's tiles into the
image and calling their callbacks before it launches the next dispatch."""

from benchmark.harness import spans


def read(ctx):
    write_back = spans.mapped(ctx, "render.write_back")
    if write_back is None or ctx.trace.window_s <= 0 or not ctx.trace.device:
        return None
    return 100.0 * spans.idle_inside_s(ctx.trace, write_back) / ctx.trace.window_s
