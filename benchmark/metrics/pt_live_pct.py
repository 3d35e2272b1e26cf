"""Live share of the lanes that enter the path tracer's traces, in
percent: the program's counters ``pt.live_lanes`` over ``pt.lanes``, summed
over every bounce of the profiled frames. The bounce loop's glue runs over
all lanes; K2 skips the dead packets."""

from benchmark.harness import spans


def read(ctx):
    live, lanes = spans.counter(ctx, "pt.live_lanes"), spans.counter(ctx, "pt.lanes")
    if live is None or not lanes:
        return None
    return 100.0 * live / lanes
