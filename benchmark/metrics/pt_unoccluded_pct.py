"""Share of the NEE shadow segments that deliver light, in percent: the
program's counters ``pt.shadow_rays`` (the candidates traced) less
``pt.shadow_occluded`` (those any-hit found blocked), over
``pt.shadow_rays``, summed over every bounce of the profiled frames. A
change to the shadow path that keeps the estimator leaves it within noise.
A program without the counter reads nothing."""

from benchmark.harness import spans


def read(ctx):
    rays, blocked = spans.counter(ctx, "pt.shadow_rays"), spans.counter(ctx, "pt.shadow_occluded")
    if blocked is None or not rays:
        return None
    return 100.0 * (rays - blocked) / rays
