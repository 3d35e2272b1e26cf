"""K1's share of its roofline, in percent: the least time for a frame's
traversal work (the reference's count on the cell's camera rays, through
the frozen op and byte model at the card's issue rates and HBM bandwidth)
over K1's device time a frame. The result line's ``device`` carries the
card's power limit beside it."""

from benchmark.harness.stats import K1, k1_least_s, per_request_ms


def read(ctx):
    ms = per_request_ms(ctx, lambda t: t.device_s(K1.search))
    least = k1_least_s(ctx)
    if ms is None or least is None:
        return None
    return 100.0 * max(least) / (ms / 1e3)
