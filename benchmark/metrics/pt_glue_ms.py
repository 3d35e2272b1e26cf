"""Device ms a frame of every kernel, copy and fill other than K2 in the
profiled frames: the wavefront loop's ray generation, scatter, NEE and MIS,
roulette, compaction and accumulation."""

from benchmark.harness.stats import K2, per_request_ms


def read(ctx):
    return per_request_ms(ctx, lambda t: t.device_s(lambda name: not K2.search(name)))
