"""K3's share of its roofline, in percent: the least time for a frame's
traversal work over K3's device time a frame (``k3_ms``'s match). The work
is the reference's count on the cell's camera rays over its own tree
(``harness/work.py::k1_work``, as for K1), weighed by K3's frozen op and
byte model at the card's issue rates and HBM bandwidth
(``harness/roofline_q.py``). The result line's ``device`` carries the card's
power limit beside it."""

from benchmark.harness.roofline_q import K3, k3_least_seconds
from benchmark.harness.stats import per_request_ms


def read(ctx):
    ms = per_request_ms(ctx, lambda t: t.device_s(K3.search))
    if ms is None or ctx.device.type != "cuda":
        return None
    from benchmark.drivers import common
    from benchmark.harness import scene, work

    mesh = scene.mesh(ctx.config)
    ref, _ = common.reference_scene(ctx.config, mesh, ctx.device)
    size = (ctx.params["width"], ctx.params["height"])
    inner, leaf = work.k1_work(ref, common.lens(ctx.config), size)
    least = k3_least_seconds(size[0] * size[1] * ctx.params["spp"], inner, leaf, ref.nodes, ref.packets)
    return 100.0 * max(least) / (ms / 1e3)
