"""Arithmetic the metric readers share."""

from __future__ import annotations

import re

# K1 is the full closest-hit instance of the traversal loop,
# traverse_kernel<false, false>; K2 the lean ones, traverse_kernel<true, *>.
K1 = re.compile(r"traverse_kernel<\s*false\s*,\s*false\s*>")
K2 = re.compile(r"traverse_kernel<\s*true\s*,")


def idle_pct(trace) -> float | None:
    """Idle share of the traced window in percent; None where no device
    activity was traced (a run off the card)."""
    if trace is None or trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


def per_request_ms(ctx, seconds) -> float | None:
    """Device ms a profiled request of what ``seconds(trace)`` reads from
    the trace; None where it reads nothing."""
    if ctx.trace is None or not ctx.traced:
        return None
    s = seconds(ctx.trace)
    return 1e3 * s / len(ctx.traced) if s > 0 else None


def k1_least_s(ctx) -> tuple | None:
    """``(seconds by operations, seconds by bytes)`` that K1 needs at least
    for one frame of the cell, at the card's peaks, from the reference's
    count of work; None off the card. Cached in the context for the readers
    that share it."""
    if ctx.device.type != "cuda":
        return None
    if "k1_least_s" not in ctx.cache:
        from benchmark.drivers import common
        from benchmark.harness import roofline, scene, work

        mesh = scene.mesh(ctx.config)
        ref, _ = common.reference_scene(ctx.config, mesh, ctx.device)
        size = (ctx.params["width"], ctx.params["height"])
        inner, leaf = work.k1_work(ref, common.lens(ctx.config), size)
        rays = size[0] * size[1] * ctx.params["spp"]
        ctx.cache["k1_least_s"] = roofline.k1_least_seconds(rays, inner, leaf, ref.nodes, ref.packets)
    return ctx.cache["k1_least_s"]
