"""Paths (one a pixel sample) of all frames the window completed, over the
wall time from the window's start to the last frame's image on the host, in
millions a second."""


def read(ctx):
    return sum(r["paths"] for r in ctx.records) / (ctx.window_end - ctx.window_start) / 1e6
