"""Camera rays of all frames the window completed (width x height x spp a
frame), over the wall time from the window's start to the last frame's
image on the host, in millions a second."""


def read(ctx):
    rays = sum(r["rays"] for r in ctx.records)
    return rays / (ctx.window_end - ctx.window_start) / 1e6
