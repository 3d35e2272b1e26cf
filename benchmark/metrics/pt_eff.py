"""The estimator's efficiency 1 / (V x T): V the mean over pixels and
channels of each pixel's sample variance across the window's frames (one
camera, one seed a frame), T the window's wall time over its frames. A
change that makes paths cheaper and noisier moves V as much as T."""


def read(ctx):
    s = ctx.state
    if s.frames < 2:
        return None
    v = float(((s.squares - s.sums * s.sums / s.frames) / (s.frames - 1)).mean())
    if v <= 0.0:  # no variance to read: every frame the same
        return None
    return 1.0 / (v * (ctx.window_end - ctx.window_start) / len(ctx.records))
