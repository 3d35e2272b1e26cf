"""Seconds from process start to the first timed request: imports, the
card, the scene, the program's tree and upload, and the warm-up."""


def read(ctx):
    return ctx.setup_s
