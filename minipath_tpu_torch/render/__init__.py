"""Render runtime: the traversal kernel, integrators, tile machinery,
progress control."""

from minipath_tpu_torch.render.machinery import (
    RenderProgress,
    RenderProgressSnapshot,
    RenderSettings,
    render,
)

__all__ = [
    "RenderProgress",
    "RenderProgressSnapshot",
    "RenderSettings",
    "render",
]
