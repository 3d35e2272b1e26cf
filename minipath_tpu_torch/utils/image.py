"""Image conversion and IO.

``color_to_image`` matches the reference's f32->u8 mapping: scale by 255,
round, clamp, no gamma/tonemap (``minipath/src/renderer/worker.rs:69-76``).
"""

from __future__ import annotations

import numpy as np


def color_to_image(color: np.ndarray) -> np.ndarray:
    """Map float RGBA in [0, 1] to uint8: ``round(c*255)`` clamped."""
    scaled = np.rint(np.asarray(color, np.float32) * 255.0)
    return np.clip(scaled, 0.0, 255.0).astype(np.uint8)


def save_png(path, image_u8: np.ndarray) -> None:
    """Save an ``(H, W, 4)`` uint8 RGBA image as PNG."""
    from PIL import Image

    Image.fromarray(image_u8, mode="RGBA").save(path)


def load_png(path) -> np.ndarray:
    """Load a PNG as ``(H, W, 4)`` uint8 RGBA."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGBA"))


def checkerboard_under(image_u8: np.ndarray, cell: int = 8) -> np.ndarray:
    """Blend a gray checkerboard under transparent pixels (GUI helper,
    mirrors the reference GUI background blend, ``gui.rs:244-282``)."""
    h, w = image_u8.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    checker = (((yy // cell) + (xx // cell)) % 2).astype(np.float32)
    bg = (160.0 + 60.0 * checker)[..., None].repeat(3, axis=-1)
    alpha = image_u8[..., 3:4].astype(np.float32) / 255.0
    rgb = image_u8[..., :3].astype(np.float32) * alpha + bg * (1.0 - alpha)
    out = np.concatenate([rgb, np.full((h, w, 1), 255.0)], axis=-1)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
