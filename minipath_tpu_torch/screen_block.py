"""Screen blocks and tile decomposition.

Host-side counterpart of ``minipath/src/screen_block.rs``: a
:class:`ScreenBlock` is an integer 2-D AABB over pixel coordinates with
``internal_points`` (row-major pixel iteration, ``screen_block.rs:28-39``) and
``tile_ordering`` — splitting a block into clipped tiles sorted center-out
with exponential random jitter, a purely aesthetic ordering kept for parity
with the reference GUI look (``screen_block.rs:41-81``).
"""

from __future__ import annotations

import functools

import numpy as np

from minipath_tpu_torch.geometry.aabb import AABB


class ScreenBlock(AABB):
    """2-D integer pixel block ``[min, max)``."""

    def __init__(self, min_point, max_point):
        super().__init__(
            np.asarray(min_point, np.int64), np.asarray(max_point, np.int64)
        )

    @classmethod
    def with_size(cls, origin, size) -> "ScreenBlock":
        origin = np.asarray(origin, np.int64)
        return cls(origin, origin + np.asarray(size, np.int64))

    def is_empty(self) -> bool:
        return not bool(np.all(self.min < self.max))

    def area(self) -> int:
        if self.is_empty():
            return 0
        return int(np.prod(self.size()))

    def contains(self, p) -> bool:
        p = np.asarray(p)
        return bool(np.all(p >= self.min) and np.all(p < self.max))

    def internal_points(self):
        """Iterate ``(x, y)`` pixel coordinates in C order (x fastest)."""
        if self.is_empty():
            return
        for y in range(self.min[1], self.max[1]):
            for x in range(self.min[0], self.max[0]):
                yield (x, y)

    def internal_points_array(self) -> np.ndarray:
        """All internal pixel coordinates as an ``(area, 2)`` array."""
        if self.is_empty():
            return np.zeros((0, 2), np.int64)
        xs = np.arange(self.min[0], self.max[0])
        ys = np.arange(self.min[1], self.max[1])
        gx, gy = np.meshgrid(xs, ys)
        return np.stack([gx.ravel(), gy.ravel()], axis=-1)

    def tile_ordering(self, tile_size: int, rng=None) -> "list[ScreenBlock]":
        """Split into tiles ordered center-out with random jitter.

        Tiles are ``tile_size``-square except clipped at the bottom/right
        edge. Sorted by distance of tile center to block center plus an
        Exp-distributed jitter with scale ``0.1 * |center|``
        (``screen_block.rs:41-81``).
        """
        assert tile_size >= 1
        if self.is_empty():
            return []
        rng = rng if rng is not None else np.random.default_rng()
        corners = (int(self.min[0]), int(self.min[1]), int(self.max[0]), int(self.max[1]))
        ranges, distances, randomness_scale = _tile_grid(*corners, tile_size)
        tiles = [ScreenBlock((x0, y0), (x1, y1)) for (x0, y0, x1, y1) in ranges]
        # One draw a tile, in tile order: the same draws as one call each.
        jitter = rng.exponential(randomness_scale, len(tiles)) if randomness_scale > 0 else 0.0
        order = np.argsort(distances + jitter, kind="stable")
        return [tiles[i] for i in order]


def divide_range(start: int, end: int, tile_size: int):
    """Split ``[start, end)`` into ``tile_size`` chunks, last one clipped."""
    n = max(0, end - start)
    full, rem = divmod(n, tile_size)
    count = full + (1 if rem else 0)
    for i in range(count):
        lo = start + i * tile_size
        yield (lo, min(end, lo + tile_size))


@functools.lru_cache(maxsize=64)
def _tile_grid(x0: int, y0: int, x1: int, y1: int, tile_size: int):
    """The tiles' corners in row-major order, each tile's center distance
    to the block's center and the jitter's scale: everything of
    ``tile_ordering`` but the draws, kept for the next frame of the same
    size (the per-tile norms take milliseconds of a 1080p frame's host time)."""
    center = ScreenBlock((x0, y0), (x1, y1)).center().astype(np.float64)
    ranges = tuple(
        (tx0, ty0, tx1, ty1)
        for (ty0, ty1) in divide_range(y0, y1, tile_size)
        for (tx0, tx1) in divide_range(x0, x1, tile_size)
    )
    distances = np.array(
        [float(np.linalg.norm(center - ScreenBlock((a, b), (c, d)).center())) for (a, b, c, d) in ranges], np.float64
    )
    distances.flags.writeable = False
    return ranges, distances, float(np.linalg.norm(center)) * 0.1
