"""Axis-aligned bounding boxes.

:class:`AABB` is a small generic host-side min/max box over NumPy points of
any dimension/dtype, used by the BVH builder and by 2-D screen blocks. It
mirrors the combinator surface of the reference's generic ``AABB``
(``minipath/src/geometry/aabb.rs:20-252``). The device-side ray/box slab
test lives inside the traversal kernel (``render/kernels.py``).
"""

from __future__ import annotations

import numpy as np


class AABB:
    """Generic min/max axis-aligned box over NumPy coordinate arrays."""

    __slots__ = ("min", "max")

    def __init__(self, min_point, max_point):
        self.min = np.asarray(min_point)
        self.max = np.asarray(max_point)

    # -- constructors -----------------------------------------------------

    @classmethod
    def with_size(cls, origin, size) -> "AABB":
        origin = np.asarray(origin)
        return cls(origin, origin + np.asarray(size))

    @classmethod
    def from_points(cls, points) -> "AABB | None":
        """Smallest box containing all points (``(N, D)`` array), or None."""
        points = np.asarray(points)
        if points.size == 0:
            return None
        return cls(points.min(axis=0), points.max(axis=0))

    def copy(self) -> "AABB":
        return AABB(self.min.copy(), self.max.copy())

    # -- queries -----------------------------------------------------------

    def size(self):
        return self.max - self.min

    def center(self):
        return (self.min + self.max) / 2

    def is_empty(self) -> bool:
        return not bool(np.all(self.min < self.max))

    def contains_point(self, p) -> bool:
        p = np.asarray(p)
        return bool(np.all(p >= self.min) and np.all(p < self.max))

    def contains_box(self, other: "AABB") -> bool:
        return bool(np.all(other.min >= self.min) and np.all(other.max <= self.max))

    def volume(self) -> float:
        if self.is_empty():
            return 0.0
        return float(np.prod(self.size()))

    def surface_area(self) -> float:
        s = self.size()
        if len(s) == 2:
            return float(np.prod(s))
        return float(2.0 * (s[0] * (s[1] + s[2]) + s[1] * s[2]))

    # -- combinators --------------------------------------------------------

    def union(self, other: "AABB") -> "AABB":
        return AABB(np.minimum(self.min, other.min), np.maximum(self.max, other.max))

    def intersection(self, other: "AABB") -> "AABB":
        return AABB(np.maximum(self.min, other.min), np.minimum(self.max, other.max))

    def extend_point(self, p) -> None:
        p = np.asarray(p)
        self.min = np.minimum(self.min, p)
        self.max = np.maximum(self.max, p)

    def extend_points(self, points) -> None:
        points = np.asarray(points)
        if points.size:
            self.min = np.minimum(self.min, points.min(axis=0))
            self.max = np.maximum(self.max, points.max(axis=0))

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, AABB)
            and np.array_equal(self.min, other.min)
            and np.array_equal(self.max, other.max)
        )

    def __repr__(self) -> str:
        return f"AABB(min={self.min.tolist()}, max={self.max.tolist()})"
