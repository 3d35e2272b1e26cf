"""Axis-aligned bounding boxes.

Two layers, as in ``minipath_tpu/geometry/aabb.py``:

* :class:`AABB`, a small generic host-side min/max box over NumPy points of
  any dimension/dtype, used by the BVH builder and by 2-D screen blocks. It
  mirrors the combinator surface of the reference's generic ``AABB``
  (``minipath/src/geometry/aabb.rs:20-252``).
* :func:`slab_test`, the vectorized ray/box slab test in torch, with the
  reference's NaN handling for degenerate slabs (``aabb.rs:254-284``). The
  portable engine (``render/traversal.py``) uses it; the traversal kernels
  carry their own NaN-free variant (``1/d`` clamped to +-1e30).
"""

from __future__ import annotations

import numpy as np
import torch


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


def slab_test(box_min, box_max, origin, inv_direction, t_clip):
    """Vectorized ray/AABB slab test.

    Broadcasts over leading dims; the coordinate axis is the last one.
    Returns ``(t1, t2)`` with the semantics of the reference test
    (``aabb.rs:254-284``): componentwise distances with NaNs (ray origin on a
    degenerate slab) replaced by -inf for the near plane and +inf for the far
    plane, ``t1`` clamped below by 0 and ``t2`` above by ``t_clip`` (a scalar
    or a broadcastable tensor). The box intersects iff ``t1 <= t2``.
    """
    to_min = (box_min - origin) * inv_direction
    to_max = (box_max - origin) * inv_direction
    to_min = torch.where(torch.isnan(to_min), -torch.inf, to_min)
    to_max = torch.where(torch.isnan(to_max), torch.inf, to_max)
    cmin = torch.minimum(to_min, to_max)
    cmax = torch.maximum(to_min, to_max)
    t1 = torch.clamp(cmin.amax(dim=-1), min=0.0)
    t2 = torch.minimum(cmax.amin(dim=-1), torch.as_tensor(t_clip, dtype=cmax.dtype, device=cmax.device))
    return t1, t2
