"""Scenes and renderable objects.

Mirrors the reference's ``scene`` module surface
(``minipath/src/scene/mod.rs``): a :class:`Scene` holds exactly one
renderable object: a
:class:`~minipath_tpu_torch.scene.triangle_bvh.TriangleBvh` or the analytic
:class:`~minipath_tpu_torch.scene.primitives.Sphere`. Objects implement
the :class:`Object` protocol: ``intersect`` over batched rays plus
``get_bounding_box``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, runtime_checkable

from minipath_tpu_torch.geometry.aabb import AABB


@runtime_checkable
class Object(Protocol):
    """Renderable object (the batched ``Object`` trait of ``scene/mod.rs:7-10``)."""

    def intersect(self, rays, t_max):
        """Closest-hit intersection over a batch of rays; returns
        :class:`minipath_tpu_torch.render.hit.HitRecords`."""
        ...

    def get_bounding_box(self) -> AABB: ...


@dataclass
class Scene:
    """A scene holding exactly one object (``scene/mod.rs:13-15``)."""

    object: Object
