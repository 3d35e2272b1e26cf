"""Scenes and renderable objects.

Mirrors the reference's ``scene`` module surface
(``minipath/src/scene/mod.rs``): a :class:`Scene` holds exactly one
renderable object: a
:class:`~minipath_tpu_torch.scene.triangle_bvh.TriangleBvh` or the analytic
:class:`~minipath_tpu_torch.scene.primitives.Sphere`. Objects implement
``intersect`` over batched rays plus ``get_bounding_box``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Scene:
    """A scene holding exactly one object (``scene/mod.rs:13-15``)."""

    object: object
