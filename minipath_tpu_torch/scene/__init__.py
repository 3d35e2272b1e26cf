"""Scenes and renderable objects.

Mirrors the reference's ``scene`` module surface
(``minipath/src/scene/mod.rs``): a :class:`Scene` holds exactly one
renderable object. The one object the port renders so far is
:class:`~minipath_tpu_torch.scene.triangle_bvh.TriangleBvh`.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Scene:
    """A scene holding exactly one object (``scene/mod.rs:13-15``)."""

    object: object
