"""Analytic primitives.

Port of ``minipath_tpu/scene/primitives.py`` (counterpart of
``minipath/src/scene/primitives.rs``): a :class:`Sphere` with the same
quadratic near/far root selection (``primitives.rs:16-47``), vectorized over
ray batches. It launches no kernel: a few elementwise torch ops on the rays'
device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from minipath_tpu_torch.geometry.aabb import AABB
from minipath_tpu_torch.render.hit import HitRecords


@dataclass(frozen=True)
class Sphere:
    center: tuple = (0.0, 0.0, 0.0)
    radius: float = 1.0
    material: int = 0

    def intersect(self, rays, t_max=math.inf) -> HitRecords:
        """Closest intersection: near root if >= 0, else far root if >= 0,
        else miss (matching ``primitives.rs:16-47``). The records live on
        the rays' device."""
        dev = rays.origin.device
        center = torch.tensor(self.center, dtype=torch.float32, device=dev)
        oc = rays.origin - center
        # direction is normalized => a == 1
        half_b = torch.sum(oc * rays.direction, dim=-1)
        c = torch.sum(oc * oc, dim=-1) - self.radius * self.radius
        disc = half_b * half_b - c
        sqrt_disc = torch.sqrt(torch.clamp(disc, min=0.0))
        t_near = -half_b - sqrt_disc
        t_far = -half_b + sqrt_disc
        t = torch.where(t_near >= 0.0, t_near, t_far)
        hit = (disc >= 0.0) & (t >= 0.0) & (t < t_max)
        t = torch.where(hit, t, torch.full_like(t, torch.inf))
        point = rays.origin + rays.direction * torch.where(hit, t, torch.zeros_like(t))[..., None]
        normal = (point - center) / self.radius
        batch = rays.origin.shape[:-1]
        return HitRecords(
            hit=hit,
            t=t,
            point=point,
            normal=normal,
            material=torch.full(batch, self.material, dtype=torch.int32, device=dev),
            texture_coords=torch.zeros(batch + (3,), dtype=torch.float32, device=dev),
        )

    def get_bounding_box(self) -> AABB:
        c = np.asarray(self.center, np.float32)
        r = np.float32(self.radius)
        return AABB(c - r, c + r)
