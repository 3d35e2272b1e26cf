"""Rays as structure-of-arrays tensors.

Semantics follow the reference ``Ray`` type
(``minipath/src/geometry/mod.rs:34-67``): direction is normalized, and
``inv_direction`` maps zero direction components to +infinity regardless of
the sign of the zero.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Rays(NamedTuple):
    """A batch of rays in SoA layout. All fields have shape ``(..., 3)``."""

    origin: torch.Tensor
    direction: torch.Tensor  # normalized
    inv_direction: torch.Tensor  # 1/direction with 0 -> +inf


def make_rays(origin: torch.Tensor, direction: torch.Tensor) -> Rays:
    """Build rays from (unnormalized) float32 directions.

    Zero direction components invert to +inf, ``+0.0`` and ``-0.0`` alike,
    matching the reference constructor (``geometry/mod.rs:45-54``).
    """
    origin = origin.to(torch.float32)
    direction = direction.to(torch.float32)
    norm = torch.sqrt(torch.sum(direction * direction, dim=-1, keepdim=True))
    direction = direction / norm
    inv = torch.where(
        direction == 0.0, torch.full_like(direction, torch.inf), 1.0 / direction
    )
    return Rays(origin=origin, direction=direction, inv_direction=inv)


def point_at(rays: Rays, t) -> torch.Tensor:
    """Point along the ray at parameter ``t`` (shape ``(...,)``)."""
    t = torch.as_tensor(t, dtype=rays.origin.dtype, device=rays.origin.device)
    return rays.origin + rays.direction * t[..., None]


def advance_by(rays: Rays, distance) -> Rays:
    """New rays moved ``distance`` along their direction (same direction)."""
    return Rays(origin=point_at(rays, distance), direction=rays.direction, inv_direction=rays.inv_direction)
