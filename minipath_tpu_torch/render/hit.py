"""Hit records as structure-of-arrays tensors.

Port of ``minipath_tpu/render/hit.py``: the batched counterpart of the
reference ``HitRecord`` (``minipath/src/geometry/mod.rs:71-80``), with one
extra ``hit`` mask field in place of Rust's ``Option``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class HitRecords(NamedTuple):
    """Batched hit records; all fields share leading batch dims."""

    hit: torch.Tensor  # (...) bool
    t: torch.Tensor  # (...) f32 distance along the ray, inf on a miss
    point: torch.Tensor  # (..., 3)
    normal: torch.Tensor  # (..., 3) normalized
    material: torch.Tensor  # (...) i32
    texture_coords: torch.Tensor  # (..., 3)


def miss_records(batch_shape, device="cpu") -> HitRecords:
    batch_shape = tuple(batch_shape)
    f32 = dict(dtype=torch.float32, device=device)
    return HitRecords(
        hit=torch.zeros(batch_shape, dtype=torch.bool, device=device),
        t=torch.full(batch_shape, torch.inf, **f32),
        point=torch.zeros(batch_shape + (3,), **f32),
        normal=torch.zeros(batch_shape + (3,), **f32),
        material=torch.zeros(batch_shape, dtype=torch.int32, device=device),
        texture_coords=torch.zeros(batch_shape + (3,), **f32),
    )
