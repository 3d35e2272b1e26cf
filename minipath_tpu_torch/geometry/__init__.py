"""Geometry core: rays and host-side AABBs.

Device-side code is plain torch functions over SoA tensors; the ray/box and
ray/triangle tests live in the traversal kernel (``render/kernels.py``).
"""

from minipath_tpu_torch.geometry.aabb import AABB
from minipath_tpu_torch.geometry.ray import Rays, make_rays

__all__ = ["AABB", "Rays", "make_rays"]
