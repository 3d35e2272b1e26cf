"""Geometry core: rays, host-side AABBs, and the torch slab and
Möller–Trumbore tests of the portable traversal engine.

Device-side code is plain torch functions over SoA tensors; the traversal
kernels (``render/kernels.py``) carry their own copies of both tests.
"""

from minipath_tpu_torch.geometry.aabb import AABB, slab_test
from minipath_tpu_torch.geometry.ray import Rays, make_rays
from minipath_tpu_torch.geometry.triangle import barycentric_interpolate, moller_trumbore, triangle_geometric_normal

# Error tolerance for general purpose calculations in the raytracer
# (``minipath/src/geometry/mod.rs:15``).
EPSILON = 1e-6

__all__ = [
    "AABB",
    "EPSILON",
    "Rays",
    "barycentric_interpolate",
    "make_rays",
    "moller_trumbore",
    "slab_test",
    "triangle_geometric_normal",
]
