"""Triangle intersection and barycentric interpolation (device-side torch).

Port of ``minipath_tpu/geometry/triangle.py``: the reference's two-sided
Möller–Trumbore test (``minipath/src/geometry/triangle.rs:187-216``), with
no determinant epsilon (a zero determinant gives an infinite ``inv_det``
whose NaN products fail every comparison, so degenerate and padding
triangles are misses) and the mask ``u >= 0 & v >= 0 & u + v <= 1``,
vectorized over any leading batch dims. The traversal kernels carry their
own copy of the test; this one serves the portable engine
(``render/traversal.py``).
"""

from __future__ import annotations

import torch


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def moller_trumbore(v0, v1, v2, origin, direction):
    """Two-sided ray/triangle intersection.

    All args are ``(..., 3)`` and broadcast together. Returns ``(mask, t, u,
    v)`` with shape ``(...)``. ``t`` may be negative or non-finite where
    ``mask`` is False; callers clip with ``t >= 0`` and their own ``t_max``.
    """
    e1 = v1 - v0
    e2 = v2 - v0
    ray_cross_e2 = _cross(direction, e2)
    det = _dot(e1, ray_cross_e2)
    inv_det = 1.0 / det  # may be +-inf for degenerate triangles
    s = origin - v0
    u = inv_det * _dot(s, ray_cross_e2)
    s_cross_e1 = _cross(s, e1)
    v = inv_det * _dot(direction, s_cross_e1)
    t = inv_det * _dot(e2, s_cross_e1)
    mask = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return mask, t, u, v


def triangle_geometric_normal(v0, v1, v2):
    """Unnormalized geometric normal ``(v1 - v0) x (v2 - v0)``
    (``triangle.rs:141``'s orientation; shading uses ``|dot|``)."""
    return _cross(v1 - v0, v2 - v0)


def barycentric_interpolate(u, v, a, b, c):
    """Interpolate vertex attributes with barycentric ``(u, v)``: ``a`` gets
    weight ``1-u-v``, ``b`` weight ``u``, ``c`` weight ``v``
    (``triangle.rs:220-238``). ``u``/``v`` are ``(...)``, attributes
    ``(..., D)``."""
    w = 1.0 - u - v
    return a * w[..., None] + b * u[..., None] + c * v[..., None]
