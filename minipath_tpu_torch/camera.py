"""Physical thin-lens camera.

The host-side :class:`Camera` keeps the reference's immutable builder API
(``minipath/src/camera.rs:54-121``): ``with_transform``,
``focus_distance``, ``sensor_width``/``sensor_height``, ``f_number``,
``look_at``, ``look_direction``, ``transformed``, ``build_sampler``. The
default is a 35 mm camera with a 50 mm f/9 lens looking along -Z and focused
at infinity (``camera.rs:42-52``). It is a NumPy copy of the JAX package's
builder.

The device side is :class:`CameraSampler`, precomputed constants as tensors
on one device, plus :func:`sample_rays`, which replaces the reference's
per-thread ``SmallRng`` sampling (``camera.rs:176-191``) with draws from a
``torch.Generator``. In the Sobol mode of :mod:`~minipath_tpu_torch.render.stratify`
no uniform is drawn, and every ray is a pure function of (pixel, sample,
seed).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from minipath_tpu_torch.geometry.ray import Rays, make_rays


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def look_at_inverse_rh(eye, target, up) -> np.ndarray:
    """Camera-to-world isometry for a right-handed look-at.

    Equivalent to the inverse of nalgebra's ``Isometry3::look_at_rh`` as used
    by the reference (``camera.rs:93-101``): the camera looks along its local
    -Z towards ``target``. Returns a 4x4 row-major matrix.
    """
    eye = np.asarray(eye, np.float64)
    forward = _normalize(np.asarray(target, np.float64) - eye)
    right = _normalize(np.cross(forward, np.asarray(up, np.float64)))
    true_up = np.cross(right, forward)
    m = np.eye(4)
    m[:3, 0] = right
    m[:3, 1] = true_up
    m[:3, 2] = -forward
    m[:3, 3] = eye
    return m


@dataclass(frozen=True)
class Camera:
    """Immutable camera description; builder methods return new cameras."""

    # 4x4 camera-to-world isometry (row-major, rotation + translation).
    camera_to_world: np.ndarray = None
    focus_distance_m: float = float("inf")
    # ("width"|"height", meters)
    sensor_size: tuple = ("height", 24e-3)
    focal_length: float = 50e-3
    f_number_value: float = 9.0

    def __post_init__(self):
        if self.camera_to_world is None:
            object.__setattr__(self, "camera_to_world", np.eye(4))

    # -- builder methods ----------------------------------------------------

    def with_transform(self, camera_to_world: np.ndarray) -> "Camera":
        return replace(self, camera_to_world=np.asarray(camera_to_world, np.float64))

    def focus_distance(self, focus_distance: float) -> "Camera":
        assert focus_distance >= 0.0
        return replace(self, focus_distance_m=float(focus_distance))

    def sensor_width(self, sensor_width: float) -> "Camera":
        assert sensor_width > 0.0
        return replace(self, sensor_size=("width", float(sensor_width)))

    def sensor_height(self, sensor_height: float) -> "Camera":
        assert sensor_height > 0.0
        return replace(self, sensor_size=("height", float(sensor_height)))

    def f_number(self, f_number: float) -> "Camera":
        assert f_number > 0.0
        return replace(self, f_number_value=float(f_number))

    def look_at(self, center, look_at, up=(0.0, 1.0, 0.0)) -> "Camera":
        """Look from ``center`` to ``look_at`` and focus at ``look_at``."""
        m = look_at_inverse_rh(center, look_at, up)
        dist = float(np.linalg.norm(np.asarray(look_at, np.float64) - np.asarray(center, np.float64)))
        return replace(self, camera_to_world=m, focus_distance_m=dist)

    def look_direction(self, center, forward, up=(0.0, 1.0, 0.0)) -> "Camera":
        center = np.asarray(center, np.float64)
        m = look_at_inverse_rh(center, center + np.asarray(forward, np.float64), up)
        return replace(self, camera_to_world=m)

    def transformed(self, transform: np.ndarray) -> "Camera":
        """Apply ``transform`` (4x4) on top of the current camera frame."""
        return self.with_transform(np.asarray(transform, np.float64) @ self.camera_to_world)

    # -- frame and sampler ----------------------------------------------------

    def center_forward_up_right(self):
        m = self.camera_to_world
        center = m[:3, 3].copy()
        forward = m[:3, :3] @ np.array([0.0, 0.0, -1.0])
        up = m[:3, :3] @ np.array([0.0, 1.0, 0.0])
        right = m[:3, :3] @ np.array([1.0, 0.0, 0.0])
        return center, forward, up, right

    def build_sampler(self, resolution, device) -> "CameraSampler":
        """Precompute per-render constants (``camera.rs:123-146``) on
        ``device``. ``resolution`` is ``(width, height)`` in pixels."""
        center, forward, up, right = self.center_forward_up_right()
        res = np.asarray(resolution, np.float64)
        kind, value = self.sensor_size
        pixel_scale = value / (res[0] if kind == "width" else res[1])

        film_origin_uv = (res - 1.0) * pixel_scale / 2.0
        film_origin_offset = (
            -forward * self.focal_length
            + right * film_origin_uv[0]
            - up * film_origin_uv[1]
        )
        return CameraSampler.from_numpy(
            dict(
                center=center,
                up=up,
                right=right,
                film_origin_offset=film_origin_offset,
                pixel_scale=pixel_scale,
                lens_radius=self.focal_length / (2.0 * self.f_number_value),
                lens_weight=self.focal_length / self.focus_distance_m,
            ),
            device,
        )


class CameraSampler(NamedTuple):
    """Precomputed camera sampling constants: float32 tensors on one device."""

    center: torch.Tensor  # (3,)
    up: torch.Tensor  # (3,) unit
    right: torch.Tensor  # (3,) unit
    film_origin_offset: torch.Tensor  # (3,)
    pixel_scale: torch.Tensor  # () distance between pixels, meters
    lens_radius: torch.Tensor  # () meters
    lens_weight: torch.Tensor  # () focal_length / focus_distance

    @classmethod
    def from_numpy(cls, fields, device) -> "CameraSampler":
        """A sampler on ``device`` from a mapping of field name to
        array-like, each rounded to float32 (the JAX package's
        ``CameraSampler._asdict()`` works as it is)."""
        return cls(
            **{
                name: torch.from_numpy(
                    np.array(fields[name], np.float32, copy=True)
                ).to(device)
                for name in cls._fields
            }
        )

    @property
    def device(self) -> torch.device:
        return self.center.device


def sample_rays(
    sampler: CameraSampler,
    pixel_xy: torch.Tensor,
    generator: torch.Generator | None,
    strat=None,
) -> Rays:
    """Sample one camera ray per pixel coordinate.

    ``pixel_xy`` is ``(..., 2)`` pixel coordinates on the sampler's device.
    Implements the reference sampling (``camera.rs:176-191``): +-0.5 px
    box-filter jitter on the film, a uniform-disc lens sample scaled by
    ``lens_radius``, and depth of field via ``lens_vector * lens_weight -
    film_point_offset``.

    ``strat`` is ``None`` (iid dimensions drawn from ``generator``, which
    must live on the sampler's device) or ``(s, pid, spp, salt)``: per-lane
    sample-index and pixel-id integer tensors plus ``spp`` and ``salt``
    ints, in which case the film jitter and the lens sample draw from
    per-pixel jittered strata (:mod:`minipath_tpu_torch.render.stratify`).
    A negative ``spp`` selects Owen-scrambled Sobol points; no uniform is
    drawn then and ``generator`` may be None.
    """
    from minipath_tpu_torch.render.stratify import strat2d

    pixel_xy = pixel_xy.to(torch.float32)
    batch_shape = pixel_xy.shape[:-1]
    sobol = strat is not None and strat[2] < 0

    def uniforms():
        if sobol:
            return None, None
        u = torch.rand(
            batch_shape + (2,), generator=generator, device=pixel_xy.device
        )
        return u[..., 0], u[..., 1]

    j0, j1 = uniforms()
    if strat is not None:
        s_idx, pid, spp, salt = strat
        j0, j1 = strat2d(j0, j1, s_idx, pid, spp, salt + 0)
    film_u = pixel_xy[..., 0:1] + (j0[..., None] - 0.5)
    film_v = pixel_xy[..., 1:2] + (j1[..., None] - 0.5)

    # Uniform sample on the unit disc (polar method).
    u0, u1 = uniforms()
    if strat is not None:
        u0, u1 = strat2d(u0, u1, s_idx, pid, spp, salt + 1)
    r = torch.sqrt(u0)
    theta = 2.0 * torch.pi * u1
    lens_u = r * torch.cos(theta)
    lens_v = r * torch.sin(theta)

    up = sampler.up
    right = sampler.right
    film_point_offset = (
        sampler.film_origin_offset
        + up * (film_v * sampler.pixel_scale)
        - right * (film_u * sampler.pixel_scale)
    )
    lens_vector = (
        right * (sampler.lens_radius * lens_u)[..., None]
        + up * (sampler.lens_radius * lens_v)[..., None]
    )
    direction = lens_vector * sampler.lens_weight - film_point_offset
    return make_rays(sampler.center + lens_vector, direction)
