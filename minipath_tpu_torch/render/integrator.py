"""Integrators: how a camera sample becomes a color.

The parity integrator reproduces the reference worker
(``minipath/src/renderer/worker.rs:51-65``): cast a camera ray, shade hits
as grayscale ``|ray_dir . normal|`` with alpha 1, misses as transparent
black. Port of the batched-tile renderers
``minipath_tpu/render/integrator.py::render_tile_batch_bvh_pallas`` and
``render_tile_batch_sphere`` (the analytic sphere, which launches no
kernel), and of the portable one, ``render_tile_sum_bvh`` with
``render_tile_batch_bvh_xla`` (:func:`render_tile_batch_bvh_portable`,
over ``render/traversal.py``); they operate on whole batches of tiles, each
cut into pixel packets. The three share one body (the camera rays, the
shading of ``render/frame.py::shade_parity_sum`` and the sum over the
samples) and differ only in their trace; the body records its ray
generation, trace and shading as the spans ``render.ray_gen``,
``render.trace`` and ``render.shade``.
"""

from __future__ import annotations

import torch

from minipath_tpu_torch.camera import CameraSampler, sample_rays
from minipath_tpu_torch.geometry.ray import Rays
from minipath_tpu_torch.parallel import map_shards
from minipath_tpu_torch.render.frame import CAMERA_SALT, packet_rays9, rays9_to_rays, shade_parity_sum, uses_camera_kernel
from minipath_tpu_torch.render.kernels import KernelScene, rays_to_rays9
from minipath_tpu_torch.render.kernels_q import QuantizedScene, trace_scene
from minipath_tpu_torch.render.traversal import intersect_bvh
from minipath_tpu_torch.scene.bvh.build import BvhArrays
from minipath_tpu_torch.utils.profiling import span


def tile_pixel_packets(tile_origin, tile_shape, packet_shape, device) -> torch.Tensor:
    """Pixel coordinates of a tile grouped into coherent ray packets.

    Returns ``(n_packets, P, 2)`` float32 (x, y) coordinates on ``device``,
    each packet a ``packet_shape`` pixel block (``screen_block.rs:104-128``
    iterates pixels one by one instead).
    """
    th, tw = tile_shape
    ph, pw = packet_shape
    assert th % ph == 0 and tw % pw == 0, (tile_shape, packet_shape)
    gy, gx = torch.meshgrid(
        torch.arange(th, device=device), torch.arange(tw, device=device), indexing="ij"
    )
    pix = torch.stack([gx, gy], dim=-1)  # (th, tw, 2) as (x, y)
    pix = pix.reshape(th // ph, ph, tw // pw, pw, 2)
    pix = pix.permute(0, 2, 1, 3, 4).reshape(-1, ph * pw, 2)
    origin = torch.as_tensor(tile_origin, dtype=torch.float32, device=device)
    return pix.to(torch.float32) + origin


def unpack_tile(values: torch.Tensor, tile_shape, packet_shape) -> torch.Tensor:
    """Inverse of :func:`tile_pixel_packets` for per-pixel values
    ``(..., n_packets, P, C)`` -> ``(..., th, tw, C)``."""
    th, tw = tile_shape
    ph, pw = packet_shape
    lead = values.shape[:-3]
    c = values.shape[-1]
    v = values.reshape(*lead, th // ph, tw // pw, ph, pw, c)
    n = len(lead)
    v = v.permute(*range(n), n, n + 2, n + 1, n + 3, n + 4)
    return v.reshape(*lead, th, tw, c)


def film_strat(pix: torch.Tensor, spp: int, s_idx: torch.Tensor, strat_seed: int):
    """Stratification tuple for :func:`sample_rays` on integer pixel
    coordinates ``pix (..., 2)``: the per-pixel id packs (y, x) into one
    int (frames up to 16384 px wide), XORed with the pass's seed so the
    stratum pairings re-randomize per pass."""
    pid = (pix[..., 1].to(torch.int64) << 14) | (pix[..., 0].to(torch.int64) & 0x3FFF)
    return (s_idx, pid ^ strat_seed, spp, CAMERA_SALT)


def tile_batch_rays(
    sampler: CameraSampler,
    tile_origins: torch.Tensor,  # (K, 2) f32 pixel origins
    generator: torch.Generator,
    strat_seed: int,
    *,
    tile_shape,
    packet_shape,
    spp: int,
) -> Rays:
    """Camera rays of K tiles, fields ``(K*nb, spp*bp, 3)``: one packet per
    pixel block of ``packet_shape`` (``bp`` pixels, ``nb`` blocks per tile),
    its samples sample-major and stratified per pixel over ``spp``."""
    dev = sampler.device
    K = tile_origins.shape[0]
    base = tile_pixel_packets((0.0, 0.0), tile_shape, packet_shape, dev)  # (nb, bp, 2)
    nb, bp = base.shape[:2]
    pix = base[None] + tile_origins.to(dev)[:, None, None, :]  # (K, nb, bp, 2)
    pix = pix.reshape(K * nb, bp, 2).repeat(1, spp, 1)  # sample-major (K*nb, spp*bp, 2)
    s_row = torch.arange(spp * bp, device=dev) // bp
    strat = film_strat(pix, spp, s_row.expand(K * nb, -1), strat_seed)
    return sample_rays(sampler, pix, generator, strat=strat)


def tile_packet_origins(tile_origins: torch.Tensor, tile_shape, packet_shape, device) -> torch.Tensor:
    """The first pixel (x, y) of each packet of :func:`tile_batch_rays`:
    ``(K*nb, 2)`` int32 on ``device``, tile by tile, the packets of a tile
    in :func:`tile_pixel_packets`' order. Made on ``device`` from the
    integral ``tile_origins``, with no host copy."""
    (th, tw), (ph, pw) = tile_shape, packet_shape
    k = torch.arange((th // ph) * (tw // pw), dtype=torch.int32, device=device)
    offsets = torch.stack([k % (tw // pw) * pw, k // (tw // pw) * ph], dim=-1)  # (nb, 2)
    return (tile_origins.to(device, torch.int32)[:, None, :] + offsets).reshape(-1, 2)


def tile_batch_rays9(sampler, tile_origins, generator, strat_seed, *, tile_shape, packet_shape, spp) -> torch.Tensor:
    """:func:`tile_batch_rays` packed for the kernels, ``(K*nb, 9,
    spp*bp)``. On a card, one launch of the camera-ray kernel
    (:func:`~minipath_tpu_torch.render.frame.packet_rays9`) makes the same
    rays from the packets' first pixels, with :func:`film_strat`'s pixel id
    ``(y << 14) | (x & 0x3FFF)``."""
    if uses_camera_kernel(sampler.device):
        origins = tile_packet_origins(tile_origins, tile_shape, packet_shape, sampler.device)
        return packet_rays9(
            sampler, origins, generator, px_block=packet_shape, samples=spp, strat_spp=spp, strat_offset=0,
            strat_seed=strat_seed, row_stride=1 << 14, x_mask=0x3FFF,
        )
    rays = tile_batch_rays(
        sampler, tile_origins, generator, strat_seed, tile_shape=tile_shape, packet_shape=packet_shape, spp=spp
    )
    return rays_to_rays9(rays)


def _render_tile_batch(
    trace, scene, sampler, tile_origins, generator, strat_seed, *, tile_shape, packet_shape, spp, mesh
) -> torch.Tensor:
    """The tile integrators' one body: the rays of K tiles
    (:func:`tile_batch_rays9`), ``trace(rays9, scene) -> (normal, hit)``
    over them, :func:`~minipath_tpu_torch.render.frame.shade_parity_sum`
    and the sum over the samples. Returns ``(K, th, tw, 4)`` RGBA sums.

    With a ``mesh`` (a sequence of devices), ``scene`` is a list of the
    scene's replicas parallel to it (``parallel.replicate``): the rays are
    made on ``mesh[0]`` exactly as without a mesh, each device traces and
    shades a contiguous share of the packets, and the image is the same bit
    for bit."""
    K = tile_origins.shape[0]
    with span("render.ray_gen"):
        rays9 = tile_batch_rays9(
            sampler, tile_origins, generator, strat_seed,
            tile_shape=tile_shape, packet_shape=packet_shape, spp=spp,
        )
    nb, bp = rays9.shape[0] // K, rays9.shape[2] // spp

    def trace_shade(rays9, scene):
        with span("render.trace"):
            normal, hit = trace(rays9, scene)
        with span("render.shade"):
            return shade_parity_sum(rays9_to_rays(rays9).direction, normal, hit, spp)  # (packets, bp, 4)

    rgba_sum = trace_shade(rays9, scene) if mesh is None else map_shards(trace_shade, rays9, mesh, scene)
    with span("render.shade"):
        return unpack_tile(rgba_sum.reshape(K, nb, bp, 4), tile_shape, packet_shape)


def render_tile_batch_sphere(
    sphere,
    sampler: CameraSampler,
    tile_origins: torch.Tensor,  # (K, 2) f32 pixel origins
    generator: torch.Generator,
    strat_seed: int,
    *,
    tile_shape,
    packet_shape,
    spp: int,
    mesh=None,
) -> torch.Tensor:
    """Batched-tile renderer of the analytic sphere
    (``scene/primitives.py``): the rays of :func:`render_tile_batch_bvh`,
    intersected by ``sphere.intersect``. Returns ``(K, th, tw, 4)`` RGBA
    sums over ``spp`` samples. ``mesh`` as in :func:`render_tile_batch_bvh`."""

    def trace(rays9, sphere):
        hits = sphere.intersect(rays9_to_rays(rays9))
        return hits.normal, hits.hit

    return _render_tile_batch(
        trace, sphere, sampler, tile_origins, generator, strat_seed,
        tile_shape=tile_shape, packet_shape=packet_shape, spp=spp, mesh=mesh,
    )


def render_tile_batch_bvh(
    scene: KernelScene | QuantizedScene,
    sampler: CameraSampler,
    tile_origins: torch.Tensor,  # (K, 2) f32 pixel origins
    generator: torch.Generator,
    strat_seed: int,
    *,
    tile_shape,
    packet_shape,
    spp: int,
    stack_size: int,
    mesh=None,
) -> torch.Tensor:
    """Batched-tile renderer: K tiles in one trace by ``trace_scene`` (K1,
    or K3 over a :class:`QuantizedScene`). Returns ``(K, th, tw, 4)`` RGBA
    sums over ``spp`` samples, stratified per pixel over them. With a
    ``mesh``, ``scene`` is a list of the scene's replicas parallel to it
    (:func:`_render_tile_batch`)."""

    def trace(rays9, scene):
        kh = trace_scene(scene, rays9, stack_size=stack_size)
        return kh.normal, kh.tri >= 0

    return _render_tile_batch(
        trace, scene, sampler, tile_origins, generator, strat_seed,
        tile_shape=tile_shape, packet_shape=packet_shape, spp=spp, mesh=mesh,
    )


def render_tile_batch_bvh_portable(
    arrays: BvhArrays,
    sampler: CameraSampler,
    tile_origins: torch.Tensor,  # (K, 2) f32 pixel origins
    generator: torch.Generator,
    strat_seed: int,
    *,
    tile_shape,
    packet_shape,
    spp: int,
    stack_size: int,
    mesh=None,
) -> torch.Tensor:
    """:func:`render_tile_batch_bvh` over the portable engine: the same rays
    (the same generator draws and strata), traced by
    ``render/traversal.py::intersect_bvh`` over the f32 tree ``arrays`` in
    packets of one sample of one pixel block. It shares no traversal code
    with the kernels, so it checks them; each traversal step makes one host
    sync. Returns the ``(K, th, tw, 4)`` RGBA sums. With a ``mesh``,
    ``arrays`` is a list of the tree's replicas parallel to it."""

    def trace(rays9, arrays):
        B, _, P = rays9.shape
        packets = Rays(*(f.reshape(-1, P // spp, 3) for f in rays9_to_rays(rays9)))  # (B * spp, bp, 3)
        hits = intersect_bvh(arrays, packets, stack_size=stack_size)
        return hits.normal.reshape(B, P, 3), hits.hit.reshape(B, P)

    return _render_tile_batch(
        trace, arrays, sampler, tile_origins, generator, strat_seed,
        tile_shape=tile_shape, packet_shape=packet_shape, spp=spp, mesh=mesh,
    )
