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
cut into pixel packets.
"""

from __future__ import annotations

import torch

from minipath_tpu_torch.camera import CameraSampler, sample_rays
from minipath_tpu_torch.geometry.ray import Rays
from minipath_tpu_torch.parallel import map_shards
from minipath_tpu_torch.render.frame import CAMERA_SALT, shade_parity_sum
from minipath_tpu_torch.render.hit import HitRecords
from minipath_tpu_torch.render.kernels import KernelScene, rays_to_rays9
from minipath_tpu_torch.render.kernels_q import QuantizedScene, trace_scene
from minipath_tpu_torch.render.traversal import intersect_bvh
from minipath_tpu_torch.scene.bvh.build import BvhArrays


def shade_normal_dot(rays: Rays, hits: HitRecords) -> torch.Tensor:
    """Grayscale ``|d . n|`` shading with alpha, transparent miss
    (``worker.rs:59-64``). Returns RGBA ``(..., 4)``."""
    dot = torch.abs(torch.sum(rays.direction * hits.normal, dim=-1))
    rgba = torch.stack([dot, dot, dot, torch.ones_like(dot)], dim=-1)
    return torch.where(hits.hit[..., None], rgba, torch.zeros_like(rgba))


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


def tile_batch_rays9(sampler, tile_origins, generator, strat_seed, **shape) -> torch.Tensor:
    """:func:`tile_batch_rays` packed for the kernels, ``(K*nb, 9,
    spp*bp)``."""
    return rays_to_rays9(tile_batch_rays(sampler, tile_origins, generator, strat_seed, **shape))


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
    intersected by ``sphere.intersect`` and shaded by
    :func:`shade_normal_dot`. Returns ``(K, th, tw, 4)`` RGBA sums over
    ``spp`` samples. ``mesh`` as in :func:`render_tile_batch_bvh`."""
    K = tile_origins.shape[0]
    rays = tile_batch_rays(
        sampler, tile_origins, generator, strat_seed,
        tile_shape=tile_shape, packet_shape=packet_shape, spp=spp,
    )
    nb, bp = rays.origin.shape[0] // K, rays.origin.shape[1] // spp

    def shade_sum(rays):
        rgba = shade_normal_dot(rays, sphere.intersect(rays))  # (packets, spp*bp, 4)
        return rgba.reshape(-1, spp, bp, 4).sum(dim=1)

    rgba_sum = shade_sum(rays) if mesh is None else map_shards(shade_sum, rays, mesh)
    return unpack_tile(rgba_sum.reshape(K, nb, bp, 4), tile_shape, packet_shape)


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
    """Batched-tile renderer: K tiles in one trace. Returns ``(K, th, tw,
    4)`` RGBA sums over ``spp`` samples, stratified per pixel over them.

    With a ``mesh`` (a sequence of devices), ``scene`` is a list of the
    scene's replicas parallel to it (``parallel.replicate``): the rays are
    made on ``mesh[0]`` exactly as without a mesh, each device traces and
    shades a contiguous share of the packets, and the image is the same bit
    for bit."""
    K = tile_origins.shape[0]
    rays9 = tile_batch_rays9(
        sampler, tile_origins, generator, strat_seed,
        tile_shape=tile_shape, packet_shape=packet_shape, spp=spp,
    )
    nb, bp = rays9.shape[0] // K, rays9.shape[2] // spp

    def trace_shade(rays9, scene):
        return shade_parity_sum(rays9, trace_scene(scene, rays9, stack_size=stack_size), spp)  # (packets, bp, 4)

    rgba_sum = trace_shade(rays9, scene) if mesh is None else map_shards(trace_shade, rays9, mesh, scene)
    return unpack_tile(rgba_sum.reshape(K, nb, bp, 4), tile_shape, packet_shape)


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
    packets of one sample of one pixel block, shaded by
    :func:`shade_normal_dot`. It shares no traversal code with the kernels,
    so it checks them; each traversal step makes one host sync. Returns the
    ``(K, th, tw, 4)`` RGBA sums. With a ``mesh``, ``arrays`` is a list of
    the tree's replicas parallel to it, and each device traces a contiguous
    share of the packets: the image is the same bit for bit."""
    K = tile_origins.shape[0]
    rays = tile_batch_rays(
        sampler, tile_origins, generator, strat_seed,
        tile_shape=tile_shape, packet_shape=packet_shape, spp=spp,
    )
    nb, bp = rays.origin.shape[0] // K, rays.origin.shape[1] // spp

    def trace_shade(rays, arrays):
        packets = Rays(*(f.reshape(-1, bp, 3) for f in rays))  # (packets * spp, bp, 3), sample-major
        rgba = shade_normal_dot(packets, intersect_bvh(arrays, packets, stack_size=stack_size))
        return rgba.reshape(-1, spp, bp, 4).sum(dim=1)

    rgba_sum = trace_shade(rays, arrays) if mesh is None else map_shards(trace_shade, rays, mesh, arrays)
    return unpack_tile(rgba_sum.reshape(K, nb, bp, 4), tile_shape, packet_shape)
