"""Whole-frame rendering on the portable engine, on one device or over a mesh.

Port of ``minipath_tpu/parallel/mesh.py``. The frame's pixels are grouped
into coherent packets (``frame_pixel_packets``, or multi-sample packets,
``frame_pixel_packets_ms``) and traced by the portable engine
(``render/traversal.py``), one sample of every packet per step, summed on
the device. Over a mesh (:mod:`minipath_tpu_torch.parallel`) the packets are
split: the scene and sampler replicated once per distinct device, the
packets in contiguous ranges, one generator per shard. The engine makes a
host sync per traversal step: these functions are an oracle and a test of
the mesh machinery, not a render path; the kernel renderers take the same
``mesh=`` argument (``render/frame.py::render_frame``,
``render/wavefront.py::render_frame_pt``).

``gen_rays9_blocks`` and ``gen_frame_rays9`` of the JAX module live in
``render/frame.py``; ``unpack_frame`` is re-exported from there.
"""

from __future__ import annotations

import torch

from minipath_tpu_torch.camera import CameraSampler, sample_rays
from minipath_tpu_torch.parallel import make_device_mesh, map_shards, replicate, shard_generators
from minipath_tpu_torch.render.frame import shade_parity_sum, unpack_frame
from minipath_tpu_torch.render.traversal import finalize_hits, trace_packets
from minipath_tpu_torch.scene.bvh.build import BvhArrays

__all__ = [
    "PACKET_SHAPE",
    "frame_pixel_packets",
    "frame_pixel_packets_ms",
    "make_device_mesh",
    "make_sharded_renderer",
    "render_frame_sum",
    "render_packets_sum",
    "unpack_frame",
    "unpack_frame_ms",
]

PACKET_SHAPE = (16, 16)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def frame_pixel_packets(width: int, height: int, packet_shape=PACKET_SHAPE, pad_packets_to: int = 1, device="cpu"):
    """Full-frame pixel coordinates grouped into coherent packets.

    Returns ``(pixels, (ph_count, pw_count))`` where pixels is ``(n_packets,
    P, 2)`` float32 (x, y) on ``device``; the frame is padded up to packet
    multiples, and optionally to a multiple of ``pad_packets_to`` packets
    with copies of the last packet (traced, then cropped away).
    """
    ph, pw = packet_shape
    hp, wp = _round_up(height, ph), _round_up(width, pw)
    gy, gx = torch.meshgrid(torch.arange(hp, device=device), torch.arange(wp, device=device), indexing="ij")
    pix = torch.stack([gx, gy], dim=-1).to(torch.float32)  # (hp, wp, 2)
    pix = pix.reshape(hp // ph, ph, wp // pw, pw, 2).permute(0, 2, 1, 3, 4).reshape(-1, ph * pw, 2)
    n = pix.shape[0]
    pad = _round_up(n, pad_packets_to) - n
    if pad:
        pix = torch.cat([pix, pix[-1:].expand(pad, -1, -1)])
    return pix, (hp // ph, wp // pw)


def frame_pixel_packets_ms(width: int, height: int, px_block=(8, 8), samples: int = 4, pad_packets_to: int = 1,
                           device="cpu"):
    """Multi-sample packets: each packet is a ``px_block`` pixel tile
    repeated ``samples`` times (sample-major), so ``P = bh*bw*samples`` rays
    share one traversal. Returns ``(pixels (B, P, 2), packet_counts)``."""
    pixels, counts = frame_pixel_packets(width, height, px_block, pad_packets_to, device)
    return pixels.repeat(1, samples, 1), counts


def unpack_frame_ms(rgba: torch.Tensor, width: int, height: int, packet_counts, px_block=(8, 8),
                    samples: int = 4) -> torch.Tensor:
    """Inverse of :func:`frame_pixel_packets_ms`: sums the sample slots,
    then unpacks the pixel blocks. ``(B, P, C)`` -> ``(height, width, C)``
    sums."""
    B, P, C = rgba.shape
    summed = rgba.reshape(B, samples, P // samples, C).sum(dim=1)
    return unpack_frame(summed, width, height, packet_counts, px_block)


def render_packets_sum(bvh: BvhArrays, sampler: CameraSampler, pixels, generator, *, spp: int,
                       stack_size: int) -> torch.Tensor:
    """The sum of ``spp`` shaded samples over packets ``pixels (B, P, 2)``:
    ``(B, P, 4)`` RGBA on the pixels' device."""
    acc = torch.zeros(pixels.shape[:-1] + (4,), dtype=torch.float32, device=pixels.device)
    for _ in range(spp):
        rays = sample_rays(sampler, pixels, generator)
        hits = finalize_hits(bvh, rays, trace_packets(bvh, rays, stack_size=stack_size))
        acc = acc + shade_parity_sum(rays.direction, hits.normal, hits.hit, 1)
    return acc


def render_frame_sum(bvh: BvhArrays, sampler: CameraSampler, generator, *, width: int, height: int, spp: int,
                     stack_size: int, packet_shape=PACKET_SHAPE, mesh=None) -> torch.Tensor:
    """Whole-frame render: the sum of ``spp`` RGBA samples ``(H, W, 4)``.
    With a ``mesh``, :func:`make_sharded_renderer`'s split, the sum on
    ``mesh[0]``; no packet is padded: the last shard takes fewer."""
    pixels, counts = frame_pixel_packets(width, height, packet_shape, device=sampler.device)
    if mesh is None:
        rgba = render_packets_sum(bvh, sampler, pixels, generator, spp=spp, stack_size=stack_size)
    else:
        rgba = make_sharded_renderer(mesh, spp=spp, stack_size=stack_size)(bvh, sampler, pixels, generator)
    return unpack_frame(rgba, width, height, counts, packet_shape)


def make_sharded_renderer(mesh, *, spp: int, stack_size: int):
    """:func:`render_packets_sum` sharded over ``mesh``, a sequence of
    devices. Returns ``fn(bvh, sampler, pixels, generator) -> (B, P, 4)``
    on ``mesh[0]``: the scene and sampler replicated once per distinct
    device, the packets split in contiguous ranges, and each shard drawing
    from a generator of its own seeded from ``generator``, so samples
    decorrelate across shards."""
    mesh = tuple(torch.device(d) for d in mesh)

    def render(bvh, sampler, pixels, generator):
        def local(pix, bvh, sampler, gen):
            return render_packets_sum(bvh, sampler, pix, gen, spp=spp, stack_size=stack_size)

        return map_shards(local, pixels, mesh, replicate(bvh, mesh), replicate(sampler, mesh),
                          shard_generators(generator, mesh))

    return render
