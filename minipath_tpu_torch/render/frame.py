"""Whole-frame parity renderer on the traversal kernel.

Port of ``minipath_tpu/render/frame.py`` (``render_frame_pallas`` and
``make_frame_renderer_sharded``, one function here with a ``mesh=``
argument, and ``rays9_to_rays``) together with the ray generation they call
in ``minipath_tpu/parallel/mesh.py`` (``gen_rays9_blocks``,
``gen_frame_rays9``, ``unpack_frame``). One chunk of samples at a time:
camera rays for every pixel block, one trace, parity shading
(:func:`shade_parity_sum`, the port's one parity shader: grayscale
``|d.n|``, alpha on hit), and a sum on the device.

Packets are multi-sample: a ``px_block`` pixel tile repeated for each sample
of the chunk, sample-major. The kernel traces one ray per thread, so the
packet shape fixes only the memory layout and the order of the samples.
"""

from __future__ import annotations

import torch

from minipath_tpu_torch.camera import CameraSampler, sample_rays
from minipath_tpu_torch.geometry.ray import Rays
from minipath_tpu_torch.parallel import frame_shards, gather
from minipath_tpu_torch.render.camera_rays import launch as launch_camera
from minipath_tpu_torch.render.kernels import KernelScene, rays_to_rays9
from minipath_tpu_torch.render.kernels_q import QuantizedScene, trace_scene
from minipath_tpu_torch.render.shade import STRAT_JITTER, STRAT_SOBOL
from minipath_tpu_torch.render.stratify import grid_factor, render_seed
from minipath_tpu_torch.utils.profiling import count, recording

# Dimension-salt base for the camera's film/lens strata, clear of the
# per-bounce salts a path tracer uses (8 per bounce).
CAMERA_SALT = 1 << 12


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def uses_camera_kernel(device: torch.device) -> bool:
    """Whether camera rays on ``device`` come from the camera-ray kernel
    (:func:`packet_rays9`): on a card. Elsewhere the plain chain makes
    them."""
    return device.type == "cuda"


def packet_rays9(
    sampler: CameraSampler,
    origin: torch.Tensor,
    generator: torch.Generator | None,
    *,
    px_block,
    samples: int,
    strat_spp: int | None,
    strat_offset: int,
    strat_seed: int,
    row_stride: int,
    x_mask: int = -1,
) -> torch.Tensor:
    """The camera rays of pixel packets on a card, ``(B, 9, samples*bh*bw)``,
    by one launch of the camera-ray kernel (``render/camera_rays.py``,
    ``csrc/camera.cu``): the rays, bit for bit, that :func:`sample_rays`
    and ``rays_to_rays9`` make of the same pixels and strata.

    ``origin`` ``(B, 2)`` (integers on the sampler's device) is each
    packet's first pixel, x and y; a packet is that ``px_block`` pixel block
    repeated for each of ``samples`` samples, sample-major, its first sample
    ``strat_offset``. ``strat_spp`` as in :func:`gen_rays9_blocks`; the
    strata's pixel id is ``(y * row_stride + (x & x_mask)) ^ strat_seed``.
    The film and lens uniforms are drawn here, by ``sample_rays``' two
    ``torch.rand`` calls (their shapes, their order; none in Sobol mode), so
    ``generator`` ends in the state the plain chain leaves it in."""
    dev = sampler.device
    bh, bw = px_block
    B, bp = origin.shape[0], bh * bw
    P = samples * bp
    if origin.shape != (B, 2) or any(t.dtype != torch.float32 or not t.is_contiguous() for t in sampler):
        raise ValueError("packet_rays9 takes a (B, 2) origin table and a float32 sampler")
    sobol = strat_spp is not None and strat_spp < 0
    u_film = u_lens = None
    if not sobol:
        u_film = torch.rand((B, P, 2), generator=generator, device=dev)
        u_lens = torch.rand((B, P, 2), generator=generator, device=dev)
    strat = {}
    if strat_spp is not None:
        spp = abs(strat_spp)
        gx, gy = grid_factor(spp)
        strat = dict(strat_mode=STRAT_SOBOL if sobol else STRAT_JITTER, spp=spp, gx=gx, inv_gx=1.0 / gx,
                     inv_gy=1.0 / gy, strat_seed=int(strat_seed) & 0xFFFFFFFF, salt=CAMERA_SALT)
    rays9 = torch.empty((B, 9, P), dtype=torch.float32, device=dev)
    launch_camera(
        dev, n=B * P, lanes=P, block_pixels=bp, block_width=bw, origin=origin.to(torch.int32).contiguous(),
        s0=strat_offset, row_stride=row_stride, x_mask=x_mask & 0xFFFFFFFF, u_film=u_film, u_lens=u_lens,
        **sampler._asdict(), rays9=rays9, **strat,
    )
    if recording():
        count("camera.kernel_lanes", B * P)
    return rays9


def gen_rays9_blocks(
    sampler: CameraSampler,
    generator: torch.Generator | None,
    block_start: int,
    *,
    block_count: int,
    wc: int,
    px_block=(8, 8),
    samples: int = 4,
    strat_spp: int | None = None,
    strat_offset: int = 0,
    strat_seed: int = 0,
    block_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """Multi-sample packet rays ``(block_count, 9, samples*bh*bw)`` for the
    pixel blocks ``block_start ..`` in the frame's row-major block order
    (``wc`` blocks per row). A shard of a mesh gives its own range this way.

    ``strat_spp`` enables per-pixel stratified film/lens sampling over the
    pixel's TOTAL spp (negative: Owen-scrambled Sobol); ``strat_offset`` is
    this chunk's first sample index; ``strat_seed`` re-randomizes the
    stratum pairings per render and is the same for every chunk of one
    render. Pixel ids are ``y * (wc * bw) + x``, XORed with the seed.

    ``block_ids`` (``(block_count,)`` integers) overrides the contiguous
    range with an explicit block index per packet: the adaptive sampler
    renders packets in allocation order this way. Pixel ids and strata
    follow the block, so a block's rays do not depend on where in the batch
    it sits.

    On a card the rays come from :func:`packet_rays9`, one kernel launch,
    with the blocks' first pixels as its origin table.
    """
    dev = sampler.device
    bh, bw = px_block
    bp = bh * bw
    if block_ids is not None:
        b_idx = block_ids.to(dev, torch.int64)[:, None]
    else:
        b_idx = block_start + torch.arange(block_count, device=dev)[:, None]
    by, bx = b_idx // wc, b_idx % wc
    if uses_camera_kernel(dev):
        return packet_rays9(
            sampler, torch.cat([bx * bw, by * bh], dim=1), generator, px_block=px_block, samples=samples,
            strat_spp=strat_spp, strat_offset=strat_offset, strat_seed=strat_seed, row_stride=wc * bw,
        )
    p_idx = torch.arange(bp, device=dev)[None, :]
    py, px = p_idx // bw, p_idx % bw
    gx = (bx * bw + px).expand(block_count, bp)
    gy = (by * bh + py).expand(block_count, bp)
    pix = torch.stack([gx, gy], dim=-1).to(torch.float32)  # (block_count, bp, 2)
    pix = pix.repeat(1, samples, 1)  # sample-major (block_count, P, 2)
    strat = None
    if strat_spp is not None:
        P = samples * bp
        s_idx = strat_offset + torch.arange(P, device=dev) // bp
        pid = (gy * (wc * bw) + gx).repeat(1, samples) ^ strat_seed
        strat = (s_idx.expand(block_count, P), pid, strat_spp, CAMERA_SALT)
    rays = sample_rays(sampler, pix, generator, strat=strat)
    return rays_to_rays9(rays)


def gen_frame_rays9(
    sampler: CameraSampler,
    generator: torch.Generator | None,
    *,
    width: int,
    height: int,
    px_block=(8, 8),
    samples: int = 4,
    strat_spp: int | None = None,
    strat_offset: int = 0,
    strat_seed: int = 0,
):
    """The whole frame's multi-sample packet rays: ``(rays9,
    (hc, wc))`` with ``hc * wc`` pixel blocks, the frame padded up to whole
    blocks. Arguments as in :func:`gen_rays9_blocks`."""
    bh, bw = px_block
    hc, wc = _round_up(height, bh) // bh, _round_up(width, bw) // bw
    rays9 = gen_rays9_blocks(
        sampler,
        generator,
        0,
        block_count=hc * wc,
        wc=wc,
        px_block=px_block,
        samples=samples,
        strat_spp=strat_spp,
        strat_offset=strat_offset,
        strat_seed=strat_seed,
    )
    return rays9, (hc, wc)


def unpack_frame(rgba: torch.Tensor, width: int, height: int, packet_counts, packet_shape) -> torch.Tensor:
    """Per-block pixel values ``(n_blocks, bh*bw, C)`` -> cropped
    ``(height, width, C)``."""
    ph, pw = packet_shape
    hc, wc = packet_counts
    c = rgba.shape[-1]
    v = rgba[: hc * wc].reshape(hc, wc, ph, pw, c)
    v = v.permute(0, 2, 1, 3, 4).reshape(hc * ph, wc * pw, c)
    return v[:height, :width]


def rays9_to_rays(rays9: torch.Tensor) -> Rays:
    """Inverse of ``render/kernels.py::rays_to_rays9``: ``(B, 9, P)`` ->
    :class:`Rays` with ``(B, P, 3)`` fields, views of ``rays9``."""
    r = rays9.transpose(1, 2)  # (B, P, 9)
    return Rays(origin=r[..., 0:3], direction=r[..., 3:6], inv_direction=r[..., 6:9])


def shade_parity_sum(direction: torch.Tensor, normal: torch.Tensor, hit: torch.Tensor, samples: int) -> torch.Tensor:
    """The parity shading (``worker.rs:59-64``): grayscale ``|d.n|`` with
    alpha 1 on a hit, transparent black on a miss. ``direction`` and
    ``normal`` ``(B, P, 3)``, ``hit`` ``(B, P)`` bool, the packets'
    ``samples`` sample-major. Returns ``(B, P // samples, 4)`` RGBA sums
    over the samples. A miss is masked, so its normal (whatever a trace
    leaves there, even non-finite) never reaches the image."""
    dot = torch.abs(torch.sum(direction * normal, dim=-1))
    alpha = hit.to(torch.float32)
    shaded = torch.where(hit, dot, 0.0)
    rgba = torch.stack([shaded, shaded, shaded, alpha], dim=-1)  # (B, P, 4)
    B, P, _ = rgba.shape
    return rgba.reshape(B, samples, P // samples, 4).sum(dim=1)


def render_frame(
    scene: KernelScene | QuantizedScene,
    sampler: CameraSampler,
    generator: torch.Generator | None,
    *,
    width: int,
    height: int,
    spp: int,
    stack_size: int,
    px_block=(16, 16),
    samples_per_packet: int = 16,
    stratify: bool = True,
    sobol: bool = False,
    strat_seed: int | None = None,
    mesh=None,
) -> torch.Tensor:
    """Full-frame mean image ``(H, W, 4)`` float32 in [0, 1] on the
    scene's device (``mesh[0]`` with a mesh).

    ``stratify`` draws the film jitter and lens sample from per-pixel
    jittered strata spanning the full ``spp``; ``sobol`` upgrades them to
    per-pixel Owen-scrambled Sobol points, and every sample is then a pure
    function of (pixel, sample index, ``strat_seed``): no uniform is drawn
    from ``generator`` for them. ``strat_seed`` (an int) re-randomizes the
    stratum pairings per render; when None it is drawn from ``generator``
    (one host sync), so two frames from generators in different states pair
    their strata differently. ``generator`` may be None only in Sobol mode
    with a ``strat_seed`` given.

    ``mesh``, a sequence of devices (``parallel.make_device_mesh``; it may
    repeat one), shards the frame: its pixel blocks are split into
    contiguous ranges, one per device (the scheduler role of
    ``machinery.rs:31-62,205-210`` at device granularity), the scene and
    sampler replicated once per distinct device. Each shard makes the camera
    rays of its own range, traces them with ``trace_scene`` (K1, or K3 in
    full mode over a :class:`QuantizedScene`) and shades them on its device;
    the sums are gathered onto ``mesh[0]``. Each shard draws its film and
    lens uniforms from a generator of its own, seeded from ``generator``
    (:func:`parallel.shard_generators`); the pairing seed is drawn once and
    shared. In Sobol mode nothing is drawn, so the sharded frame equals the
    unsharded one bit for bit.
    """
    if scene.device != sampler.device:
        raise ValueError(f"scene on {scene.device}, sampler on {sampler.device}")
    if generator is None and (strat_seed is None or not (stratify and sobol)):
        raise ValueError("generator=None needs sobol=True and a strat_seed")
    if strat_seed is None:
        strat_seed = render_seed(generator) if stratify else 0
    strat_spp = (-spp if sobol else spp) if stratify else None
    bh, bw = px_block
    hc, wc = _round_up(height, bh) // bh, _round_up(width, bw) // bw
    # In Sobol mode no uniform is drawn: no shard takes a generator.
    shards = frame_shards(mesh, hc * wc, None if stratify and sobol else generator, scene, sampler)

    acc = [None] * len(shards)
    done = 0
    while done < spp:
        n = min(samples_per_packet, spp - done)
        for i, (lo, hi, gen, (scene_d, sampler_d)) in enumerate(shards):
            rays9 = gen_rays9_blocks(
                sampler_d, gen, lo, block_count=hi - lo, wc=wc, px_block=px_block, samples=n,
                strat_spp=strat_spp, strat_offset=done, strat_seed=strat_seed,
            )
            kh = trace_scene(scene_d, rays9, stack_size=stack_size)
            part = shade_parity_sum(rays9_to_rays(rays9).direction, kh.normal, kh.tri >= 0, n)
            acc[i] = part if acc[i] is None else acc[i] + part
        done += n
    return unpack_frame(gather(acc, mesh), width, height, (hc, wc), px_block) / spp
