"""Adaptive sampling: spend the sample budget where the variance is.

Port of ``minipath_tpu/render/adaptive.py``. A small pilot pass estimates
each pixel block's noise; the rest of the budget is allocated across the
blocks in proportion to the pilot's standard deviation (minimizing the
frame's total variance under a fixed budget puts ``n_b`` proportional to
``sigma_b``).

The estimator stays unbiased without discarding the pilot: a pixel's value
combines the pilot mean ``m1`` and the adaptive rounds' mean ``m2`` with the
fixed convex weights ``w1 = pilot/spp, w2 = 1 - w1`` (the budgeted shares,
not the realized counts). The rounds' samples are fresh, so ``E[m2 |
allocation] = mu`` for any allocation that depends on the pilot, and fixed
weights keep ``E[w1 m1 + w2 m2] = mu``; weighting by the realized counts is
what biases naive adaptive samplers.

Allocation is per packet (one pixel block), in whole chunks of
``samples_per_packet`` samples. Round ``r`` renders, in allocation order
(neediest first, ``gen_rays9_blocks(block_ids=)``), the ``n_r`` packets
that take an ``r``-th chunk, and traces ``n_r`` packets' rays as the live
prefix (``_pt_trace(live_rays=)``). The JAX rounds keep every packet in the
batch, because a compiled program has one shape, and let the kernel skip a
dead suffix; here the batch is cut to the live packets, so a round's torch
work shrinks with it.
"""

from __future__ import annotations

import numpy as np
import torch

from minipath_tpu_torch.render.frame import gen_rays9_blocks, unpack_frame
from minipath_tpu_torch.render.wavefront import _pt_trace
from minipath_tpu_torch.scene.materials import Environment
from minipath_tpu_torch.utils import LUMA_WEIGHTS

__all__ = ["allocate_chunks", "render_frame_pt_adaptive"]


def _chunk_blocks(
    tracer_state,
    materials,
    env,
    sampler,
    generator,
    block_ids,
    live_rays: int,
    lights,
    seed: int,
    *,
    tracer,
    wc: int,
    px_block,
    samples: int,
    bounces: int,
    compaction: bool,
    shadow_tracer=None,
    shadow_rr: bool = True,
    nee_max_depth: int | None = None,
    rr_start: int = 3,
    with_sumsq: bool = False,
    stratify: bool = True,
):
    """One round: ``samples`` spp for the first ``live_rays`` rays of the
    packets listed in ``block_ids`` (allocation order). Each round tiles a
    whole stratum window of its own, so it takes a pairing seed of its own."""
    strat_spp = samples if stratify else None
    rays9 = gen_rays9_blocks(
        sampler, generator, 0, block_count=block_ids.shape[0], wc=wc, px_block=px_block, samples=samples,
        strat_spp=strat_spp, strat_seed=seed, block_ids=block_ids,
    )
    return _pt_trace(
        tracer_state, materials, env, rays9, generator, tracer=tracer, samples=samples, bounces=bounces,
        compaction=compaction, lights=lights, shadow_tracer=shadow_tracer, shadow_rr=shadow_rr,
        nee_max_depth=nee_max_depth, rr_start=rr_start, strat_spp=strat_spp, strat_seed=seed,
        live_rays=live_rays, with_sumsq=with_sumsq,
    )


def allocate_chunks(var_px: np.ndarray, total_chunks: int) -> np.ndarray:
    """Chunks per packet, ``(B,)`` int64 summing to ``total_chunks``, from
    the pilot's per-pixel variances ``var_px`` ``(B, bp)`` float32.

    The optimal allocation for the frame's squared error puts ``n_b`` in
    proportion to the square root of the packet's total variance: the L2
    norm of its pixel sigmas, not their mean (which under-weights a packet
    whose noise sits in a few pixels). Every packet gets at least one chunk;
    the integer counts come by largest remainder."""
    B = var_px.shape[0]
    sigma_b = np.sqrt(np.mean(np.maximum(var_px, np.float32(0.0)), axis=1))
    w_pos = sigma_b + 1e-12
    quota = w_pos / w_pos.sum() * (total_chunks - B) + 1.0
    c_b = np.floor(quota).astype(np.int64)
    rem = total_chunks - int(c_b.sum())
    if rem > 0:
        top = np.argsort(-(quota - c_b))[:rem]
        c_b[top] += 1
    return c_b


def render_frame_pt_adaptive(
    tracer,
    tracer_state,
    materials,
    sampler,
    generator: torch.Generator | None,
    *,
    width: int,
    height: int,
    spp: int,
    bounces: int = 6,
    env: Environment | None = None,
    px_block=(16, 16),
    samples_per_packet: int = 8,
    pilot_spp: int = 2,
    compaction: bool = True,
    lights=None,
    shadow_tracer=None,
    shadow_rr: bool = True,
    nee_max_depth: int | None = None,
    rr_start: int = 3,
    stratify: bool = True,
    return_spp_map: bool = False,
):
    """Adaptively sampled path-traced frame, ``(H, W, 4)`` mean RGB and alpha
    1 on the sampler's device; arguments as :func:`render_frame_pt`'s.

    ``spp`` is the budget per pixel on average, the pilot included: noisy
    packets receive more, smooth ones less, never below one
    ``samples_per_packet`` chunk. With ``return_spp_map=True`` also returns
    the samples each pixel took, ``(H, W)``.

    Host syncs: one draw from ``generator`` seeds every round's pairing
    seed up front (a NumPy generator deals them out), and the pilot's
    variances come to the host for the allocation.
    """
    dev = sampler.device
    if env is None:
        env = Environment.sky(dev)
    if (lights is None) != (shadow_tracer is None):
        raise ValueError("NEE needs both lights= and shadow_tracer=")
    if spp < pilot_spp + samples_per_packet:
        raise ValueError(
            f"spp={spp} must cover the pilot ({pilot_spp}) plus at least one chunk ({samples_per_packet})"
        )
    bh, bw = px_block
    bp = bh * bw
    hc, wc = -(-height // bh), -(-width // bw)
    B = hc * wc
    gen_dev = dev if generator is None else generator.device
    seeds = np.random.default_rng(int(torch.randint(0, 2**62, (), generator=generator, device=gen_dev)))

    def round_seed() -> int:
        return int(seeds.integers(-(2**31), 2**31))

    kw = dict(
        tracer=tracer, wc=wc, px_block=px_block, bounces=bounces, compaction=compaction,
        shadow_tracer=shadow_tracer, shadow_rr=shadow_rr, nee_max_depth=nee_max_depth, rr_start=rr_start,
        stratify=stratify,
    )
    ident = torch.arange(B, device=dev)
    # The pilot: every packet, every ray live. It estimates sigma per packet
    # and enters the image through the fixed-weight combination.
    psum, psumsq = _chunk_blocks(
        tracer_state, materials, env, sampler, generator, ident, B * bp * pilot_spp, lights, round_seed(),
        samples=pilot_spp, with_sumsq=True, **kw,
    )
    lum = psum @ torch.from_numpy(LUMA_WEIGHTS).to(dev)
    var_px = (psumsq - lum * lum / pilot_spp) / max(pilot_spp - 1, 1)
    total_chunks = max(int(round((spp - pilot_spp) * B / samples_per_packet)), B)
    c_b = allocate_chunks(var_px.cpu().numpy(), total_chunks)

    order = np.argsort(-c_b, kind="stable")  # needy first
    c_sorted = c_b[order]
    order_dev = torch.from_numpy(order).to(dev)
    acc = torch.zeros((B, bp, 3), dtype=torch.float32, device=dev)
    counts = np.zeros((B,), np.int64)
    for r in range(int(c_sorted.max())):
        n_r = int((c_sorted > r).sum())
        part = _chunk_blocks(
            tracer_state, materials, env, sampler, generator, order_dev[:n_r], n_r * bp * samples_per_packet,
            lights, round_seed(), samples=samples_per_packet, **kw,
        )
        acc.index_add_(0, order_dev[:n_r], part[:n_r])
        counts[order[:n_r]] += samples_per_packet

    # The fixed-weight convex combination of the pilot's mean and the
    # rounds' (the budgeted shares: unbiased for any allocation).
    w1 = pilot_spp / spp
    m1 = psum / pilot_spp
    m2 = acc / torch.from_numpy(counts.astype(np.float32)).to(dev)[:, None, None]
    mean = w1 * m1 + (1.0 - w1) * m2
    img = unpack_frame(torch.cat([mean, torch.ones_like(mean[..., :1])], dim=-1), width, height, (hc, wc), px_block)
    if return_spp_map:
        per_packet = torch.from_numpy((counts + pilot_spp).astype(np.float32)).to(dev)
        spp_img = unpack_frame(per_packet[:, None, None].expand(B, bp, 1), width, height, (hc, wc), px_block)
        return img, spp_img[..., 0]
    return img
