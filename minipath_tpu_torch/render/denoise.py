"""Edge-avoiding à-trous denoiser for path-traced frames.

Port of ``minipath_tpu/render/denoise.py``: a post-process in the SVGF/EAW
family (Dammertz et al. 2010, "Edge-Avoiding À-Trous Wavelet Transform for
fast Global Illumination Filtering"): iterated 5x5 B-spline smoothing with
exponentially growing dilation, where each tap's weight is attenuated by
color, normal and depth differences so that filtering never crosses
geometric edges. The JAX package has no kernel for it (XLA fuses its dense
elementwise math), so it is plain torch ops on ``(H, W, C)`` images here:
25 taps an iteration, each a few clamped gathers and elementwise ops.

The guide buffers (first-hit normal and depth) come from one extra
1-sample trace through the tracer the path tracer uses
(:func:`render_aux`).

This is a biased post-process (the estimator itself stays untouched and
unbiased); it is opt-in: the CLI's ``--denoise``, the progressive viewport
of ``gui.py`` and any caller of :func:`atrous_denoise`.
"""

from __future__ import annotations

import numpy as np
import torch

from minipath_tpu_torch.render.frame import gen_frame_rays9, unpack_frame

__all__ = ["atrous_denoise", "render_aux"]

# 5-tap binomial (B3 spline), the standard à-trous generator.
_H1 = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def _shifted(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``img`` translated by (dy, dx) with edge-clamped borders:
    ``out[y, x] = img[clamp(y - dy), clamp(x - dx)]``, for ``(H, W)`` and
    ``(H, W, C)`` images alike (one gather)."""
    H, W = img.shape[0], img.shape[1]
    ys = (torch.arange(H, device=img.device) - dy).clamp(0, H - 1)
    xs = (torch.arange(W, device=img.device) - dx).clamp(0, W - 1)
    return img[ys[:, None], xs[None, :]]


def _blur3(img: torch.Tensor) -> torch.Tensor:
    """3x3 binomial blur (the SVGF variance prefilter)."""
    k = np.array([0.25, 0.5, 0.25])
    out = torch.zeros_like(img)
    for iy in range(-1, 2):
        for ix in range(-1, 2):
            out = out + float(k[iy + 1] * k[ix + 1]) * _shifted(img, iy, ix)
    return out


def atrous_denoise(
    rgb: torch.Tensor,
    normal: torch.Tensor,
    depth: torch.Tensor,
    variance: torch.Tensor | None = None,
    *,
    iterations: int = 4,
    sigma_color: float = 0.4,
    sigma_normal: float = 128.0,
    sigma_depth: float = 0.15,
    k_variance: float = 16.0,
) -> torch.Tensor:
    """Denoise a linear-RGB frame guided by first-hit geometry.

    ``rgb`` is ``(H, W, 3)`` linear radiance, ``normal`` ``(H, W, 3)``
    (zeros where the primary ray missed), ``depth`` ``(H, W)`` hit
    distance, all on one device. Returns the filtered ``(H, W, 3)`` there.

    Weights per tap ``q`` around pixel ``p`` at dilation ``d = 2^i``:
    ``B3(q) * w_color * max(0, n_p.n_q)^sigma_n *
    exp(-|z_p-z_q| / (sigma_z * d * z_scale))``, with the depth scale
    normalized by the frame's depth spread so the knob is scene-size
    independent. Miss pixels (normal == 0) only mix with other miss
    pixels.

    Without ``variance``, ``w_color`` is the EAW fixed-sigma color term
    (``sigma_color`` halved each iteration). With ``variance`` (the
    per-pixel variance of the mean, e.g. ``render_frame_pt(...,
    return_variance=True)``), the color tolerance scales with the noise
    instead: ``w_color = exp(-|c_p-c_q|^2 / (k_variance * (g_p + g_q) +
    eps))`` with ``g = blur3(var)`` propagated through the filter
    (``var' = sum(w^2 var_q) / (sum w)^2``). Converged pixels stop
    blurring (the filter tends to the identity as variance -> 0), while
    noisy regions keep filtering.
    """
    depth = depth.to(torch.float32)
    rgb = rgb.to(torch.float32)
    normal = normal.to(torch.float32)
    # Sanitize non-finite depths (callers passing inf/NaN for misses):
    # replace with the finite max so the depth weight stays well-defined.
    finite = torch.isfinite(depth)
    z_hi = torch.where(finite, depth, torch.full_like(depth, -torch.inf)).max()
    depth = torch.where(finite, depth, z_hi)
    z_lo = depth.min()
    z_scale = torch.clamp(z_hi - z_lo, min=1e-6)
    miss = torch.all(normal == 0.0, dim=-1)
    miss_f = miss.to(torch.float32)

    out = rgb
    var = None if variance is None else torch.clamp(variance.to(torch.float32), min=0.0)
    for it in range(iterations):
        d = 1 << it
        sc = sigma_color / (2.0**it)
        num = torch.zeros_like(out)
        den = torch.zeros_like(out[..., :1])
        if var is not None:
            g = _blur3(var)
            num_v = torch.zeros_like(var)
        for iy in range(-2, 3):
            for ix in range(-2, 3):
                h = float(_H1[iy + 2] * _H1[ix + 2])
                c_q = _shifted(out, iy * d, ix * d)
                n_q = _shifted(normal, iy * d, ix * d)
                z_q = _shifted(depth, iy * d, ix * d)
                m_q = _shifted(miss_f, iy * d, ix * d)
                dist2 = torch.sum((out - c_q) ** 2, dim=-1)
                if var is None:
                    w_c = torch.exp(-dist2 / (sc * sc))
                else:
                    g_q = _shifted(g, iy * d, ix * d)
                    w_c = torch.exp(-dist2 / (k_variance * (g + g_q) + 1e-6))
                ndot = torch.clamp(torch.sum(normal * n_q, dim=-1), 0.0, 1.0)
                # miss-with-miss pairs pass (both sentinel normals),
                # miss-with-geometry pairs are rejected.
                both_miss = miss_f * m_q
                w_n = torch.where(both_miss > 0.0, torch.ones_like(ndot), ndot**sigma_normal) * (
                    miss == (m_q > 0.0)
                ).to(torch.float32)
                w_z = torch.exp(-torch.abs(depth - z_q) / (sigma_depth * d * z_scale))
                w = h * w_c * w_n * w_z
                num = num + w[..., None] * c_q
                den = den + w[..., None]
                if var is not None:
                    num_v = num_v + w * w * _shifted(var, iy * d, ix * d)
        out = num / torch.clamp(den, min=1e-8)
        if var is not None:
            var = num_v / torch.clamp(den[..., 0] ** 2, min=1e-12)
    return out


def render_aux(
    tracer,
    tracer_state,
    sampler,
    generator: torch.Generator,
    *,
    width: int,
    height: int,
    px_block=(16, 16),
):
    """First-hit guide buffers for :func:`atrous_denoise`.

    One 1-sample primary trace through the given tracer (the tracer the
    path tracer uses, ``make_pt_tracer`` or ``make_full_tracer`` of
    ``render/wavefront.py``, so the scene layout is shared), with iid film
    jitter from ``generator``. Returns ``(normal (H, W, 3), depth (H,
    W))`` on the sampler's device; misses get a zero normal and the
    frame's largest hit depth.
    """
    rays9, counts = gen_frame_rays9(
        sampler, generator, width=width, height=height, px_block=px_block, samples=1
    )
    B0, _, P0 = rays9.shape
    flat = rays9.transpose(1, 2).reshape(-1, 9)
    kh = tracer(tracer_state, flat[:, 0:3], flat[:, 3:6], flat[:, 6:9])
    hit = kh.tri >= 0
    normal = torch.where(hit[:, None], kh.normal, torch.zeros_like(kh.normal))
    far = torch.where(hit, kh.t, torch.zeros_like(kh.t)).max()
    depth = torch.where(hit, kh.t, far)
    packed = torch.cat([normal, depth[:, None]], dim=-1).reshape(B0, P0, 4)
    img = unpack_frame(packed, width, height, counts, px_block)
    return img[..., :3], img[..., 3]
