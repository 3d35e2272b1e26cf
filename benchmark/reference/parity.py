"""Plain reference of the parity integrator as ``render()`` runs it.

Given the scene's arrays, a camera pose, the resolution, tile size, sample
count and render seed, :func:`render_pixels` works out the RGBA bytes that a
``render()`` of that frame should hold at chosen pixels. It replays what
defines the image: the tile order (center-out with exponential jitter, drawn
from the seed), the split of the samples into passes of at most 32 with one
stratum seed each, the dispatches of at most 64 tiles and the uniforms each
draws from a ``torch.Generator`` seeded with the render seed, the per-pixel
jittered strata of the film and lens samples, the thin-lens camera ray, the
closest hit (the plain traversal of ``trace.py`` over the reference's own
tree), the grayscale ``|d . n|`` with alpha 1 on a hit, the sum over passes
and the rounding to bytes. The arithmetic is copied from the port as it
stood when the benchmark was defined (``camera.py``, ``render/stratify.py``,
``render/integrator.py``, ``render/machinery.py``, ``screen_block.py``).

:func:`estimate_pixels` is the same integrand estimated from iid film and
lens samples, with no replay of the program's draws: the expectation of each
pixel, which any sound way of sampling it shares.

Every float is computed in ``dtype``: float32 is the reference, bfloat16 its
control. This module imports torch and NumPy only.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import trace

SAMPLES_PER_PASS = 32
TILES_PER_DISPATCH = 64
MAX_RAYS_PER_DISPATCH = 1 << 25
PACKET = 16  # pixel packets of 16 x 16
CAMERA_SALT = 1 << 12
_GOLDEN = 0x9E3779B9
_M32 = 0xFFFFFFFF


class Lens(NamedTuple):
    """A thin-lens camera: camera-to-world matrix and optics (meters)."""

    camera_to_world: np.ndarray  # (4, 4) float64
    focus_distance: float
    sensor_width: float
    focal_length: float
    f_number: float


def look_at(eye, target, f_number: float, sensor_width: float, focal_length: float = 50e-3) -> Lens:
    """Looking from ``eye`` at ``target``, focused on it (up is +y)."""
    eye = np.asarray(eye, np.float64)
    forward = np.asarray(target, np.float64) - eye
    forward /= np.linalg.norm(forward)
    right = np.cross(forward, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    true_up = np.cross(right, forward)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, true_up, -forward, eye
    dist = float(np.linalg.norm(np.asarray(target, np.float64) - eye))
    return Lens(m, dist, sensor_width, focal_length, f_number)


def sampler(lens: Lens, resolution, device, dtype=torch.float32) -> dict:
    """Per-frame camera constants, rounded to float32 and then to ``dtype``."""
    m = lens.camera_to_world
    center = m[:3, 3].copy()
    forward = m[:3, :3] @ np.array([0.0, 0.0, -1.0])
    up = m[:3, :3] @ np.array([0.0, 1.0, 0.0])
    right = m[:3, :3] @ np.array([1.0, 0.0, 0.0])
    res = np.asarray(resolution, np.float64)
    pixel_scale = lens.sensor_width / res[0]
    film_uv = (res - 1.0) * pixel_scale / 2.0
    fields = dict(
        center=center,
        up=up,
        right=right,
        film_origin_offset=-forward * lens.focal_length + right * film_uv[0] - up * film_uv[1],
        pixel_scale=pixel_scale,
        lens_radius=lens.focal_length / (2.0 * lens.f_number),
        lens_weight=lens.focal_length / lens.focus_distance,
    )
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device).to(dtype) for k, v in fields.items()}


def tile_order(width: int, height: int, tile_size: int, rng: np.random.Generator) -> list:
    """``(x0, y0, x1, y1)`` of each tile, center-out with exponential jitter."""
    center = np.array([width, height], np.float64) / 2

    def spans(n):
        return [(lo, min(n, lo + tile_size)) for lo in range(0, n, tile_size)]

    tiles = [(x0, y0, x1, y1) for (y0, y1) in spans(height) for (x0, x1) in spans(width)]
    scale = float(np.linalg.norm(center)) * 0.1
    keys = []
    for x0, y0, x1, y1 in tiles:
        jitter = rng.exponential(scale) if scale > 0 else 0.0
        keys.append(float(np.linalg.norm(center - np.array([x0 + x1, y0 + y1], np.float64) / 2)) + jitter)
    return [tiles[i] for i in np.argsort(keys, kind="stable")]


def _hash_u32(x):
    x = x.to(torch.int64) & _M32
    x = (x ^ 61) ^ (x >> 16)
    x = (x * 9) & _M32
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & _M32
    return x ^ (x >> 15)


def _strat2d(u1, u2, s, pid, spp: int, salt: int):
    gy = max(int(math.sqrt(spp)), 1)
    while spp % gy:
        gy -= 1
    gx = spp // gy
    shift = _hash_u32((pid.to(torch.int64) & _M32) ^ ((salt * _GOLDEN) & _M32)) % spp
    j = (s + shift) % spp
    return ((j % gx).to(u1.dtype) + u1) * (1.0 / gx), ((j // gx).to(u2.dtype) + u2) * (1.0 / gy)


def camera_rays(cam: dict, x, y, s, spp: int, strat_seed: int, u_film, u_lens):
    """Rays ``(origin, unit direction)`` of lanes at integer pixels ``x, y``
    with sample index ``s`` of a pass of ``spp`` samples, from their film
    and lens uniforms ``(n, 2)``."""
    pid = ((y.to(torch.int64) << 14) | (x.to(torch.int64) & 0x3FFF)) ^ strat_seed
    j0, j1 = _strat2d(u_film[:, 0], u_film[:, 1], s, pid, spp, CAMERA_SALT)
    film_u = x.to(j0.dtype)[:, None] + (j0[:, None] - 0.5)
    film_v = y.to(j1.dtype)[:, None] + (j1[:, None] - 0.5)
    u0, u1 = _strat2d(u_lens[:, 0], u_lens[:, 1], s, pid, spp, CAMERA_SALT + 1)
    r = torch.sqrt(u0)
    theta = 2.0 * torch.pi * u1
    lens_u, lens_v = r * torch.cos(theta), r * torch.sin(theta)
    film_point = cam["film_origin_offset"] + cam["up"] * (film_v * cam["pixel_scale"]) - cam["right"] * (
        film_u * cam["pixel_scale"]
    )
    lens_vec = cam["right"] * (cam["lens_radius"] * lens_u)[:, None] + cam["up"] * (cam["lens_radius"] * lens_v)[:, None]
    direction = lens_vec * cam["lens_weight"] - film_point
    direction = direction / torch.sqrt(torch.sum(direction * direction, dim=-1, keepdim=True))
    return cam["center"] + lens_vec, direction


BLOCK = 1 << 19  # rays traced at once


def _shade(scene, vnorm, o, dirn):
    hits = trace.trace(scene, o, dirn)
    dot = torch.abs(torch.sum(dirn * trace.shade_normal(vnorm, hits), dim=-1))
    hit = (hits.tri >= 0).to(dot.dtype)
    return torch.stack([dot * hit, dot * hit, dot * hit, hit], dim=-1)


def render_pixels(scene: trace.Scene, vnorm: torch.Tensor, lens: Lens, resolution, tile_size: int, spp: int,
                  seed: int, pixels: np.ndarray, dtype=torch.float32) -> np.ndarray:
    """The ``(n, 4)`` RGBA bytes of ``render()``'s image at ``pixels`` ``(n,
    2)`` (x, y) for this frame. ``scene`` and ``vnorm`` come from
    ``trace.prepare`` and ``trace.shading_normals`` in ``dtype``."""
    dev = scene.box.device
    width, height = resolution
    side = -(-tile_size // PACKET) * PACKET
    per_row = side // PACKET
    nb, bp = per_row * per_row, PACKET * PACKET
    tiles = tile_order(width, height, tile_size, np.random.default_rng(seed))
    passes = [min(SAMPLES_PER_PASS, spp - s) for s in range(0, spp, SAMPLES_PER_PASS)]
    pass_seeds = [int(s) for s in np.random.default_rng(seed).integers(-(2**31), 2**31, len(passes))]
    per_dispatch = max(1, min(TILES_PER_DISPATCH, MAX_RAYS_PER_DISPATCH // (side * side * max(passes)), len(tiles)))
    cam = sampler(lens, resolution, dev, dtype)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)

    px, py = pixels[:, 0].astype(np.int64), pixels[:, 1].astype(np.int64)
    where = {t[:2]: i for i, t in enumerate(tiles)}
    tile_idx = np.array([where[(x - x % tile_size, y - y % tile_size)] for x, y in zip(px, py)], np.int64)
    lx, ly = px % tile_size, py % tile_size
    packet = (ly // PACKET) * per_row + lx // PACKET
    lane = (ly % PACKET) * PACKET + lx % PACKET
    xs, ys = torch.from_numpy(px).to(dev), torch.from_numpy(py).to(dev)
    chunks, origins, dirs = [], [], []
    for d0 in range(0, len(tiles), per_dispatch):
        k_count = min(per_dispatch, len(tiles) - d0)
        mine = np.nonzero((tile_idx >= d0) & (tile_idx < d0 + k_count))[0]
        rows = torch.from_numpy((tile_idx[mine] - d0) * nb + packet[mine]).to(dev)
        for n, strat_seed in zip(passes, pass_seeds):
            shape = (k_count * nb, n * bp, 2)
            u_film = torch.rand(shape, generator=generator, device=dev)
            u_lens = torch.rand(shape, generator=generator, device=dev)
            if not len(mine):
                continue
            s = torch.arange(n, device=dev).repeat_interleave(len(mine))
            r = rows.repeat(n)
            col = s * bp + torch.from_numpy(lane[mine]).to(dev).repeat(n)
            sel = torch.from_numpy(mine).to(dev).repeat(n)
            o, dirn = camera_rays(cam, xs[sel], ys[sel], s, n, strat_seed,
                                  u_film[r, col].to(dtype), u_lens[r, col].to(dtype))
            chunks.append((torch.from_numpy(mine).to(dev), n))
            origins.append(o)
            dirs.append(dirn)
    acc = torch.zeros((len(pixels), 4), dtype=dtype, device=dev)
    if not chunks:
        return acc.to(torch.uint8).cpu().numpy()
    o, dirn = torch.cat(origins), torch.cat(dirs)
    rgba = torch.cat([_shade(scene, vnorm, o[i:i + BLOCK], dirn[i:i + BLOCK]) for i in range(0, len(o), BLOCK)])
    at = 0
    for idx, n in chunks:  # a pass's samples summed per pixel, then the passes in order
        part = rgba[at:at + n * len(idx)].view(n, len(idx), 4).sum(dim=0)
        acc.index_add_(0, idx, part)
        at += n * len(idx)
    mean = acc / spp
    return torch.clamp(torch.round(mean * 255.0), 0.0, 255.0).to(torch.uint8).cpu().numpy()


def estimate_pixels(scene: trace.Scene, vnorm: torch.Tensor, lens: Lens, resolution, pixels: np.ndarray,
                    paths: int, seed: int):
    """``(sum, sum of squares)``, each ``(n, 2)`` float64, of the gray value
    and the alpha of ``paths`` camera rays at each of ``pixels`` ``(n, 2)``,
    from iid film and lens samples drawn from ``seed``."""
    dev, dt = scene.box.device, scene.box.dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cam = sampler(lens, resolution, dev, dt)
    px = torch.from_numpy(np.repeat(pixels, paths, axis=0)).to(dev)
    owner = torch.arange(len(pixels), device=dev).repeat_interleave(paths)
    total = torch.zeros((len(pixels), 2), dtype=torch.float64, device=dev)
    squares = torch.zeros_like(total)
    zero = torch.zeros(min(BLOCK, len(px)), dtype=torch.int64, device=dev)
    for i in range(0, len(px), BLOCK):
        p, who = px[i:i + BLOCK], owner[i:i + BLOCK]
        u = torch.rand((len(p), 4), generator=gen, device=dev).to(dt)
        o, d = camera_rays(cam, p[:, 0], p[:, 1], zero[:len(p)], 1, 0, u[:, :2], u[:, 2:])
        v = _shade(scene, vnorm, o, d)[:, 2:].double()  # gray, alpha
        total.index_add_(0, who, v)
        squares.index_add_(0, who, v * v)
    return total, squares
