"""Plain reference of the parity integrator as ``render()`` runs it in frame
mode: no tile callback, the tiles placed into a frame on the device and the
frame fetched once.

Frame mode traces the same tiles, passes, strata and rays as tile mode
(``parity.py``), but groups the tiles in dispatches of up to 1,024 tiles
where tile mode takes 64, each dispatch still held to
``parity.MAX_RAYS_PER_DISPATCH`` rays of its largest pass: 256 tiles of 64
x 64 at 32 samples. The film and lens uniforms are drawn a dispatch and a
pass at a time, so the grouping decides which uniform each sample takes,
and a replay with tile mode's grouping gives another image.

:func:`render_pixels` replays that grouping with ``parity.py``'s tile order,
camera rays and shading; the arithmetic is ``parity.render_pixels``'s. This
module imports torch and NumPy only.
"""

from __future__ import annotations

import numpy as np
import torch

from . import parity, trace

TILES_PER_DISPATCH = 1024


def render_pixels(scene: trace.Scene, vnorm: torch.Tensor, lens: parity.Lens, resolution, tile_size: int, spp: int,
                  seed: int, pixels: np.ndarray, dtype=torch.float32,
                  tiles_per_dispatch: int = TILES_PER_DISPATCH) -> np.ndarray:
    """The ``(n, 4)`` RGBA bytes of ``render()``'s frame-mode image at
    ``pixels`` ``(n, 2)`` (x, y) for this frame, from dispatches of at most
    ``tiles_per_dispatch`` tiles. ``scene`` and ``vnorm`` come from
    ``trace.prepare`` and ``trace.shading_normals`` in ``dtype``."""
    dev = scene.box.device
    width, height = resolution
    side = -(-tile_size // parity.PACKET) * parity.PACKET
    per_row = side // parity.PACKET
    nb, bp = per_row * per_row, parity.PACKET * parity.PACKET
    tiles = parity.tile_order(width, height, tile_size, np.random.default_rng(seed))
    passes = [min(parity.SAMPLES_PER_PASS, spp - s) for s in range(0, spp, parity.SAMPLES_PER_PASS)]
    pass_seeds = [int(s) for s in np.random.default_rng(seed).integers(-(2**31), 2**31, len(passes))]
    per_dispatch = max(1, min(tiles_per_dispatch, parity.MAX_RAYS_PER_DISPATCH // (side * side * max(passes)),
                              len(tiles)))
    cam = parity.sampler(lens, resolution, dev, dtype)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)

    px, py = pixels[:, 0].astype(np.int64), pixels[:, 1].astype(np.int64)
    where = {t[:2]: i for i, t in enumerate(tiles)}
    tile_idx = np.array([where[(x - x % tile_size, y - y % tile_size)] for x, y in zip(px, py)], np.int64)
    lx, ly = px % tile_size, py % tile_size
    packet = (ly // parity.PACKET) * per_row + lx // parity.PACKET
    lane = (ly % parity.PACKET) * parity.PACKET + lx % parity.PACKET
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
            o, dirn = parity.camera_rays(cam, xs[sel], ys[sel], s, n, strat_seed,
                                         u_film[r, col].to(dtype), u_lens[r, col].to(dtype))
            del u_film, u_lens
            chunks.append((torch.from_numpy(mine).to(dev), n))
            origins.append(o)
            dirs.append(dirn)
    acc = torch.zeros((len(pixels), 4), dtype=dtype, device=dev)
    if not chunks:
        return acc.to(torch.uint8).cpu().numpy()
    o, dirn = torch.cat(origins), torch.cat(dirs)
    block = parity.BLOCK
    rgba = torch.cat([parity._shade(scene, vnorm, o[i:i + block], dirn[i:i + block])
                      for i in range(0, len(o), block)])
    at = 0
    for idx, n in chunks:  # a pass's samples summed per pixel, then the passes in order
        part = rgba[at:at + n * len(idx)].view(n, len(idx), 4).sum(dim=0)
        acc.index_add_(0, idx, part)
        at += n * len(idx)
    mean = acc / spp
    return torch.clamp(torch.round(mean * 255.0), 0.0, 255.0).to(torch.uint8).cpu().numpy()
