"""``render()`` as the CLI calls it: tile mode, a finished-tile callback.

One request is one frame: ``render(Scene(bvh), camera, settings,
finished_tile_callback=..., seed=...)``, ``wait()``, then ``image()`` on the
host; the next frame starts when that returns (a closed loop). Each frame
takes a fresh render seed from the run's seed.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.drivers import common
from benchmark.harness import scene
from benchmark.reference import parity


class State:
    pass


def setup(config: dict, params: dict, seed: int, device) -> State:
    phases = common.Phases()
    from minipath_tpu_torch import RenderSettings, Scene

    phases("import")
    s = State()
    s.config, s.params, s.device, s.phases = config, params, device, phases
    s.mesh = scene.mesh(config)
    s.phases("mesh")
    s.bvh = scene.port_bvh(s.mesh)
    s.scene = Scene(s.bvh)
    s.phases("tree")
    s.camera = common.port_camera(config)
    s.size = (params["width"], params["height"])
    s.settings = RenderSettings(tile_size=params["tile_size"], sample_count=params["spp"], resolution=s.size)
    s.seeds = common.rng(seed, 0)
    s.pixels = common.check_pixels(seed, *s.size, params["check_pixels"])
    s.tiles = 0
    request(s)  # warm-up: builds the kernels and uploads the scene
    s.phases("warm-up")
    return s


def _on_tile(state, _tile, _snapshot):
    state.tiles += 1


def request(s: State) -> dict:
    from minipath_tpu_torch import render

    seed = int(s.seeds.integers(0, 2**31))
    start = time.perf_counter()
    progress = render(s.scene, s.camera, s.settings, finished_tile_callback=lambda t, p: _on_tile(s, t, p),
                      device=s.device, seed=seed)
    progress.wait()
    image = progress.image()
    end = time.perf_counter()
    w, h = s.size
    return {"start": start, "end": end, "seed": seed, "rays": w * h * progress.spp_effective,
            "timings": progress.timings().summary(), "sample": image[s.pixels[:, 1], s.pixels[:, 0]]}


def check(s: State, records: list, seed: int) -> dict:
    """The window's frames at the checked pixels against the plain
    reference, twice. Exactly: the frames that the seed picks, replayed draw
    for draw, and the share of byte values off by two levels or more.
    Statistically: every frame's gray and alpha against the reference's own
    iid estimate of each pixel's expectation, which holds whatever order the
    program draws its samples in (``compare``)."""
    p = s.params
    pick = common.rng(seed, 2).choice(len(records), size=min(p["check_frames"], len(records)), replace=False)
    config, mesh, device, size = s.config, s.mesh, s.device, s.size
    common.free_program(s, "bvh", "scene")
    ref, vnorm = common.reference_scene(config, mesh, device)
    lens = common.lens(config)
    got, want = [], []
    for i in sorted(pick):
        got.append(records[i]["sample"])
        want.append(parity.render_pixels(ref, vnorm, lens, size, p["tile_size"], p["spp"], records[i]["seed"],
                                         s.pixels))
    numbers = {"off_share": common.off_share(np.concatenate(got), np.concatenate(want))}
    total, squares = parity.estimate_pixels(ref, vnorm, lens, size, s.pixels, p["reference_paths"],
                                            int(common.rng(seed, 3).integers(0, 2**62)))
    frames = np.stack([r["sample"][:, [0, 3]] for r in records]).astype(np.float64) / 255.0
    numbers.update(compare(frames, total.cpu().numpy(), squares.cpu().numpy(), p["reference_paths"]))
    return {name: (numbers[name], limit) for name, limit in p["checks"].items()}


def compare(frames, ref_total, ref_squares, paths: int) -> dict:
    """The program's frames ``(K, n, 2)`` (gray and alpha in [0, 1] at the
    checked pixels) against the reference's per-pixel sums ``(n, 2)`` over
    ``paths`` iid rays: ``pixel_z2``, the mean over pixels and both values of
    the squared gap between the frames' mean and the reference's in standard
    errors, with half a byte level added for the rounding to bytes; and
    ``mean_gap``, the gap of the totals over the reference's total."""
    k = frames.shape[0]
    p_mean = frames.mean(axis=0)
    p_se2 = frames.var(axis=0, ddof=1) / k if k > 1 else np.full_like(p_mean, np.inf)
    r_mean = ref_total / paths
    r_se2 = np.maximum(ref_squares / paths - r_mean ** 2, 0.0) / (paths - 1)
    z2 = (p_mean - r_mean) ** 2 / (p_se2 + r_se2 + (0.5 / 255.0) ** 2)
    return {"pixel_z2": float(np.mean(z2)), "mean_gap": float(abs(p_mean.sum() - r_mean.sum()) / r_mean.sum())}
