"""``render()`` as a script or a library calls it for the whole image: no
tile callback, so frame mode.

One request is one frame: ``render(Scene(bvh), camera, settings,
seed=...)`` with no callback, ``wait()``, then ``image()`` on the host;
the next frame starts when that returns (a closed loop). Each frame takes
a fresh render seed from the run's seed. Frame mode traces its tiles in
dispatches of up to 1,024 tiles (256 of 64 x 64 at 32 samples a pass),
places them into a frame on the card and fetches the frame once; nothing
is written back tile by tile.

The check is ``render_cli``'s, with the exact replay of frame mode's
dispatches (``reference/parity_frame.py``) in place of tile mode's.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.drivers import common, render_cli
from benchmark.harness import scene
from benchmark.reference import parity, parity_frame

State = render_cli.State


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
    request(s)  # warm-up: builds the kernels and uploads the scene
    s.phases("warm-up")
    return s


def request(s: State) -> dict:
    from minipath_tpu_torch import render

    seed = int(s.seeds.integers(0, 2**31))
    start = time.perf_counter()
    progress = render(s.scene, s.camera, s.settings, device=s.device, seed=seed)
    progress.wait()
    image = progress.image()
    end = time.perf_counter()
    w, h = s.size
    return {"start": start, "end": end, "seed": seed, "rays": w * h * progress.spp_effective,
            "timings": progress.timings().summary(), "sample": image[s.pixels[:, 1], s.pixels[:, 0]]}


def check(s: State, records: list, seed: int) -> dict:
    """The window's frames at the checked pixels against the plain
    reference, twice: the frames that the seed picks, replayed draw for draw
    in frame mode's dispatches (``off_share``), and every frame against the
    reference's iid estimate (``render_cli.compare``)."""
    p = s.params
    pick = common.rng(seed, 2).choice(len(records), size=min(p["check_frames"], len(records)), replace=False)
    config, mesh, device, size = s.config, s.mesh, s.device, s.size
    common.free_program(s, "bvh", "scene")
    ref, vnorm = common.reference_scene(config, mesh, device)
    lens = common.lens(config)
    got, want = [], []
    for i in sorted(pick):
        got.append(records[i]["sample"])
        want.append(parity_frame.render_pixels(ref, vnorm, lens, size, p["tile_size"], p["spp"], records[i]["seed"],
                                               s.pixels))
    numbers = {"off_share": common.off_share(np.concatenate(got), np.concatenate(want))}
    total, squares = parity.estimate_pixels(ref, vnorm, lens, size, s.pixels, p["reference_paths"],
                                            int(common.rng(seed, 3).integers(0, 2**62)))
    frames = np.stack([r["sample"][:, [0, 3]] for r in records]).astype(np.float64) / 255.0
    numbers.update(render_cli.compare(frames, total.cpu().numpy(), squares.cpu().numpy(), p["reference_paths"]))
    return {name: (numbers[name], limit) for name, limit in p["checks"].items()}
