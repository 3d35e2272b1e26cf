"""What the drivers share: the camera, the seeds, the pixels that are
checked and the reference's scene."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark.harness import scene
from benchmark.reference import parity, trace


class Phases:
    """Seconds of each named step of set-up, each from the end of the last:
    ``phases("tree")`` closes the step called ``tree``."""

    def __init__(self):
        self.spans, self._last = {}, time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.spans[name] = now - self._last
        self._last = now


def rng(seed: int, stream: int) -> np.random.Generator:
    """A generator for one use of the run's seed (any whole number)."""
    return np.random.default_rng([seed % 2**64, stream])


def lens(config: dict) -> parity.Lens:
    c = config["camera"]
    return parity.look_at(c["eye"], c["target"], c["f_number"], c["sensor_width"])


def port_camera(config: dict):
    """The same camera as the program's ``Camera`` builder makes it."""
    from minipath_tpu_torch.camera import Camera

    c = config["camera"]
    return Camera().look_at(tuple(c["eye"]), tuple(c["target"])).f_number(c["f_number"]).sensor_width(c["sensor_width"])


def check_pixels(seed: int, width: int, height: int, count: int) -> np.ndarray:
    """``(count, 2)`` distinct (x, y) pixels drawn from the run's seed."""
    flat = rng(seed, 1).choice(width * height, size=min(count, width * height), replace=False)
    return np.stack([flat % width, flat // width], axis=-1)


def reference_scene(config: dict, mesh, device, dtype=torch.float32):
    """``(trace.Scene, shading normals)`` of the reference in ``dtype``."""
    tree = scene.reference_tree(config, mesh)
    return (trace.prepare(tree, mesh.positions, mesh.triangles, device, dtype),
            trace.shading_normals(mesh.positions, mesh.normals, mesh.triangles, device, dtype))


def off_share(got: np.ndarray, want: np.ndarray) -> float:
    """Share of byte values that differ from the reference's by two levels
    or more."""
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    return float(np.mean(diff >= 2)) if diff.size else 1.0


def free_program(state, *names) -> None:
    """Drop the program's state (the attributes ``names`` of ``state``)
    before the reference runs, so that its memory is free and the peak
    already read is the program's."""
    for name in names:
        state.__dict__.pop(name, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
