"""K1's work on a configuration's camera rays, counted by the reference.

The plain traversal (``reference/trace.py``) over the reference's own tree
traces a fixed sample of the cell's camera rays (iid film and lens samples
at uniform pixels, from a fixed seed) and counts inner visits and packet
tests. Per ray, times the frame's rays, that is the frame's work: it does
not depend on the program's tree or kernel, nor on their counters.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import parity, trace

SAMPLE_RAYS = 1 << 16
SAMPLE_SEED = 20240611


def k1_work(ref_scene: trace.Scene, lens: parity.Lens, resolution, rays: int = SAMPLE_RAYS):
    """``(inner visits, packet tests)`` per camera ray, means over the sample."""
    dev = ref_scene.box.device
    rng = np.random.default_rng(SAMPLE_SEED)
    w, h = resolution
    x = torch.from_numpy(rng.integers(0, w, rays)).to(dev)
    y = torch.from_numpy(rng.integers(0, h, rays)).to(dev)
    u = torch.from_numpy(rng.random((rays, 4), dtype=np.float32)).to(dev)
    cam = parity.sampler(lens, resolution, dev)
    zero = torch.zeros(rays, dtype=torch.int64, device=dev)
    o, d = parity.camera_rays(cam, x, y, zero, 1, 0, u[:, :2], u[:, 2:])
    inner = leaf = 0
    for i in range(0, rays, parity.BLOCK):
        hits = trace.trace(ref_scene, o[i:i + parity.BLOCK], d[i:i + parity.BLOCK])
        inner += int(hits.inner_visits.sum())
        leaf += int(hits.leaf_tests.sum())
    return inner / rays, leaf / rays
