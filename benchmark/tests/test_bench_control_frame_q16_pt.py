"""The bfloat16 control of the frame-mode parity cell and of the path
tracer's cell over the 16-bit layout: the reference in bfloat16, the next
precision below the configurations' float32, put in the program's place.
It has to come out not correct by the cells' own limits: for frame mode on
the CPU at a size it holds and on the card (marked ``cuda``) at the cell's
own size, every number; for the path tracer on the card at the cell's own
599,452-triangle atrium, one number at least (``test_bench_control`` holds
the same comparison on the CPU)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from test_bench_control import CONTROL_FRAMES, SEEDS, _pt_control, _tiny

from benchmark.drivers import common, pt_frame, render_cli
from benchmark.harness import scene
from benchmark.reference import parity, parity_frame, trace

ROOT = Path(__file__).resolve().parents[2]
FRAME, Q16_PT = "parity-frame-mode-1080p64", "pt-q16-600k-1080p64-nee1"


def _params(cell: str) -> dict:
    return json.loads((ROOT / "benchmark" / "workloads" / f"{cell}.json").read_text())


def _frame_numbers(m, tree, device, lens, size, tile, spp, seed, pixels, dtype, frames=CONTROL_FRAMES) -> dict:
    """The frame-mode cell's numbers with the reference in ``dtype`` put in
    the program's place: ``frames`` frames of fresh render seeds at
    ``pixels``, the first against the float32 frame-mode replay, all against
    the float32 iid estimate."""
    def scene_in(dt):
        return (trace.prepare(tree, m.positions, m.triangles, device, dt),
                trace.shading_normals(m.positions, m.normals, m.triangles, device, dt))

    f32, low = scene_in(torch.float32), scene_in(dtype)
    seeds = [int(x) for x in common.rng(seed, 0).integers(0, 2**31, frames)]
    got = [parity_frame.render_pixels(*low, lens, size, tile, spp, s, pixels, dtype=dtype) for s in seeds]
    want = parity_frame.render_pixels(*f32, lens, size, tile, spp, seeds[0], pixels)
    total, squares = parity.estimate_pixels(*f32, lens, size, pixels, 128, seed % 2**62)
    stat = render_cli.compare(np.stack([g[:, [0, 3]] for g in got]).astype(np.float64) / 255.0,
                              total.cpu().numpy(), squares.cpu().numpy(), 128)
    return {"off_share": common.off_share(got[0], want), **stat}


@pytest.mark.parametrize("seed", SEEDS)
def test_the_frame_mode_control_fails_on_the_cpu(seed):
    m, tree, lens = _tiny()
    pixels = common.check_pixels(seed, 48, 32, 512)
    got = _frame_numbers(m, tree, "cpu", lens, (48, 32), 16, 40, seed, pixels, torch.bfloat16, frames=8)
    assert any(got[name] > limit for name, limit in _params(FRAME)["checks"].items()), got


@pytest.mark.cuda
def test_the_frame_mode_control_fails_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params = _params(FRAME)
    config = json.loads((ROOT / "benchmark" / "configs" / "atrium250k-parity.json").read_text())
    m = scene.mesh(config)
    tree = scene.reference_tree(config, m)
    size = (params["width"], params["height"])
    readings = []
    for seed in SEEDS:
        pixels = common.check_pixels(seed, *size, params["check_pixels"])
        readings.append(_frame_numbers(m, tree, "cuda", common.lens(config), size, params["tile_size"],
                                       params["spp"], seed, pixels, torch.bfloat16))
    print(f"control {FRAME}: {readings}")
    assert all(all(got[name] > limit for name, limit in params["checks"].items()) for got in readings)


@pytest.mark.cuda
def test_the_q16_pt_control_fails_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params = _params(Q16_PT)
    stat = {k: v for k, v in params["checks"].items() if k in ("mean_gap", "block_z2")}
    config = json.loads((ROOT / "benchmark" / "configs" / "atrium600k-q16-pt.json").read_text())
    m = scene.mesh(config)
    tree = scene.reference_tree(config, m)
    size = (params["width"], params["height"])
    readings = []
    for seed in SEEDS:
        pixels = pt_frame.check_blocks(seed, *size, params["check_blocks"], params["block"])
        readings.append(_pt_control(m, scene.materials(config, m), tree, "cuda", common.lens(config), size, pixels,
                                    {**params, "checks": stat}, seed % 2**62))
    print(f"control {Q16_PT}: {readings}")
    assert all(any(v > limit for v, limit in got.values()) for got in readings)
