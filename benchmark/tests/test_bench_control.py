"""The control: the reference in bfloat16, the next precision below the
configuration's float32, put in the program's place. It has to come out not
correct by the cells' own limits: here at a size the CPU holds (one of the
cell's numbers, at least), and on the card (marked ``cuda``) at the cells'
own sizes on three seeds (the parity cell's every number)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.drivers import common, pt_frame, render_cli
from benchmark.harness import scene
from benchmark.reference import atrium, bvh, pathtrace, parity, trace

ROOT = Path(__file__).resolve().parents[2]
SEEDS = (11, 2**31 + 7, 4_000_000_019)


CONTROL_FRAMES = 16


def _checks() -> dict:
    return json.loads((ROOT / "benchmark" / "workloads" / "parity-1080p64.json").read_text())["checks"]


def _parity_numbers(m, tree, device, lens, size, tile, spp, seed, pixels, dtype, frames=CONTROL_FRAMES) -> dict:
    """The parity cell's numbers with the reference in ``dtype`` put in the
    program's place: ``frames`` frames of fresh render seeds at ``pixels``,
    the first against the float32 replay, all against the float32 iid
    estimate."""
    def scene_in(dt):
        return (trace.prepare(tree, m.positions, m.triangles, device, dt),
                trace.shading_normals(m.positions, m.normals, m.triangles, device, dt))

    f32, low = scene_in(torch.float32), scene_in(dtype)
    seeds = [int(x) for x in common.rng(seed, 0).integers(0, 2**31, frames)]
    got = [parity.render_pixels(*low, lens, size, tile, spp, s, pixels, dtype=dtype) for s in seeds]
    want = parity.render_pixels(*f32, lens, size, tile, spp, seeds[0], pixels)
    total, squares = parity.estimate_pixels(*f32, lens, size, pixels, 128, seed % 2**62)
    stat = render_cli.compare(np.stack([g[:, [0, 3]] for g in got]).astype(np.float64) / 255.0,
                              total.cpu().numpy(), squares.cpu().numpy(), 128)
    return {"off_share": common.off_share(got[0], want), **stat}


def _tiny():
    m = atrium.make_atrium(3000)
    return m, bvh.build_tree(m.positions, m.triangles), parity.look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5), 8.0, 0.036)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_fails_on_the_cpu(seed):
    m, tree, lens = _tiny()
    pixels = common.check_pixels(seed, 48, 32, 512)
    got = _parity_numbers(m, tree, "cpu", lens, (48, 32), 16, 40, seed, pixels, torch.bfloat16, frames=8)
    assert any(got[name] > limit for name, limit in _checks().items()), got


def test_other_draws_fail_the_replay_and_pass_the_statistics(monkeypatch):
    """A sound image whose samples are drawn in another order (dispatches of
    16 tiles, not 64) differs from the replay byte for byte, and agrees with
    the reference's expectation: such a change to the program needs the
    replay brought up to date, and the statistics show the image sound."""
    m, tree, lens = _tiny()
    pixels = common.check_pixels(11, 48, 32, 512)
    ref = (trace.prepare(tree, m.positions, m.triangles, "cpu"),
           trace.shading_normals(m.positions, m.normals, m.triangles, "cpu"))
    replay = parity.render_pixels(*ref, lens, (48, 32), 8, 40, 123, pixels)
    monkeypatch.setattr(parity, "TILES_PER_DISPATCH", 16)
    checks = _checks()
    assert common.off_share(parity.render_pixels(*ref, lens, (48, 32), 8, 40, 123, pixels), replay) > checks["off_share"]
    got = _parity_numbers(m, tree, "cpu", lens, (48, 32), 8, 40, 11, pixels, torch.float32, frames=8)
    assert got["pixel_z2"] <= checks["pixel_z2"] and got["mean_gap"] <= checks["mean_gap"], got


@pytest.mark.cuda
def test_the_control_fails_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params = json.loads((ROOT / "benchmark" / "workloads" / "parity-1080p64.json").read_text())
    config = json.loads((ROOT / "benchmark" / "configs" / "atrium250k-parity.json").read_text())
    m = scene.mesh(config)
    tree = scene.reference_tree(config, m)
    size = (params["width"], params["height"])
    readings = []
    for seed in SEEDS:
        pixels = common.check_pixels(seed, *size, params["check_pixels"])
        readings.append(_parity_numbers(m, tree, "cuda", common.lens(config), size, params["tile_size"],
                                        params["spp"], seed, pixels, torch.bfloat16))
    print(f"control parity-1080p64: {readings}")
    assert all(all(got[name] > limit for name, limit in params["checks"].items()) for got in readings)


def _pt_control(m, ids, tree, device, lens, size, pixels, params, seed) -> dict:
    """The pt cell's numbers with the bfloat16 reference in the program's
    place: four of its estimates as the frames, against the float32
    reference at the check's own sample count."""
    def estimate(dtype, paths, s):
        sc = trace.prepare(tree, m.positions, m.triangles, device, dtype)
        vn = pathtrace.unit_shading_normals(trace.shading_normals(m.positions, m.normals, m.triangles, device, dtype))
        return pathtrace.estimate_pixels(sc, vn, torch.from_numpy(ids).to(device).long(),
                                         pathtrace.material_table(device, dtype), lens, size, pixels, paths,
                                         params["bounces"], s)

    total, squares = estimate(torch.float32, params["reference_paths"], seed)
    frames = np.stack([(estimate(torch.bfloat16, 16, seed + 1 + k)[0] / 16).cpu().numpy() for k in range(4)])
    return pt_frame.compare(frames, total.cpu().numpy(), squares.cpu().numpy(), params["reference_paths"],
                            params["block"] ** 2, params)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_pt_control_fails_on_the_cpu(seed):
    m = atrium.make_atrium(3000)
    params = json.loads((ROOT / "benchmark" / "tests" / "data" / "workloads" / "tiny-pt.json").read_text())
    params["checks"] = json.loads((ROOT / "benchmark" / "workloads" / "pt-1080p64-nee1.json").read_text())["checks"]
    lens = parity.look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5), 8.0, 0.036)
    pixels = pt_frame.check_blocks(seed, 32, 32, params["check_blocks"], params["block"])
    got = _pt_control(m, atrium.atrium_materials(m), bvh.build_tree(m.positions, m.triangles), "cpu", lens,
                      (32, 32), pixels, params, seed % 2**62)
    assert any(v > limit for v, limit in got.values()), got


@pytest.mark.cuda
def test_the_pt_control_fails_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params = json.loads((ROOT / "benchmark" / "workloads" / "pt-1080p64-nee1.json").read_text())
    config = json.loads((ROOT / "benchmark" / "configs" / "atrium250k-pt.json").read_text())
    m = scene.mesh(config)
    tree = scene.reference_tree(config, m)
    size = (params["width"], params["height"])
    readings = []
    for seed in SEEDS:
        pixels = pt_frame.check_blocks(seed, *size, params["check_blocks"], params["block"])
        readings.append(_pt_control(m, scene.materials(config, m), tree, "cuda", common.lens(config), size, pixels,
                                    params, seed % 2**62))
    print(f"control pt-1080p64-nee1: {readings}")
    assert all(any(v > limit for v, limit in got.values()) for got in readings)
