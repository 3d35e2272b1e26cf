"""The frame-mode parity traffic on the CPU: a tiny cell of
``render_frame_mode`` run whole, sound and broken underneath, and the exact
replay of frame mode (``reference/parity_frame.py``) against the port's
frame-mode image, which tile mode's replay does not match. The full-size
cell is ``parity-frame-mode-1080p64``.

The tiny frame has 70 tiles of 16 x 16: frame mode traces them in one
dispatch, tile mode in one of 64 and one of 6, so the two draw their
uniforms otherwise."""

from __future__ import annotations

import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from conftest import DATA, copy_benchmark
from test_bench_run import _altered_tile, _dropped_tiles, _half_samples, _unchanged

from benchmark import run
from benchmark.drivers import common
from benchmark.harness import scene
from benchmark.reference import parity, parity_frame

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 5150
CELL, REAL = "tiny-frame-mode", "parity-frame-mode-1080p64"
# The parity cell's per-layer metrics but the write-back's: frame mode writes
# nothing back tile by tile.
LAYERS = {"k1_ms", "k1_roofline", "tile_glue_ms", "tile_raygen_ms", "idle_pct.parity"}


@pytest.fixture
def frame_bench(tmp_path, monkeypatch):
    """The tiny benchmark with its frame-mode cell on the tiny parity
    configuration, in a temporary copy, its caches kept there too; the cell
    reports every metric that a frame-mode cell would report."""
    monkeypatch.setattr(scene, "CACHE", tmp_path / "cache")
    bench = json.loads((DATA / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": CELL, "config": "tiny-parity", "traffic": "render_frame_mode-tiny",
                               "chips": 1, "why": "tests"})
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    for kind in ("end_to_end", "per_layer"):
        have = {m["name"]: m for m in bench[kind]}
        for m in real[kind]:
            if m["name"] not in {"mrays_s", *LAYERS}:
                continue
            if m["name"] in have:
                have[m["name"]]["workloads"].append(CELL)
            else:
                bench[kind].append({**m, "workloads": [CELL]})
    return copy_benchmark(tmp_path, bench)


def _run(bench_path, trace=False):
    out, err = io.StringIO(), io.StringIO()
    rc = run.run(CELL, SEED, 0.3, trace, device=torch.device("cpu"), bench_path=bench_path, out=out, err=err)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


def test_the_real_cell_is_the_parity_cells_traffic_in_frame_mode():
    real = json.loads((ROOT / "benchmark" / "workloads" / f"{REAL}.json").read_text())
    tile = json.loads((ROOT / "benchmark" / "workloads" / "parity-1080p64.json").read_text())
    assert real["driver"] == "render_frame_mode" and real["checks"] == tile["checks"]
    assert {k: v for k, v in real.items() if k != "driver"} == {k: v for k, v in tile.items() if k != "driver"}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == REAL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("atrium250k-parity", "render_frame_mode-1080p64", 1)
    layers = {m["name"] for m in bench["per_layer"] if "parity-1080p64" in m.get("workloads", [])}
    assert layers - {"writeback_idle_pct"} == LAYERS
    assert {m["name"] for m in bench["per_layer"] if REAL in m.get("workloads", [])} == LAYERS
    assert [m["name"] for m in bench["end_to_end"] if REAL in m.get("workloads", [REAL])] == ["setup_s", "mrays_s"]


@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
def test_a_sound_run_is_correct(frame_bench, trace):
    rc, line, err = _run(frame_bench, trace)
    assert rc == 0 and line["correct"] is True, err
    assert set(line["checks"]) == {"off_share", "pixel_z2", "mean_gap"}
    if trace:
        # Off the card no device time is traced: the readers find nothing.
        assert not LAYERS & set(line["metrics"])
    else:
        assert {"setup_s", "mrays_s"} <= set(line["metrics"])


def _darkened_tile(monkeypatch):
    """An answer altered where it is produced: the first tile of every
    dispatch comes back ten levels darker."""
    from minipath_tpu_torch.render import integrator

    real = integrator.render_tile_batch_bvh

    def altered(*args, spp, **kw):
        out = real(*args, spp=spp, **kw)
        out[0, ..., :3] -= 10.0 / 255.0 * spp
        return out

    monkeypatch.setattr(integrator, "render_tile_batch_bvh", altered)


@pytest.mark.parametrize("fault", [_unchanged, _half_samples, _darkened_tile, _dropped_tiles])
def test_a_broken_timed_path_is_not_correct(frame_bench, monkeypatch, fault):
    fault(monkeypatch)
    rc, line, err = _run(frame_bench)
    assert rc == 0 and line["correct"] is False, err
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_a_brighter_first_tile_leaves_the_frame_as_it_was(tmp_path, monkeypatch):
    """``test_bench_run``'s altered tile brightens the first tile of each
    dispatch. Frame mode's one dispatch starts at the centre, on the far
    wall, which faces the camera and is white (``|d . n|`` near 1), so the
    bytes clamp and the image keeps all but a few values: no check can see
    that fault here, and the cell is held to the darker one instead."""
    from minipath_tpu_torch import RenderSettings, Scene, render

    monkeypatch.setattr(scene, "CACHE", tmp_path / "cache")
    params = json.loads((DATA / "workloads" / f"{CELL}.json").read_text())
    config = json.loads((DATA / "configs" / "tiny-parity.json").read_text())
    settings = RenderSettings(params["tile_size"], params["spp"], (params["width"], params["height"]))
    bvh, camera = scene.port_bvh(scene.mesh(config)), common.port_camera(config)

    def frame():
        progress = render(Scene(bvh), camera, settings, device="cpu", seed=SEED)
        progress.wait()
        return progress.image()

    sound = frame()
    _altered_tile(monkeypatch)
    assert common.off_share(frame(), sound) < 0.001


def test_the_replay_is_the_frame_mode_image_and_tile_modes_is_not(frame_bench):
    """Every pixel of a frame-mode ``render()`` equals the replay's byte for
    byte; the replay of tile mode's 64-tile dispatches misses the cell's
    ``off_share`` limit on the same frame."""
    from minipath_tpu_torch import RenderSettings, Scene, render

    params = json.loads((DATA / "workloads" / f"{CELL}.json").read_text())
    config = json.loads((DATA / "configs" / "tiny-parity.json").read_text())
    size, tile, spp = (params["width"], params["height"]), params["tile_size"], params["spp"]
    assert -(-size[0] // tile) * -(-size[1] // tile) > parity.TILES_PER_DISPATCH
    mesh = scene.mesh(config)
    progress = render(Scene(scene.port_bvh(mesh)), common.port_camera(config), RenderSettings(tile, spp, size),
                      device="cpu", seed=SEED)
    progress.wait()
    image = progress.image()
    pixels = np.stack(np.meshgrid(np.arange(size[0]), np.arange(size[1])), axis=-1).reshape(-1, 2)
    ref, vnorm = common.reference_scene(config, mesh, "cpu")
    lens = common.lens(config)
    got = image[pixels[:, 1], pixels[:, 0]]
    assert (got[:, 3] > 0).mean() > 0.5  # the frame sees the atrium
    want = parity_frame.render_pixels(ref, vnorm, lens, size, tile, spp, SEED, pixels)
    np.testing.assert_array_equal(got, want)
    tile_mode = parity.render_pixels(ref, vnorm, lens, size, tile, spp, SEED, pixels)
    assert common.off_share(got, tile_mode) > params["checks"]["off_share"]
    # The tile mode's grouping through the frame-mode replay is tile mode's replay.
    np.testing.assert_array_equal(parity_frame.render_pixels(ref, vnorm, lens, size, tile, spp, SEED, pixels,
                                                             tiles_per_dispatch=parity.TILES_PER_DISPATCH), tile_mode)
