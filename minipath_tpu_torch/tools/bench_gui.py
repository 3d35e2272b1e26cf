"""Progressive-preview interactivity benchmark.

Port of ``tools/bench_gui.py``. Drives the headless GUI controller (the
logic behind the Tk shell) through its real preview -> full escalation at
the reference GUI workload's size (2048x1536, preview 1 spp then full 2
spp, ``gui.rs:216-224``, 64-px tiles) and records time to first tile,
preview completion latency, tile arrival rate, and the preview restart
latency after a camera move. The scene is one of the CLI's procedural ones
(``--scene``, default the atrium, seen by the benchmark camera inside its
hall; the other scenes by the GUI's own camera). Prints its JSON; ``--out``
also writes it to a file.

A drive that ends without all of its render's tiles finished, or a preview
that does not escalate, raises: its times would mean nothing.

Usage: ``python -m minipath_tpu_torch.tools.bench_gui [--device cuda]
[--scene atrium] [--out PATH] [W H]``
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from minipath_tpu_torch.camera import Camera
from minipath_tpu_torch.gui import GuiController
from minipath_tpu_torch.scene import Scene


def drive(controller, mode, timeout=300.0):
    """Pump update() until the given mode's render finishes; returns
    (first_tile_s, done_s, tiles).

    Times are read off the render HANDLE captured at entry: update() may
    escalate preview -> full mid-pump, which swaps controller.progress to a
    fresh (0/total) snapshot and would otherwise lose the first-tile time
    of a fast warm preview."""
    t0 = time.time()
    prog = controller.progress
    total = prog.progress().total
    first = None
    tiles = 0
    while time.time() - t0 < timeout:
        controller.update()
        snap = prog.progress()
        if snap.finished > 0 and first is None:
            first = time.time() - t0
        tiles = snap.finished
        if controller.mode != mode or (
            prog.is_finished() and tiles == total
        ):
            break
        time.sleep(0.005)
    if tiles != total or first is None:
        raise RuntimeError(f"the {mode} render finished {tiles} of {total} tiles in {timeout:.0f} s")
    return first, time.time() - t0, tiles


def measure(controller) -> dict:
    """Start ``controller``, drive its cold preview and full render, then two
    camera moves; returns the timings. Shuts the controller down."""

    def preview_then_full():
        first, done, tiles = drive(controller, "preview")
        controller.update()
        if controller.mode != "full":
            raise RuntimeError("the finished preview did not escalate to the full render")
        return first, done, tiles

    try:
        # A cold start includes the kernels' build and the scene's upload;
        # measure it separately, then the preview rate the user feels.
        controller.start()
        first_cold, done_cold, _ = preview_then_full()
        # Wait out the auto-escalated full render so it doesn't overlap.
        drive(controller, "full")

        # Warm preview restart: the camera-move path (abort + new preview).
        controller.move_camera(0.25, 0.0, 0.0)
        first_warm, done_warm, tiles_warm = preview_then_full()
        drive(controller, "full")

        # Second move for a stable number.
        controller.move_camera(-0.25, 0.0, 0.0)
        first_warm2, done_warm2, _ = drive(controller, "preview")
    finally:
        controller.shutdown()
    warm_first = min(first_warm, first_warm2)
    return {
        "cold_preview_s": round(done_cold, 3),
        "cold_first_tile_s": round(first_cold, 3),
        "warm_preview_s": round(min(done_warm, done_warm2), 3),
        "warm_first_tile_s": round(warm_first, 3),
        "tiles": tiles_warm,
        "warm_tiles_per_s": round(tiles_warm / done_warm, 1),
        # Interactivity = first visual feedback after a camera move; the
        # full preview keeps streaming in behind it (progressive tiles).
        "first_feedback_under_1s": bool(warm_first < 1.0),
    }


def scene_camera(scene: str) -> Camera:
    """The camera a scene is timed under: the benchmark camera inside the
    atrium's hall (the GUI's default one sits in its wall), the GUI's
    default camera elsewhere."""
    if scene == "atrium":
        from minipath_tpu_torch.bench import bench_camera

        return bench_camera()
    return Camera().look_at((0.0, 2.0, 10.0), (0.0, 1.5, 0.0)).f_number(4.8).focus_distance(10.0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Time to first tile and preview latency of the GUI controller.")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda", help="torch device (default cuda)")
    parser.add_argument("--scene", choices=["sphere-mesh", "atrium"], default="atrium", help="scene source")
    parser.add_argument("--out", default=None, metavar="PATH", help="also write the JSON to PATH")
    parser.add_argument("size", type=int, nargs="*", default=[2048, 1536], metavar="W H")
    args = parser.parse_args(argv)
    if len(args.size) != 2:
        parser.error("give both W and H, or neither")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available", file=sys.stderr)
        return 2
    W, H = args.size

    from minipath_tpu_torch.cli import load_scene
    from minipath_tpu_torch.utils.calibrate import device_health

    bvh, _ = load_scene(argparse.Namespace(scene=args.scene, obj=None, integrator="parity", layout="auto"))
    controller = GuiController(Scene(bvh), scene_camera(args.scene), (W, H), tile_size=64, device=args.device)
    out = {"workload": f"{args.scene} {W}x{H}, preview 1 spp (gui.rs:216-224), 64-px tiles", **measure(controller)}
    out["device_health"] = device_health(args.device)
    text = json.dumps(out, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
