"""Command-line front-end.

Port of ``minipath_tpu/cli.py`` for the parity integrator (``--integrator
normal``, grayscale ``|d.n|``): the reference's camera recipe (looking from
(0,2,10) at (0,1.5,0), f/4.8 focused at 10 m, 2048x1536, 64-px tiles,
100 spp), BVH statistics printed at startup, a progress bar driven by the
finished-tile callback, and the image written to a PNG. ``--device`` picks
the torch device (default ``cuda``); there is no fallback to another device.

Scenes are an OBJ file (``--obj``), or procedural: ``sphere-mesh``, or the
benchmark ``atrium``. Without ``--obj`` the ``obj`` scene renders the
procedural sphere.
"""

from __future__ import annotations

import argparse
import sys


def _progress_bar(finished: int, total: int, width: int = 40) -> str:
    filled = int(width * finished / total) if total else width
    return "[" + "#" * filled + "-" * (width - filled) + f"] {finished}/{total}"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="minipath-tpu-torch",
        description="minipath renderer on PyTorch/CUDA (parity integrator).",
    )
    p.add_argument("--obj", default=None, help="OBJ file to render (default: a procedural sphere)")
    p.add_argument("--scene", choices=["obj", "sphere-mesh", "atrium"], default="obj", help="scene source")
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--height", type=int, default=1536)
    p.add_argument("--spp", type=int, default=100, help="samples per pixel")
    p.add_argument("--tile-size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", "-o", default="render.png", help="output PNG path")
    p.add_argument("--camera-from", type=float, nargs=3, default=(0.0, 2.0, 10.0), metavar=("X", "Y", "Z"))
    p.add_argument("--camera-to", type=float, nargs=3, default=(0.0, 1.5, 0.0), metavar=("X", "Y", "Z"))
    p.add_argument("--f-number", type=float, default=4.8)
    p.add_argument("--focus", type=float, default=10.0, help="focus distance (meters)")
    p.add_argument("--no-stats", action="store_true", help="skip BVH statistics printout")
    p.add_argument("--quiet", "-q", action="store_true")
    p.add_argument(
        "--integrator",
        choices=["normal"],
        default="normal",
        help="'normal' = reference-parity |d.n| shading",
    )
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda", help="torch device to render on")
    return p


def load_scene(args):
    from minipath_tpu_torch.scene import procedural
    from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh

    if args.scene == "atrium":
        return TriangleBvh.build(procedural.make_atrium())
    if args.scene == "obj" and args.obj:
        return TriangleBvh.with_obj(args.obj)
    if args.scene == "obj":
        print("no --obj given; rendering procedural sphere", file=sys.stderr)
    return TriangleBvh.build(procedural.make_uv_sphere(1.0, rings=32, segments=64))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from minipath_tpu_torch import Camera, RenderSettings, Scene, render
    from minipath_tpu_torch.utils.image import save_png

    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("--device cuda: no CUDA device is available", file=sys.stderr)
            return 2

    bvh = load_scene(args)
    if not args.no_stats:
        bvh.print_statistics()

    camera = (
        Camera()
        .look_at(tuple(args.camera_from), tuple(args.camera_to))
        .f_number(args.f_number)
        .focus_distance(args.focus)
    )
    settings = RenderSettings(
        tile_size=args.tile_size,
        sample_count=args.spp,
        resolution=(args.width, args.height),
    )

    def on_tile(_tile, snapshot):
        if not args.quiet:
            print("\r" + _progress_bar(snapshot.finished, snapshot.total), end="", file=sys.stderr)

    progress = render(
        Scene(bvh), camera, settings, finished_tile_callback=on_tile,
        device=args.device, seed=args.seed,
    )
    try:
        progress.wait()
    except KeyboardInterrupt:
        progress.abort()
        progress.wait()
        print("\naborted", file=sys.stderr)
    if not args.quiet:
        print(file=sys.stderr)

    spp = progress.spp_effective
    rays = args.width * args.height * spp
    elapsed = progress.elapsed()
    print(
        f"rendered {args.width}x{args.height} @ {spp} spp on {args.device} in {elapsed:.2f}s "
        f"({rays / elapsed / 1e6:.1f} Mrays/s)",
        file=sys.stderr,
    )
    save_png(args.output, progress.image())
    print(f"saved {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
