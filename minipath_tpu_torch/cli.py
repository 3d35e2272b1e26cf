"""Command-line front-end.

Port of ``minipath_tpu/cli.py``: the reference's camera recipe (looking from
(0,2,10) at (0,1.5,0), f/4.8 focused at 10 m, 2048x1536, 64-px tiles,
100 spp), BVH statistics printed at startup, and the image written to a PNG.
Two integrators: ``--integrator normal``, the reference-parity grayscale
``|d.n|`` through ``render()`` with a progress bar driven by the
finished-tile callback, and ``--integrator pt``, the wavefront path tracer
under a sky environment, or none for ``tworooms`` (with ``--nee``, light
sampling of the emissive triangles). ``--device`` picks the torch device
(default ``cuda``); there is no fallback to another device.

Scenes are an OBJ file (``--obj``), or procedural: ``sphere-mesh``, the
benchmark ``atrium`` (path traced with its benchmark materials, whose
ceiling panels emit, under the sky), or ``tworooms`` (``make_tworooms``: a
dark room lit through a doorway by a recessed ceiling panel in the next
room, path traced with ``tworooms_materials`` and no environment, as
``--scene tworooms --integrator pt --nee --bounces 7 --camera-from -10 3 0
--camera-to 0 1.5 0 --f-number 8`` renders it; the default camera lies
outside its shell). Without ``--obj`` the ``obj`` scene renders the
procedural sphere; OBJ and sphere scenes are path traced in grey.

Path-traced frames can be filtered before they are saved (``--denoise``:
the edge-avoiding a-trous filter of ``render/denoise.py``, variance-guided
from 2 spp on) and written with their first-hit normal and depth buffers
(``--aov PREFIX``).

``--devices N`` shards the render over a mesh of N devices of ``--device``'s
type (``parallel.make_device_mesh``; 0 takes them all, and ``--device cpu``
repeats the one CPU device): the parity path through ``render(mesh=)``, the
path tracer through ``render_frame_pt(mesh=)``. Asking for more devices
than there are exits 2. ``--adaptive`` path traces with
``render_frame_pt_adaptive`` (a 2-spp pilot allocates the budget toward
noisy pixel blocks); it is single-device, uses jittered strata, and leaves
``--denoise`` the fixed-sigma filter.

``--layout`` picks the scene layout the kernels trace
(``TriangleBvh.layout``): ``auto`` (the default) the f32 layout (K1, K2)
unless its bytes exceed half the card's memory, ``q16`` the 16-bit
quantized one (K3). A tree that the quantized layout cannot hold (spatial
splits, material ids above 65535) exits 2 under ``--layout q16``.

``--trace-out PATH`` records the program's spans and counters
(``utils/profiling.py``) for the run and writes them at exit as a Chrome
trace, which opens beside a ``torch.profiler`` trace.
"""

from __future__ import annotations

import argparse
import sys
import time

from minipath_tpu_torch.scene.triangle_bvh import LAYOUTS


# --adaptive's pilot samples and chunk (render_frame_pt_adaptive's defaults).
ADAPTIVE_PILOT, ADAPTIVE_CHUNK = 2, 8


def _positive_int(text: str) -> int:
    v = int(text)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def _progress_bar(finished: int, total: int, width: int = 40) -> str:
    filled = int(width * finished / total) if total else width
    return "[" + "#" * filled + "-" * (width - filled) + f"] {finished}/{total}"


def add_layout_argument(p: argparse.ArgumentParser) -> None:
    """``--layout``, shared with the GUI."""
    p.add_argument("--layout", choices=LAYOUTS, default="auto", help="scene layout the kernels trace: 'auto' = f32 "
                   "unless it exceeds half the card's memory, or 'q16' = the 16-bit quantized layout (K3)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="minipath-tpu-torch",
        description="minipath renderer on PyTorch/CUDA.",
    )
    p.add_argument("--obj", default=None, help="OBJ file to render (default: a procedural sphere)")
    p.add_argument("--scene", choices=["obj", "sphere-mesh", "atrium", "tworooms"], default="obj",
                   help="scene source; 'tworooms' is lit only through a doorway and has no environment: render it "
                   "from inside, e.g. --integrator pt --nee --bounces 7 --camera-from -10 3 0 --camera-to 0 1.5 0 "
                   "--f-number 8")
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
        choices=["normal", "pt"],
        default="normal",
        help="'normal' = reference-parity |d.n| shading; 'pt' = path tracing with a sky environment, none "
        "for --scene tworooms (OBJ scenes get a default grey material)",
    )
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda", help="torch device to render on")
    p.add_argument("--bounces", type=int, default=6, help="path-tracer bounce budget")
    p.add_argument("--devices", type=int, default=1, help="shard the render across N devices of --device's type "
                   "(a device mesh; --device cpu repeats the CPU); 0 = all available")
    p.add_argument("--no-compaction", action="store_true", help="path tracer: no wavefront compaction between bounces")
    p.add_argument("--nee", action="store_true", help="path tracer: next-event estimation (light sampling with MIS; "
                   "needs emissive materials, e.g. --scene atrium)")
    p.add_argument("--nee-depth", type=_positive_int, default=None, metavar="K", help="path tracer: light-sample "
                   "only the first K path vertices (unbiased at any K); requires --nee and an emissive scene")
    p.add_argument("--no-shadow-rr", action="store_true", help="path tracer: no Russian roulette of shadow rays")
    p.add_argument("--rr-start", type=_positive_int, default=3, metavar="B", help="path tracer: first bounce at "
                   "which path Russian roulette may end a path (unbiased at any setting)")
    p.add_argument("--rr-floor", type=float, default=0.05, metavar="P", help="path tracer: roulette "
                   "survival-probability floor (unbiased; 1.0 disables roulette)")
    p.add_argument("--tail-cut", type=float, default=None, metavar="F", help="path tracer: retire the whole "
                   "wavefront once fewer than F of its paths are live (BIASED; off by default)")
    p.add_argument("--iid", action="store_true", help="path tracer: iid sampling instead of per-pixel strata")
    p.add_argument("--sobol", action="store_true", help="path tracer: Owen-scrambled Sobol sample dimensions "
                   "instead of jittered strata")
    p.add_argument("--denoise", action="store_true", help="path tracer: edge-avoiding a-trous filter guided by "
                   "first-hit normals/depth (biased post-process; the saved PNG only)")
    p.add_argument("--aov", metavar="PREFIX", default=None, help="path tracer: also write first-hit AOVs "
                   "<PREFIX>_normal.png and <PREFIX>_depth.png")
    p.add_argument("--adaptive", action="store_true", help="path tracer: adaptive sampling, a 2-spp pilot "
                   "allocates the --spp budget toward noisy pixel blocks (unbiased; single-device; needs --spp >= 10)")
    p.add_argument("--clamp", type=float, default=None, metavar="L", help="path tracer: cap each sample's "
                   "radiance at L before averaging (firefly suppression; biased)")
    add_layout_argument(p)
    p.add_argument("--trace-out", metavar="PATH", default=None, help="write the run's spans and counters as a "
                   "Chrome trace to PATH")
    return p


def load_scene(args):
    """``(bvh, material dicts or None)`` for the chosen scene, its layout
    ``args.layout``. The atrium and the two rooms are built by the native
    C++ code (``scene/bvh/native.py``), which raises where it cannot be
    compiled."""
    from minipath_tpu_torch.scene import procedural
    from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh

    layout = args.layout
    # Each procedural scene with its material set (emitters, so --nee has
    # lights), which the path tracer takes.
    generated = {"atrium": (procedural.make_atrium, procedural.atrium_materials),
                 "tworooms": (procedural.make_tworooms, procedural.tworooms_materials)}
    if args.scene in generated:
        make, materials = generated[args.scene]
        mesh = make()
        if args.integrator == "pt":
            ids, dicts = materials(mesh)
            return TriangleBvh.build(mesh, materials=ids, use_native=True, layout=layout), dicts
        return TriangleBvh.build(mesh, use_native=True, layout=layout), None
    if args.scene == "obj" and args.obj:
        return TriangleBvh.with_obj(args.obj, layout=layout), None
    if args.scene == "obj":
        print("no --obj given; rendering procedural sphere", file=sys.stderr)
    return TriangleBvh.build(procedural.make_uv_sphere(1.0, rings=32, segments=64), layout=layout), None


def quantize_for_layout(args, bvh) -> bool:
    """Under ``--layout q16``, build the quantized layout on ``args.device``
    before the render (the tree caches it); False, with the reason on
    standard error, where the tree cannot take it (spatial splits, material
    ids above 65535). True for the other layouts, which build nothing here."""
    if bvh.layout != "q16":
        return True
    try:
        bvh.quantized_scene(args.device)
    except ValueError as e:
        print(f"--layout q16: {e}", file=sys.stderr)
        return False
    return True


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.trace_out is None:
        return _run(args)
    from minipath_tpu_torch.utils import profiling

    profiling.enable()
    try:
        return _run(args)
    finally:
        profiling.disable()
        profiling.export_chrome_trace(profiling.take(), args.trace_out)
        print(f"saved {args.trace_out}", file=sys.stderr)


def _run(args) -> int:
    from minipath_tpu_torch import Camera, RenderSettings, Scene, render
    from minipath_tpu_torch.utils.image import save_png

    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("--device cuda: no CUDA device is available", file=sys.stderr)
            return 2

    if args.sobol and args.iid:
        print("--sobol and --iid are mutually exclusive", file=sys.stderr)
        return 2
    mesh = None
    if args.devices != 1:
        from minipath_tpu_torch.parallel import make_device_mesh

        try:
            mesh = make_device_mesh(args.devices or None, args.device)
        except ValueError as e:
            print(f"--devices {args.devices}: {e}", file=sys.stderr)
            return 2
        if len(mesh) == 1:
            mesh = None
    if args.adaptive and args.integrator == "pt" and mesh is None and args.spp < ADAPTIVE_PILOT + ADAPTIVE_CHUNK:
        print(f"--adaptive needs --spp >= {ADAPTIVE_PILOT + ADAPTIVE_CHUNK} (a {ADAPTIVE_PILOT}-spp pilot and one "
              f"{ADAPTIVE_CHUNK}-sample chunk)", file=sys.stderr)
        return 2
    bvh, material_dicts = load_scene(args)
    if not args.no_stats:
        bvh.print_statistics()
    if not quantize_for_layout(args, bvh):
        return 2

    camera = (
        Camera()
        .look_at(tuple(args.camera_from), tuple(args.camera_to))
        .f_number(args.f_number)
        .focus_distance(args.focus)
    )
    if args.integrator == "pt":
        return _render_pt(args, bvh, camera, material_dicts, mesh)
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
        device=args.device, seed=args.seed, mesh=mesh,
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
        f"rendered {args.width}x{args.height} @ {spp} spp on {_where(args, mesh)} in {elapsed:.2f}s "
        f"({rays / elapsed / 1e6:.1f} Mrays/s)",
        file=sys.stderr,
    )
    save_png(args.output, progress.image())
    print(f"saved {args.output}", file=sys.stderr)
    return 0


def _where(args, mesh) -> str:
    return args.device if mesh is None else f"{len(mesh)} x {args.device}"


def _render_pt(args, bvh, camera, material_dicts, mesh=None) -> int:
    """Path-traced whole frame, gamma 2.2: under a sky environment, or none
    for the two rooms, whose only light is their panel; sharded over
    ``mesh`` when one is given, else adaptive under ``--adaptive``."""
    import numpy as np
    import torch

    from minipath_tpu_torch.render.adaptive import render_frame_pt_adaptive
    from minipath_tpu_torch.render.wavefront import make_pt_shadow_tracer, make_pt_tracer, render_frame_pt
    from minipath_tpu_torch.scene.materials import Environment, build_light_table, lambertian, material_table
    from minipath_tpu_torch.utils.image import color_to_image, save_png

    device = torch.device(args.device)
    table = material_table(material_dicts if material_dicts is not None else [lambertian((0.73, 0.73, 0.73))],
                           device)
    scene = bvh.pt_scene(device)
    stack = bvh.recommended_stack_size
    tracer, _ = make_pt_tracer(scene, stack_size=stack)
    shadow_tracer = lights = None
    if args.nee:
        lights = build_light_table(bvh.host_arrays.tri_packets, bvh.host_arrays.tri_material, table)
        if lights is None:
            print("--nee: scene has no emissive triangles; continuing without light sampling", file=sys.stderr)
        else:
            shadow_tracer, _ = make_pt_shadow_tracer(scene, stack_size=stack)
    nee_depth = args.nee_depth if shadow_tracer is not None else None
    if args.nee_depth is not None and nee_depth is None:
        print("--nee-depth has no effect: requires --nee and an emissive scene; rendering without light "
              "sampling", file=sys.stderr)
    sampler = camera.build_sampler((args.width, args.height), device)
    env = Environment.none(device) if args.scene == "tworooms" else Environment.sky(device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    common = dict(
        bounces=args.bounces,
        compaction=not args.no_compaction,
        lights=lights,
        shadow_tracer=shadow_tracer,
        shadow_rr=not args.no_shadow_rr,
        nee_max_depth=nee_depth,
        rr_start=args.rr_start,
    )
    t0 = time.perf_counter()
    if args.adaptive and mesh is not None:
        print("--adaptive is single-device only; rendering uniform spp across the mesh", file=sys.stderr)
    if args.adaptive and mesh is None:
        if args.sobol:
            print("--sobol with --adaptive is not supported; rendering with jittered strata", file=sys.stderr)
        if args.denoise:
            print("--denoise with --adaptive uses the fixed-sigma filter (no variance buffer)", file=sys.stderr)
        img = render_frame_pt_adaptive(
            tracer, scene, table, sampler, generator, width=args.width, height=args.height, spp=args.spp,
            env=env, pilot_spp=ADAPTIVE_PILOT, samples_per_packet=ADAPTIVE_CHUNK,
            stratify=not args.iid, **common,
        )
    else:
        img = render_frame_pt(
            tracer,
            scene,
            table,
            sampler,
            generator,
            width=args.width,
            height=args.height,
            spp=args.spp,
            env=env,
            samples_per_packet=min(8, args.spp),
            rr_floor=args.rr_floor,
            min_live_frac=args.tail_cut,
            stratify=not args.iid,
            sobol=args.sobol,
            return_variance=args.denoise and args.spp >= 2,
            clamp=args.clamp,
            mesh=mesh,
            **common,
        )
    var_img = None
    if isinstance(img, tuple):
        img, var_img = img
    a = img.cpu().numpy()
    elapsed = time.perf_counter() - t0
    paths = args.width * args.height * args.spp
    print(
        f"path traced {args.width}x{args.height} @ {args.spp} spp, {args.bounces} bounces on {_where(args, mesh)} "
        f"in {elapsed:.2f}s ({paths / elapsed / 1e6:.1f} Mpaths/s)",
        file=sys.stderr,
    )
    if args.denoise or args.aov:
        from minipath_tpu_torch.render.denoise import atrous_denoise, render_aux

        n_img, z_img = render_aux(
            tracer, scene, camera.build_sampler((args.width, args.height), device),
            torch.Generator(device=device).manual_seed(args.seed + 1),
            width=args.width, height=args.height,
        )
        if args.denoise:
            a[..., :3] = atrous_denoise(img[..., :3], n_img, z_img, var_img).cpu().numpy()
            kind = "variance-guided" if var_img is not None else "edge-avoiding"
            print(f"denoised ({kind} a-trous)", file=sys.stderr)
        if args.aov:
            n_np = n_img.cpu().numpy()
            hit = np.any(n_np != 0.0, axis=-1)
            n_vis = np.where(hit[..., None], n_np * 0.5 + 0.5, 0.0)
            save_png(
                f"{args.aov}_normal.png",
                color_to_image(np.concatenate([n_vis, hit[..., None].astype(np.float64)], -1)),
            )
            z_np = z_img.cpu().numpy()
            z_hit = z_np[hit] if hit.any() else np.array([0.0, 1.0])
            lo, hi = float(z_hit.min()), float(z_hit.max())
            # Near = bright, far = dark, normalized over the hit range.
            z_vis = np.where(hit, 1.0 - (z_np - lo) / max(hi - lo, 1e-6), 0.0).clip(0.0, 1.0)
            z_rgba = np.repeat(z_vis[..., None], 3, axis=-1)
            save_png(
                f"{args.aov}_depth.png",
                color_to_image(np.concatenate([z_rgba, np.ones_like(z_vis)[..., None]], -1)),
            )
            print(f"saved {args.aov}_normal.png, {args.aov}_depth.png", file=sys.stderr)
    a[..., :3] = np.clip(a[..., :3], 0.0, 1.0) ** (1 / 2.2)  # display gamma
    save_png(args.output, color_to_image(a))
    print(f"saved {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
