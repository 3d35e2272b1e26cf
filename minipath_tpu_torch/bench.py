"""Benchmark entry point of the port: Mrays/s on the atrium, 1920x1080 @ 64 spp.

Port of the repository's ``bench.py``, every rung at its full size, on one
card: ``python -m minipath_tpu_torch.bench [--device cuda] [--budget-s S]
[--out PATH]``.

Workload: the procedural atrium (about 250k triangles, the Sponza stand-in of
``scene/procedural.py``), written to a Wavefront OBJ once and loaded through
``TriangleBvh.with_obj`` (the native C++ loader and builder where ``g++`` is
present) with leaves of up to 24 triangles; the parity integrator, one
primary ray a sample. Rungs, in order:

* ``smoke``: ``trace_scene`` (K1) on 128x16 px x 4 samples of camera rays
  against the portable engine (``render/traversal.py``); past 0.1% hit
  mismatch or 1% relative t error the run exits 1 at once.
* ``f32``: the headline, ``render_frame`` with 32 samples a packet, one cold
  frame and 10 timed frames (mean, std, min, max).
* ``quantized``: the same frame over the 16-bit layout (K3), 3 frames.
* ``big_scene``: a 600k-triangle atrium through the same OBJ path, over the
  16-bit layout, 3 frames.
* ``pt_wavefront``, ``pt_nee``, ``pt_nee_capped``: the path tracer (K2) on the
  atrium with its materials, 960x540 @ 8 spp, 5 bounces, compaction; no NEE,
  NEE at every vertex, NEE at the first; 3 frames each.
* ``pt_1080p64_wavefront``, ``pt_1080p64_nee_capped``: 1920x1080 @ 64 spp in
  chunks of 2 spp; 1 and 2 frames.
* ``pt_big``: the path tracer over the 600k atrium's quantized lean layout
  (K3), grey Lambertian, 960x540 @ 8 spp; 2 frames.
* ``device_health``: ``utils/calibrate.py::device_health`` (K4 among its
  probes).

Where it departs from the JAX bench:

* Each rung prints its JSON line to stdout as soon as it finishes, and
  ``--budget-s`` stops the run before the next rung once that many seconds
  have passed; a line of its own names the rungs skipped.
* A rung that raises prints its error line and the later rungs still run,
  but the run exits 1. Nothing is reported as a number in its place.
* The layout's bytes take the place of the TPU's VMEM figures (``scene_mb``,
  and ``scene_budget_mb`` from ``scene/triangle_bvh.py``).
* Scenes are cached under ``.bench_cache/torch/``; the extra artifact is
  written only to the path given with ``--out``.
* ``--device`` defaults to ``cuda``; without a card the run fails at once.

The last line of stdout has the JAX bench's keys: ``metric``, ``value``
(Mrays/s of the headline), ``unit``, ``vs_baseline`` (against 100 Mrays/s)
and the path tracer's rates. Progress goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from minipath_tpu_torch.camera import Camera
from minipath_tpu_torch.geometry.ray import Rays
from minipath_tpu_torch.render import traversal
from minipath_tpu_torch.render.frame import gen_frame_rays9, render_frame
from minipath_tpu_torch.render.kernels import prepare_scene, prepare_scene_pt
from minipath_tpu_torch.render.kernels_q import QPTScene, prepare_scene_qpt, prepare_scene_quantized, trace_scene
from minipath_tpu_torch.render.wavefront import make_pt_shadow_tracer, make_pt_tracer, render_frame_pt
from minipath_tpu_torch.scene.bvh.build import BuildResult, BvhArrays, from_numpy

WIDTH, HEIGHT, SPP = 1920, 1080, 64
SAMPLES_PER_PACKET = 32
TIMED_FRAMES = 10
TARGET_MRAYS = 100.0
ATRIUM_TRIANGLES, BIG_TRIANGLES = 250_000, 600_000
# leaf_max=24 traces about 11% faster than the format's limit of 56 on this
# scene (a sweep on the TPU, tools/perf_leaf.py); kept for the same scenes.
LEAF_MAX = 24
# The path tracer's rungs: 960x540 @ 8 spp in one chunk, and the BASELINE
# headline 1920x1080 @ 64 spp in chunks of 2 spp.
PT_SIZE = (960, 540, 8)
PT_1080 = (1920, 1080, 64)
PT_1080_SAMPLES_PER_PACKET = 2
BOUNCES = 5
PT_PACKET = 2048
# The smoke test's rays: width x height px, samples a pixel, 16x16 blocks.
SMOKE = (128, 16, 4)
SMOKE_HIT_MISMATCH, SMOKE_T_RTOL = 1e-3, 1e-2
# Timed frames of each side rung, after one warm-up frame.
FRAMES = {
    "quantized": 3,
    "big_scene": 3,
    "pt": 3,
    "pt_1080p64_wavefront": 1,
    "pt_1080p64_nee_capped": 2,
    "pt_big": 2,
}
CACHE = Path(__file__).resolve().parent.parent / ".bench_cache" / "torch"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_camera() -> Camera:
    """Inside the atrium, down the colonnade."""
    return Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(36e-3)


def _save(path: Path, **arrays) -> None:
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)


def _arrays(data) -> BvhArrays:
    return BvhArrays(**{f: data[f] for f in BvhArrays._fields})


def build_obj_scene(n_triangles: int) -> BuildResult:
    """The atrium of ``n_triangles``, written to an OBJ once and built
    through ``TriangleBvh.with_obj`` (cached)."""
    from minipath_tpu_torch.scene.obj_loader import save_obj
    from minipath_tpu_torch.scene.procedural import make_atrium
    from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh

    CACHE.mkdir(parents=True, exist_ok=True)
    path = CACHE / f"atrium_obj_{n_triangles}.npz"
    if path.exists():
        log(f"loading cached {n_triangles}-triangle atrium BVH")
        data = np.load(path)
        return BuildResult(
            arrays=_arrays(data),
            triangle_count=int(data["meta_tris"]),
            vertex_count=int(data["meta_verts"]),
            max_depth=int(data["meta_depth"]),
        )
    obj_path = CACHE / f"atrium_{n_triangles}.obj"
    if not obj_path.exists():
        t0 = time.perf_counter()
        mesh = make_atrium(n_triangles)
        save_obj(obj_path, mesh)
        log(f"  {mesh.triangle_count} tris -> {obj_path} in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    result = TriangleBvh.with_obj(obj_path, leaf_max=LEAF_MAX).build_result
    log(f"  with_obj: {result.triangle_count} tris, depth={result.max_depth} in {time.perf_counter() - t0:.1f}s")
    _save(path, **result.arrays._asdict(), meta_tris=result.triangle_count, meta_verts=result.vertex_count,
          meta_depth=result.max_depth)
    return result


def build_pt_scene():
    """The atrium with its materials and lights, for the path tracer
    (cached): ``(host arrays, material table fields, stack size)``."""
    from minipath_tpu_torch.scene.bvh import native
    from minipath_tpu_torch.scene.bvh.build import build_bvh
    from minipath_tpu_torch.scene.materials import MaterialTable, material_table
    from minipath_tpu_torch.scene.procedural import atrium_materials, make_atrium

    CACHE.mkdir(parents=True, exist_ok=True)
    path = CACHE / f"atrium_pt_{ATRIUM_TRIANGLES}.npz"
    if path.exists():
        log("loading cached PT atrium BVH")
        data = np.load(path)
        return _arrays(data), {f: data[f"mat_{f}"] for f in MaterialTable._fields}, int(data["meta_stack"])
    log("building PT atrium (materials)...")
    mesh = make_atrium(ATRIUM_TRIANGLES)
    ids, dicts = atrium_materials(mesh)
    table = {f: v.numpy() for f, v in material_table(dicts, "cpu")._asdict().items()}
    build = native.build_bvh_native if native.is_available() else build_bvh
    res = build(mesh, materials=ids, leaf_max=LEAF_MAX)
    _save(path, **res.arrays._asdict(), **{f"mat_{f}": v for f, v in table.items()},
          meta_stack=res.recommended_stack_size)
    return res.arrays, table, res.recommended_stack_size


def scene_mb(scene) -> float:
    """Megabytes of a scene layout's tensors."""
    return round(sum(t.numel() * t.element_size() for t in scene if isinstance(t, torch.Tensor)) / 1e6, 1)


class Context:
    """What the rungs share: the device and the scenes, each built at its
    first use."""

    def __init__(self, device: torch.device):
        self.device = device
        self._made = {}

    def _once(self, key, make):
        if key not in self._made:
            self._made[key] = make()
        return self._made[key]

    def generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def parity(self):
        """``(BuildResult, device arrays, f32 KernelScene, sampler)``."""

        def make():
            result = build_obj_scene(ATRIUM_TRIANGLES)
            arrays = result.as_device(self.device)
            sampler = bench_camera().build_sampler((WIDTH, HEIGHT), self.device)
            return result, arrays, prepare_scene(arrays), sampler

        return self._once("parity", make)

    def big(self) -> BuildResult:
        return self._once("big", lambda: build_obj_scene(BIG_TRIANGLES))

    def pt(self):
        """``(scene, table, lights, tracer, shadow tracer, env)``."""

        def make():
            from minipath_tpu_torch.scene.materials import Environment, build_light_table, table_from_numpy

            arrays, fields, stack = build_pt_scene()
            scene = prepare_scene_pt(from_numpy(arrays._asdict(), self.device))
            table = table_from_numpy(fields, self.device)
            tracer, _ = make_pt_tracer(scene, stack_size=stack, packet_size=PT_PACKET)
            shadow, _ = make_pt_shadow_tracer(scene, stack_size=stack, packet_size=PT_PACKET)
            lights = build_light_table(arrays.tri_packets, arrays.tri_material, table)
            return scene, table, lights, tracer, shadow, Environment.sky(self.device)

        return self._once("pt", make)

    def sampler(self, width: int, height: int):
        return self._once(("sampler", width, height), lambda: bench_camera().build_sampler((width, height), self.device))


def coverage(img: torch.Tensor) -> float:
    """The share of pixels with a hit, fetched to the host: the frame's
    synchronisation point."""
    return float((img[..., 3] > 0).to(torch.float32).mean())


def parity_frame(ctx: Context, scene, stack: int):
    """``frame(seed) -> coverage`` over ``scene`` (K1's or K3's layout)."""
    sampler = ctx.parity()[3]

    def frame(seed: int) -> float:
        return coverage(render_frame(scene, sampler, ctx.generator(seed), width=WIDTH, height=HEIGHT, spp=SPP,
                                     stack_size=stack, samples_per_packet=SAMPLES_PER_PACKET))

    return frame


def time_frames(frame, n: int, label: str, first_seed: int = 100) -> dict:
    """Host seconds of ``n`` frames, each ending in a fetch to the host."""
    times, value = [], None
    for i in range(n):
        t0 = time.perf_counter()
        value = frame(first_seed + i)
        times.append(time.perf_counter() - t0)
        log(f"  {label} frame {i}: {times[-1]:.3f}s")
    arr = np.array(times)
    return {
        "mean_s": round(float(arr.mean()), 4),
        "std_s": round(float(arr.std()), 4),
        "min_s": round(float(arr.min()), 4),
        "max_s": round(float(arr.max()), 4),
        "n": n,
        "coverage": round(value, 4),
    }


def smoke_test(ctx: Context) -> dict:
    """Trace a small batch through the kernel and compare it with the
    portable engine; exit 1 at once on a regressed kernel."""
    result, arrays, scene, sampler = ctx.parity()
    stack = result.recommended_stack_size
    width, height, samples = SMOKE
    r9, _ = gen_frame_rays9(sampler, ctx.generator(42), width=width, height=height, px_block=(16, 16),
                            samples=samples)
    kh = trace_scene(scene, r9, stack_size=stack)
    got_tri, got_t = kh.tri.reshape(-1).cpu().numpy(), kh.t.reshape(-1).cpu().numpy()
    rays = Rays(*(r9[:, i:i + 3].transpose(1, 2) for i in (0, 3, 6)))
    want = traversal.trace_packets(arrays, rays, stack_size=stack)
    want_tri, want_t = want.tri.reshape(-1).cpu().numpy(), want.t.reshape(-1).cpu().numpy()
    hit_mismatch = float(((got_tri >= 0) != (want_tri >= 0)).mean())
    both = (got_tri >= 0) & (want_tri >= 0)
    t_err = float((np.abs(got_t[both] - want_t[both]) / np.maximum(np.abs(want_t[both]), 1e-3)).max(initial=0.0))
    if hit_mismatch > SMOKE_HIT_MISMATCH or t_err > SMOKE_T_RTOL or not both.any():
        log(f"SMOKE TEST FAILED: hit mismatch {hit_mismatch:.2%}, max rel t err {t_err:.2e}, "
            f"{int(both.sum())} hits on both sides (kernel vs portable engine)")
        raise SystemExit(1)
    return {"rays": int(got_tri.size), "hit_rate": round(float((want_tri >= 0).mean()), 4),
            "hit_mismatch": hit_mismatch, "max_rel_t_err": t_err}


def rung_f32(ctx: Context) -> dict:
    result, _, scene, _ = ctx.parity()
    frame = parity_frame(ctx, scene, result.recommended_stack_size)
    t0 = time.perf_counter()
    frame(0)
    cold = time.perf_counter() - t0
    log(f"  cold frame: {cold:.1f}s")
    stats = time_frames(frame, TIMED_FRAMES, "f32")
    return {
        "workload": f"atrium-from-OBJ {result.triangle_count} tris, {WIDTH}x{HEIGHT} @ {SPP} spp, "
                    f"parity integrator",
        "obj_loaded": True,
        "cold_frame_s": round(cold, 2),
        **stats,
        "mrays_per_s": round(WIDTH * HEIGHT * SPP / stats["mean_s"] / 1e6, 2),
        "scene_mb": scene_mb(scene),
    }


def rung_quantized(ctx: Context) -> dict:
    result = ctx.parity()[0]
    qscene = prepare_scene_quantized(result.arrays, ctx.device)
    frame = parity_frame(ctx, qscene, result.recommended_stack_size)
    frame(0)
    stats = time_frames(frame, FRAMES["quantized"], "quantized")
    return {**stats, "mrays_per_s": round(WIDTH * HEIGHT * SPP / stats["mean_s"] / 1e6, 2),
            "scene_mb": scene_mb(qscene)}


def bench_big_scene(ctx: Context) -> dict:
    """The Sponza-scale OBJ-loaded atrium over the 16-bit layout (K3)."""
    from minipath_tpu_torch.scene.triangle_bvh import scene_budget_bytes

    result = ctx.big()
    qscene = prepare_scene_quantized(result.arrays, ctx.device)
    frame = parity_frame(ctx, qscene, result.recommended_stack_size)
    t0 = time.perf_counter()
    frame(0)
    log(f"  big-scene cold frame: {time.perf_counter() - t0:.1f}s")
    stats = time_frames(frame, FRAMES["big_scene"], "big")
    budget = scene_budget_bytes(ctx.device)
    return {
        "workload": f"atrium-from-OBJ {result.triangle_count} tris (Sponza-scale), {WIDTH}x{HEIGHT} @ {SPP} spp, "
                    f"quantized kernel",
        "triangle_count": result.triangle_count,
        "obj_loaded": True,
        **stats,
        "mrays_per_s": round(WIDTH * HEIGHT * SPP / stats["mean_s"] / 1e6, 2),
        "scene_mb": scene_mb(qscene),
        "scene_budget_mb": None if budget is None else round(budget / 1e6, 1),
    }


def _pt_frame(ctx: Context, parts, size, samples_per_packet, nee, cap):
    """``frame(seed) -> image mean`` of the path tracer over ``parts``."""
    scene, table, lights, tracer, shadow, env = parts
    width, height, spp = size
    sampler = ctx.sampler(width, height)

    def frame(seed: int) -> float:
        img = render_frame_pt(
            tracer, scene, table, sampler, ctx.generator(seed), width=width, height=height, spp=spp,
            bounces=BOUNCES, env=env, samples_per_packet=samples_per_packet, compaction=True,
            lights=lights if nee else None, shadow_tracer=shadow if nee else None, nee_max_depth=cap,
        )
        value = float(img[..., :3].mean())
        if not math.isfinite(value):
            raise FloatingPointError(f"path-traced frame mean {value}")
        return value

    return frame


def _timed_pt(frame, n: int, first_seed: int, label: str):
    t0 = time.perf_counter()
    frame(0)
    log(f"  {label} warmup: {time.perf_counter() - t0:.1f}s")
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        frame(first_seed + i)
        times.append(time.perf_counter() - t0)
    return float(np.mean(times))


def bench_pt(ctx: Context, name: str, nee: bool, cap) -> dict:
    """One of the 540p path-tracer rungs (``name``: wavefront, nee,
    nee_capped). NEE at the first vertex only is the measured
    Monte-Carlo-efficiency optimum on the atrium's large visible panels (a
    sweep on the TPU, tools/sweep_pt17.py); unbiased."""
    width, height, spp = PT_SIZE
    frame = _pt_frame(ctx, ctx.pt(), PT_SIZE, spp, nee, cap)
    mean = _timed_pt(frame, FRAMES["pt"], 50, f"pt {name}")
    return {
        "workload": f"atrium PT {width}x{height} @ {spp}spp, {BOUNCES} bounces",
        f"{name}_mean_s": round(mean, 3),
        f"{name}_mpaths_per_s": round(width * height * spp / mean / 1e6, 3),
    }


def bench_pt_1080(ctx: Context, name: str, nee: bool) -> dict:
    """The BASELINE headline configuration of the path tracer, 1920x1080 @
    64 spp, NEE at the first vertex or none."""
    width, height, spp = PT_1080
    frame = _pt_frame(ctx, ctx.pt(), PT_1080, PT_1080_SAMPLES_PER_PACKET, nee, 1 if nee else None)
    mean = _timed_pt(frame, FRAMES[name], 70, name)
    return {
        "workload": f"atrium PT {width}x{height} @ {spp}spp, {BOUNCES} bounces",
        f"{name}_s": round(mean, 3),
        f"{name}_mpaths_per_s": round(width * height * spp / mean / 1e6, 3),
    }


def bench_pt_big(ctx: Context) -> dict:
    """The path tracer over the Sponza-scale atrium's quantized lean layout
    (K3)."""
    from minipath_tpu_torch.scene.materials import Environment, lambertian, material_table

    result = ctx.big()
    stack = result.recommended_stack_size
    scene = prepare_scene_qpt(result.arrays, ctx.device)
    if not isinstance(scene, QPTScene):
        raise TypeError(f"expected a QPTScene, got {type(scene).__name__}")
    tracer, _ = make_pt_tracer(scene, stack_size=stack, packet_size=PT_PACKET)
    parts = (scene, material_table([lambertian((0.73, 0.73, 0.73))], ctx.device), None, tracer, None,
             Environment.sky(ctx.device))
    width, height, spp = PT_SIZE
    frame = _pt_frame(ctx, parts, PT_SIZE, spp, False, None)
    mean = _timed_pt(frame, FRAMES["pt_big"], 60, "pt big (quantized lean)")
    return {
        "workload": f"big atrium PT (quantized lean kernel) {result.triangle_count} tris, {width}x{height} @ "
                    f"{spp}spp, {BOUNCES} bounces",
        "triangle_count": result.triangle_count,
        "mean_s": round(mean, 3),
        "mpaths_per_s": round(width * height * spp / mean / 1e6, 3),
        "scene_mb": scene_mb(scene),
    }


def rung_device_health(ctx: Context) -> dict:
    from minipath_tpu_torch.utils.calibrate import device_health

    return device_health(ctx.device)


RUNGS = (
    ("smoke", smoke_test),
    ("f32", rung_f32),
    ("quantized", rung_quantized),
    ("big_scene", bench_big_scene),
    ("pt_wavefront", lambda ctx: bench_pt(ctx, "wavefront", False, None)),
    ("pt_nee", lambda ctx: bench_pt(ctx, "nee", True, None)),
    ("pt_nee_capped", lambda ctx: bench_pt(ctx, "nee_capped", True, 1)),
    ("pt_1080p64_wavefront", lambda ctx: bench_pt_1080(ctx, "pt_1080p64_wavefront", False)),
    ("pt_1080p64_nee_capped", lambda ctx: bench_pt_1080(ctx, "pt_1080p64_nee_capped", True)),
    ("pt_big", bench_pt_big),
    ("device_health", rung_device_health),
)
PT_RUNGS = ("pt_wavefront", "pt_nee", "pt_nee_capped", "pt_1080p64_wavefront", "pt_1080p64_nee_capped")


def summary_line(results: dict) -> dict:
    """The JAX bench's last line from the rungs' results."""
    mrays = results.get("f32", {}).get("mrays_per_s")
    line = {
        "metric": "atrium_obj_1080p_64spp_throughput",
        "value": mrays,
        "unit": "Mrays/s",
        "vs_baseline": None if mrays is None else round(mrays / TARGET_MRAYS, 3),
    }
    pt = {k: v for name in PT_RUNGS for k, v in results.get(name, {}).items() if k != "workload"}
    for k in ("wavefront_mpaths_per_s", "nee_mpaths_per_s", "nee_capped_mpaths_per_s"):
        if k in pt:
            line[f"pt_{k}"] = pt[k]
    for k in ("pt_1080p64_wavefront_s", "pt_1080p64_wavefront_mpaths_per_s", "pt_1080p64_nee_capped_s",
              "pt_1080p64_nee_capped_mpaths_per_s"):
        if k in pt:
            line[k] = pt[k]
    if "mpaths_per_s" in results.get("pt_big", {}):
        line["pt_big_scene_mpaths_per_s"] = results["pt_big"]["mpaths_per_s"]
    return line


def extra_artifact(results: dict, errors: dict, skipped: list, device: str) -> dict:
    """The JAX bench's ``BENCH_extra.json`` content, with the port's keys."""
    f32, q = results.get("f32"), results.get("quantized")

    def part(name):
        return {"error": errors[name]} if name in errors else results.get(name, {})

    pt = {}
    for name in PT_RUNGS:
        pt.update({f"{name}_error": errors[name]} if name in errors else
                  {k: v for k, v in results.get(name, {}).items() if k != "workload"})
    stats = ("mean_s", "std_s", "min_s", "max_s", "n", "coverage", "mrays_per_s")
    return {
        "device": device,
        "workload": f32["workload"] if f32 else None,
        "obj_loaded": True,
        "cold_frame_s": f32["cold_frame_s"] if f32 else None,
        "f32_kernel": {k: f32[k] for k in stats} if f32 else part("f32"),
        "quantized_kernel": {k: q[k] for k in stats} if q else part("quantized"),
        "scene_mb": {"f32": f32["scene_mb"] if f32 else None, "quantized": q["scene_mb"] if q else None},
        "big_scene": part("big_scene"),
        "pt": pt,
        "pt_big_scene": part("pt_big"),
        "device_health": part("device_health"),
        "skipped": skipped,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Benchmark of minipath_tpu_torch on one card.")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda", help="torch device (default cuda)")
    parser.add_argument("--budget-s", type=float, default=None, metavar="S",
                        help="start no rung after S seconds; the rungs left are named as skipped")
    parser.add_argument("--out", type=Path, default=None, metavar="PATH",
                        help="also write the extra artifact (BENCH_extra.json's content) to PATH")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        log("--device cuda: no CUDA device is available")
        return 2
    device = torch.device(args.device)
    name = f"{device}: {torch.cuda.get_device_name(device)}" if device.type == "cuda" else str(device)
    log(f"device: {name}")

    ctx = Context(device)
    start = time.perf_counter()
    results, errors, skipped = {}, {}, []
    for i, (rung, run) in enumerate(RUNGS):
        if args.budget_s is not None and time.perf_counter() - start > args.budget_s:
            skipped = [r for r, _ in RUNGS[i:]]
            print(json.dumps({"skipped": skipped, "budget_s": args.budget_s,
                              "elapsed_s": round(time.perf_counter() - start, 1)}), flush=True)
            break
        log(f"rung {rung}...")
        t0 = time.perf_counter()
        try:
            out = run(ctx)
        except Exception as e:  # the later rungs still run; the exit code says so
            log(traceback.format_exc())
            errors[rung] = repr(e)
            print(json.dumps({"rung": rung, "error": repr(e)}), flush=True)
            continue
        results[rung] = out
        print(json.dumps({"rung": rung, "seconds": round(time.perf_counter() - t0, 2), **out}), flush=True)

    if args.out is not None:
        args.out.write_text(json.dumps(extra_artifact(results, errors, skipped, name), indent=2))
        log(f"wrote {args.out}")
    print(json.dumps(summary_line(results)), flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
