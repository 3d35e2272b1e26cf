#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``minipath_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Thirteen phases,
each printing its lines as it finishes; any failure raises and the script
exits non-zero. There is no CPU path: without a CUDA device it fails at once.

1. Device: the card's name and power limit.
2. Build: compiles the three CUDA sources (``csrc/traverse.cu``: K1, K2;
   ``csrc/traverse_q.cu``: K3; ``csrc/chain.cu``: K4, K5) with nvcc, all at
   once, and prints what ptxas says of each kernel (registers, stack frame,
   spills) and the chain kernels' multiplies and min/max in the SASS.
3. Kernel against its plain PyTorch version on the card, on the
   249,284-triangle procedural atrium: 16,384 coherent camera rays from the
   benchmark camera, 16,384 incoherent rays inside the atrium, and the first
   524,288 rays of one dispatch of the main path, made as ``render()`` makes
   them. Prints the agreement and the time of each version at these shapes,
   and the kernel's time at the whole dispatch.
4. Main path: ``render()`` of the atrium at 1920x1080 @ 64 spp in frame
   mode, once cold and once warm; the warm frame counts kernel launches.
5. CLI: ``python -m minipath_tpu_torch.cli --device cuda`` writes a PNG.

Phases 6-9 drive the path tracer on the path-traced atrium (the same
procedural scene with its benchmark materials, leaves of up to 24
triangles):

6. K2 (the lean trace of ``csrc/traverse.cu``) against its plain version on
   three sets of 524,288 rays taken from a 1920x1080 @ 2 spp wavefront as
   the bounce loop makes it (camera rays traced, scattered and compacted):
   bounce-1 rays closest-hit, the NEE shadow segments of their hits
   any-hit, and 64 packets rooted at the root's child subtrees; then K2 over
   the whole 4.18M-ray bounce-1 wavefront.
7. Main path: ``render_frame_pt`` at 1920x1080 @ 64 spp, 5 bounces, NEE at
   the first vertex, cold and warm (launches per mode, host syncs and peak
   memory of the warm frame); then 960x540 @ 8 spp with NEE at every vertex.
8. The same 64x64 Sobol frame on the card and on the CPU (plain versions).
9. CLI: ``--integrator pt --nee`` writes a PNG.

Phases 10-12 drive the 16-bit quantized layout (K3, ``csrc/traverse_q.cu``)
on bench.py's Sponza-scale atrium (``make_atrium(600_000)``, leaves of up to
24 triangles) and on the path-traced atrium of phases 6-9:

10. K3 against its plain version on the card, in its three modes: full
    closest-hit on the first 524,288 rays of a main-path dispatch of the big
    atrium (made as phase 3 makes them), lean closest-hit on phase 6's
    bounce-1 set and any-hit on its NEE shadow set, each beside K1 or K2 on
    the same rays and the f32 layout; then K3 and K1 over the whole
    dispatch, K3 and K2 over the whole bounce-1 wavefront.
11. Parity main path on the quantized layout (bench.py's
    ``bench_big_scene``): ``render_frame`` of the big atrium at 1920x1080 @
    64 spp, 32 samples per packet, cold and warm, and the same frame over
    the f32 layout; the two means agree within 1%.
12. Path tracer on the quantized layout: bench.py's ``bench_pt_big`` (the
    big atrium, grey Lambertian, sky, 960x540 @ 8 spp, 5 bounces); phase
    7's NEE-capped 1080p frame over the path-traced atrium's ``QPTScene``,
    its mean within 1% of phase 7's under the same seed; phase 8's Sobol
    frame on ``QPTScene``, card against CPU.

13. The chain kernels and the benchmark entry point: K4 (``csrc/chain.cu``,
    the device-health probe's chain) against its plain version bit for bit
    at (512, 128) x 1, 7, 64 and 65,536 iterations; K5 in float32 and
    bfloat16 at the tool's (256, 128) x 256 and at a card-filling (16384,
    128) x 4096, bit for bit, with times and bounds; ``device_health`` on the
    card (K4 launches counted), the bf16 tool's ``main`` (K5 launches
    counted); then ``python -m minipath_tpu_torch.bench --device cuda`` in a
    subprocess under a time budget, which must exit 0, print every rung's
    line and end with the JAX bench's keys.

``python3 chip_smoke.py --profile DIR`` also writes a ``torch.profiler``
summary of one warm path-traced frame to DIR, over the f32 layout (after
phase 9) and over the quantized one (after phase 12).

The line before the last is a JSON object describing each kernel (its time,
its plain version's time, its launches on the main path and its bound: the
larger of its operations over the card's peak rate for their type and its
bytes over the HBM rate); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
WIDTH, HEIGHT, SPP, TILE = 1920, 1080, 64, 64
RAYS_PER_SET = 16_384
# Packets of the main path's dispatch checked and timed against the plain
# version: 64 x 8192 = 524,288 rays.
DISPATCH_SLICE = 64
# Tolerances of the kernel against its plain version (same arithmetic order
# and IEEE steps, so all but ties agree exactly; the normal differs by
# rsqrtf against torch.rsqrt).
TRI_MATCH, T_RTOL, NORMAL_ATOL = 0.9999, 1e-5, 1e-4
# The path tracer's cells (bench.py's pt_1080p64_nee_capped and nee).
PT_WIDTH, PT_HEIGHT, PT_SPP, PT_BOUNCES = 1920, 1080, 64, 5
PT_PACKET = 2048
PT_SET_PACKETS = 256  # 256 x 2048 = 524,288 rays per K2 set
UV_ATOL = 1e-5
# Phase 8: the card against the CPU on one Sobol frame.
FRAME_PIXEL_ATOL, FRAME_PIXEL_SHARE, FRAME_MEAN_RTOL = 1e-3, 0.99, 5e-3
# Phases 11-12: a frame over the quantized layout against the f32 one.
LAYOUT_MEAN_RTOL = 0.01
# bench.py's Sponza-scale scene.
BIG_TRIANGLES = 600_000

# The card's published peaks (NVIDIA H100 SXM data sheet, 700 W): float32
# outside the tensor cores, and HBM bandwidth.
PEAK_FP32_OPS, PEAK_HBM_BYTES = 67e12, 3.35e12
# Float32 operations of one traversal step, counted in the kernels' sources.
# Slab test of one child box: 6 subtractions, 6 multiplies, 12 min/max, 1
# compare. Two-sided Moller-Trumbore of one triangle lane: 2 cross products
# (9 each), 3 dot products (5 each), a reciprocal, 3 subtractions, 3
# multiplies by 1/det and 6 compares (with u + v). K3 first decompresses:
# 6 multiplies and 6 adds per child box; 9 of each per lane's vertices and
# 6 subtractions for its edges.
SLAB_OPS, MT_OPS = 25, 48
COST = {
    # kernel: (ops per child box, ops per triangle lane, bytes per node row
    #          visited, per triangle packet's vertices, per distinct
    #          triangle hit (its normals and material, for the epilogue),
    #          and written per ray)
    "traverse": (SLAB_OPS, MT_OPS, 48 * 4 + 8 * 4, 72 * 4, 9 * 4 + 4, 4 + 4 + 12 + 4),
    "traverse_pt": (SLAB_OPS, MT_OPS, 48 * 4 + 8 * 4, 72 * 4, 0, 4 * 4),
    "traverse_q": (SLAB_OPS + 12, MT_OPS + 24, 32 * 4, 36 * 4, 9 + 2, 4 + 4 + 12 + 4),
    "traverse_q_lean": (SLAB_OPS + 12, MT_OPS + 24, 32 * 4, 36 * 4, 0, 4 * 4),
}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def bench_camera():
    from minipath_tpu_torch import Camera

    # The atrium benchmark camera: inside the hall, down the colonnade.
    return Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(36e-3)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs, after one
    warm-up run."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def traversal_bound(kernel, rows, r9, hits, **kw):
    """The least time the card could take for one traversal launch, as
    ``(ms, "operations" or "bytes", text)``: the larger of its float32
    operations over the FP32 peak and its bytes over the HBM rate. The
    operations come from the launch's own counters (inner visits x 8 child
    boxes, leaf packets x 8 lanes); the bytes are the rays read once, the
    outputs and counters written once, and each scene row the traversal
    touches read once, found by the plain traversal over ``rows`` (K1's
    layout; K3's decompressed rows keep its indices) with the launch's
    arguments ``kw``."""
    from minipath_tpu_torch.render import kernels

    slab, mt, node_b, packet_b, hit_b, out_b = COST[kernel]
    touched = {}
    kernels._traverse_reference(rows, r9, touched=touched, **kw)
    B, _, P = r9.shape
    ops = int(hits.inner_visits.sum()) * 8 * slab + int(hits.leaf_tests.sum()) * 8 * mt
    n_nodes, n_packets = int(touched["nodes"].sum()), int(touched["packets"].sum())
    n_hit = int(torch.unique(hits.tri[hits.tri >= 0]).numel())
    nbytes = B * P * (9 * 4 + out_b) + B * 3 * 4 + n_nodes * node_b + n_packets * packet_b + n_hit * hit_b
    op_ms, byte_ms = ops / PEAK_FP32_OPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    by = "operations" if op_ms >= byte_ms else "bytes"
    text = (f"bound {max(op_ms, byte_ms):.4f} ms by {by} ({ops / 1e9:.3f} Gop = {op_ms:.4f} ms; "
            f"{nbytes / 1e6:.2f} MB = {byte_ms:.4f} ms: {n_nodes} node rows, {n_packets} packets, {n_hit} hit "
            f"triangles)")
    return max(op_ms, byte_ms), by, text


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA GPU")
    import minipath_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("1 device", f"{torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | python {sys.version.split()[0]}")
    return smi


def phase_build():
    """The three sources at once, one nvcc each."""
    from concurrent.futures import ThreadPoolExecutor

    from minipath_tpu_torch.render import kernels, kernels_q
    from minipath_tpu_torch.utils import calibrate

    t0 = time.perf_counter()
    loaders = (kernels.load_library, kernels_q.load_library, calibrate.load_library)
    with ThreadPoolExecutor(len(loaders)) as pool:
        libs = [f.result() for f in [pool.submit(load) for load in loaders]]
    for built in libs:
        regs = [ln.strip() for ln in built.log.splitlines() if "registers" in ln or "spill" in ln]
        log("2 build", f"{built.path.name} nvcc {built.build_seconds:.2f}s | {' | '.join(regs)}")
    log("2 build", f"all three built and loaded in {time.perf_counter() - t0:.2f}s")
    log("2 build", f"chain kernels' SASS: {json.dumps(chain_sass_counts(libs[2].path))}")


def chain_sass_counts(library: Path) -> dict:
    """Multiplies (``HFMA2`` with a zero addend is one) and min/max of each
    chain kernel in the built library's SASS (``cuobjdump -sass``): the
    loop's body as the compiler unrolled it, its remainder loops and the few
    instructions before them."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = "bf16x2" if "nv_bfloat162" in name else "f32"
            counts[name] = {}
        elif name is not None:
            for op in ("FMUL", "FMNMX", "HMUL2", "HFMA2", "HMNMX2"):
                if re.search(rf"\b{op}\b", line):
                    counts[name][op] = counts[name].get(op, 0) + 1
    return counts


def dispatch_rays9(sampler, device, generator):
    """Camera rays of the main path's first dispatch, made as ``render()``
    makes them: the first batch of centre-out tiles, one pass of 32 spp,
    packets of 16x16 px x 32 samples, sample-major, jittered strata."""
    from minipath_tpu_torch.render import integrator
    from minipath_tpu_torch.render.machinery import (
        MAX_RAYS_PER_DISPATCH, PACKET_SHAPE, SAMPLES_PER_PASS,
    )
    from minipath_tpu_torch.screen_block import ScreenBlock

    tiles = ScreenBlock.with_size((0, 0), (WIDTH, HEIGHT)).tile_ordering(TILE, rng=np.random.default_rng(0))
    k = MAX_RAYS_PER_DISPATCH // (TILE * TILE * SAMPLES_PER_PASS)
    origins = torch.tensor(np.array([t.min for t in tiles[:k]], np.float32), device=device)
    return integrator.tile_batch_rays9(
        sampler, origins, generator, 12345,
        tile_shape=(TILE, TILE), packet_shape=PACKET_SHAPE, spp=SAMPLES_PER_PASS,
    )


def compare(name, got, want):
    """Agreement of the kernel's hits with the plain version's; raises on a
    disagreement beyond the tolerances."""
    same = got.tri == want.tri
    match = same.float().mean().item()
    t_rel = ((got.t - want.t).abs() / want.t.abs().clamp_min(1e-30))[same].max().item()
    t_abs = (got.t - want.t).abs()[same].max().item()
    n_abs = (got.normal - want.normal).abs()[same].max().item()
    mat_ok = torch.equal(got.material[same], want.material[same])
    ovf = (int(got.overflow.sum()), int(want.overflow.sum()))
    counters_ok = all(torch.equal(getattr(got, c), getattr(want, c)) for c in ("inner_visits", "leaf_tests"))
    n = got.t.numel()
    text = (f"{name} {tuple(got.t.shape)} = {n} rays: tri match {match:.6f}, hit rate "
            f"{(got.tri >= 0).float().mean().item():.4f}, max t rel err {t_rel:.3g}, max normal err "
            f"{n_abs:.3g}, materials equal {mat_ok}, overflow kernel/plain {ovf}, counters equal "
            f"{counters_ok}, inner visits/ray {got.inner_visits.sum().item() / n:.1f}, "
            f"leaf tests/ray {got.leaf_tests.sum().item() / n:.1f}")
    if match < TRI_MATCH or t_rel > T_RTOL or n_abs > NORMAL_ATOL or not mat_ok or ovf != (0, 0):
        raise AssertionError(f"kernel disagrees with its plain version on {name} rays: {text}")
    if not counters_ok:
        raise AssertionError(f"counters differ on {name} rays: {text}")
    return text, max(t_abs, n_abs)


def phase_kernel(bvh, device):
    from minipath_tpu_torch.camera import sample_rays
    from minipath_tpu_torch.geometry.ray import make_rays
    from minipath_tpu_torch.render import integrator, kernels

    scene = bvh.kernel_scene(device)
    stack = bvh.recommended_stack_size
    gen = torch.Generator(device=device).manual_seed(0)

    # Coherent: the central 128x128 pixels of the benchmark view, packets of
    # 16x16 pixels, one sample each.
    sampler = bench_camera().build_sampler((WIDTH, HEIGHT), device)
    pix = integrator.tile_pixel_packets((WIDTH // 2 - 64, HEIGHT // 2 - 64), (128, 128), (16, 16), device)
    coherent = kernels.rays_to_rays9(sample_rays(sampler, pix, gen))
    # Incoherent: origins inside the atrium's box, directions uniform.
    rng = np.random.default_rng(1)
    lo, hi = np.asarray(bvh.host_arrays.bbox_min), np.asarray(bvh.host_arrays.bbox_max)
    o = rng.uniform(lo + 0.5, hi - 0.5, (64, 256, 3)).astype(np.float32)
    d = rng.normal(size=(64, 256, 3)).astype(np.float32)
    incoherent = kernels.rays_to_rays9(make_rays(torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)))
    assert coherent.shape == incoherent.shape == (64, 9, RAYS_PER_SET // 64)
    # The main path's own dispatch, (4096, 9, 8192), and its first
    # DISPATCH_SLICE packets: enough blocks for several waves on the card,
    # few enough for the plain version.
    dispatch = dispatch_rays9(sampler, device, gen)
    part = dispatch[:DISPATCH_SLICE]

    results = {}
    for name, r9 in (("coherent", coherent), ("incoherent", incoherent), ("dispatch slice", part)):
        got = kernels.trace_packets(scene, r9, stack_size=stack)
        torch.cuda.synchronize()
        want = kernels.trace_packets_reference(scene, r9, stack_size=stack)
        text, err = compare(name, got, want)
        ms = cuda_ms(lambda: kernels.trace_packets(scene, r9, stack_size=stack), 20)
        plain_ms = cuda_ms(lambda: kernels.trace_packets_reference(scene, r9, stack_size=stack), 1)
        bound_ms, bound_by, bound = traversal_bound("traverse", scene, r9, got, stack_size=stack, t_max=math.inf,
                                                    live_packets=None)
        log("3 kernel", f"{text} | kernel {ms:.4f} ms, plain {plain_ms:.2f} ms | {bound}")
        results[name] = dict(ms=ms, plain_ms=plain_ms, err=err, bound_ms=bound_ms, bound_by=bound_by)

    n = dispatch.shape[0] * dispatch.shape[2]
    ms = cuda_ms(lambda: kernels.trace_packets(scene, dispatch, stack_size=stack), 5)
    log("3 kernel", f"main-path dispatch {tuple(dispatch.shape)} = {n} rays: kernel {ms:.3f} ms "
        f"= {n / ms / 1e3:.1f} Mrays/s (no plain version at this size: its stack alone is "
        f"{n * stack * 12 / 1e9:.0f} GB)")
    return results


def phase_main_path(bvh, device, smi):
    from minipath_tpu_torch import RenderSettings, Scene, render
    from minipath_tpu_torch.render import kernels

    settings = RenderSettings(TILE, SPP, (WIDTH, HEIGHT))
    camera = bench_camera()

    def frame():
        p = render(Scene(bvh), camera, settings, device=device)  # frame mode: no callbacks
        p.wait()
        img = p.image()
        snap = p.progress()
        if snap.finished != snap.total or snap.total != 30 * 17:
            raise AssertionError(f"{snap.finished}/{snap.total} tiles finished")
        if img.shape != (HEIGHT, WIDTH, 4) or img.dtype != np.uint8:
            raise AssertionError(f"image {img.shape} {img.dtype}")
        return p, img

    p_cold, img_cold = frame()
    kernels.trace_packets.launches = 0
    p, img = frame()
    launches = kernels.trace_packets.launches
    coverage = float((img[..., 3] > 0).mean())
    if launches == 0:
        raise AssertionError("the main path launched no traversal kernel")
    if not coverage > 0:
        raise AssertionError("the frame has no hit")
    seconds = p.elapsed()
    rays = WIDTH * HEIGHT * p.spp_effective
    timers = p.timings().summary()
    log("4 main path", f"render() {WIDTH}x{HEIGHT} @ {p.spp_effective} spp on {smi}: warm frame "
        f"{seconds:.3f} s = {rays / seconds / 1e6:.1f} Mrays/s (cold {p_cold.elapsed():.3f} s) | "
        f"kernel launches {launches} | alpha coverage {coverage:.4f}, mean value "
        f"{img[..., 0].mean() / 255:.4f} | warm == cold image: {np.array_equal(img, img_cold)} | "
        f"phases {json.dumps(timers)}")
    return launches


def phase_cli():
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "atrium.png"
        cmd = [sys.executable, "-m", "minipath_tpu_torch.cli", "--scene", "atrium", "--width", "512",
               "--height", "384", "--spp", "16", "--device", "cuda", "-q", "--no-stats", "-o", str(out)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0 or not out.exists():
            raise AssertionError(f"CLI failed (exit {proc.returncode}):\n{proc.stderr[-4000:]}")
        from PIL import Image

        img = np.asarray(Image.open(out))
        if img.shape != (384, 512, 4) or not (img[..., 3] > 0).any():
            raise AssertionError(f"CLI image {img.shape} has no hit")
        said = [ln for ln in proc.stderr.splitlines() if ln.startswith("rendered")]
        log("5 cli", f"exit 0 in {time.perf_counter() - t0:.1f}s, {out.name} {img.shape} | {' '.join(said)}")


def build_pt_atrium():
    """The path-traced atrium as bench.py builds it: ``make_atrium(250_000)``,
    ``atrium_materials``, leaves of up to 24 triangles."""
    from minipath_tpu_torch.scene.procedural import atrium_materials, make_atrium
    from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh

    t0 = time.perf_counter()
    mesh = make_atrium(250_000)
    ids, dicts = atrium_materials(mesh)
    bvh = TriangleBvh.build(mesh, materials=ids, leaf_max=24)
    stats = bvh.statistics()
    print(f"path-traced atrium: {stats['triangles']} triangles, {stats['inner_nodes']} inner nodes, max depth "
          f"{stats['max_depth']}, stack {bvh.recommended_stack_size}, {int((ids == 4).sum())} emissive triangles, "
          f"built in {time.perf_counter() - t0:.1f}s", flush=True)
    return bvh, dicts


def pt_parts(bvh, dicts, device, quantized=False):
    """``(scene, materials, lights, tracer, shadow_tracer)`` on ``device``,
    over the f32 layout (K2) or the quantized one (K3)."""
    from minipath_tpu_torch.render.wavefront import make_pt_shadow_tracer, make_pt_tracer
    from minipath_tpu_torch.scene.materials import build_light_table, material_table

    scene = bvh.quantized_pt_scene(device) if quantized else bvh.pt_scene(device)
    table = material_table(dicts, device)
    lights = build_light_table(bvh.host_arrays.tri_packets, bvh.host_arrays.tri_material, table)
    tracer, _ = make_pt_tracer(scene, stack_size=bvh.recommended_stack_size, packet_size=PT_PACKET)
    shadow, _ = make_pt_shadow_tracer(scene, stack_size=bvh.recommended_stack_size, packet_size=PT_PACKET)
    return scene, table, lights, tracer, shadow


def bounce1_wavefront(parts, device, gen):
    """The bounce-1 wavefront of one 1920x1080 @ 2 spp chunk of the main
    path's frame, made as ``_pt_trace`` makes it: strata camera rays traced
    with K2, scattered off their hits with ``scatter_full``, compacted.
    Returns ``(rays9, live_packets, live_rays)``."""
    from minipath_tpu_torch.render import wavefront as W
    from minipath_tpu_torch.render.frame import gen_frame_rays9

    scene, table, _, tracer, _ = parts
    samples, seed = 2, 12345
    sampler = bench_camera().build_sampler((PT_WIDTH, PT_HEIGHT), device)
    rays9, _ = gen_frame_rays9(sampler, gen, width=PT_WIDTH, height=PT_HEIGHT, px_block=(16, 16), samples=samples,
                               strat_spp=PT_SPP, strat_offset=0, strat_seed=seed)
    B0, _, P0 = rays9.shape
    N = B0 * P0
    flat = rays9.transpose(1, 2).reshape(N, 9)
    o, d = flat[:, 0:3], flat[:, 3:6]
    kh = tracer(scene, o, d, flat[:, 6:9])
    pixel = torch.arange(N, dtype=torch.int32, device=device)
    bp0, within = P0 // samples, pixel % P0
    strat = (within // bp0, ((pixel // P0) * bp0 + within % bp0) ^ seed, PT_SPP, 0)
    new_dir, _, _, terminate, _, _ = W.scatter_full(table, gen, d, kh.normal, kh.material, strat=strat)
    hit = kh.tri >= 0
    nf = torch.where((d * kh.normal).sum(-1, keepdim=True) < 0, kh.normal, -kh.normal)
    offset = torch.where((new_dir * nf).sum(-1, keepdim=True) >= 0, nf, -nf)
    new_o = o + d * kh.t[:, None] + offset * W._EPS
    h = hit[:, None]
    state = W._PathState(
        origin=torch.where(h, new_o, o), direction=torch.where(h, new_dir, d),
        inv_direction=torch.where(h, 1.0 / new_dir, flat[:, 6:9]),
        throughput=torch.ones_like(o), radiance=torch.zeros_like(o), pixel=pixel, active=hit & ~terminate,
    )
    state = W._compact(state, fine_direction=True)
    live = state.active.sum(dtype=torch.int32)
    r9, live_packets, _ = W._pack_rays9(PT_PACKET, live, state.origin, state.direction, state.inv_direction)
    return r9, live_packets, int(live)


def compare_pt(name, got, want, anyhit=False, kernel="K2"):
    """Agreement of a lean kernel's output (K2's or K3's) with its plain
    version's; raises beyond the tolerances. Any-hit: the occlusion masks
    must be equal."""
    n = got.t.numel()
    ovf = (int(got.overflow.sum()), int(want.overflow.sum()))
    counters_ok = all(torch.equal(getattr(got, c), getattr(want, c)) for c in ("inner_visits", "leaf_tests"))
    stats = (f"overflow kernel/plain {ovf}, counters equal {counters_ok}, inner visits/ray "
             f"{got.inner_visits.sum().item() / n:.1f}, leaf tests/ray {got.leaf_tests.sum().item() / n:.1f}")
    if anyhit:
        occ, wocc = got.tri >= 0, want.tri >= 0
        equal = torch.equal(occ, wocc)
        text = (f"{name} {tuple(got.t.shape)} = {n} rays: occluded masks equal {equal} "
                f"({int((occ != wocc).sum())} differ), occluded {occ.float().mean().item():.4f}, {stats}")
        if not equal or ovf != (0, 0) or not counters_ok:
            raise AssertionError(f"{kernel} any-hit disagrees with its plain version: {text}")
        return text, 0.0
    same = got.tri == want.tri
    match = same.float().mean().item()
    hit = same & (want.tri >= 0)
    t_rel = ((got.t - want.t).abs() / want.t.abs().clamp_min(1e-30))[hit].max().item()
    errs = [(getattr(got, f) - getattr(want, f)).abs()[hit].max().item() for f in ("t", "u", "v")]
    text = (f"{name} {tuple(got.t.shape)} = {n} rays: tri match {match:.6f}, hit rate "
            f"{(got.tri >= 0).float().mean().item():.4f}, max t rel err {t_rel:.3g}, max u/v err "
            f"{max(errs[1:]):.3g}, {stats}")
    if match < TRI_MATCH or t_rel > T_RTOL or max(errs[1:]) > UV_ATOL or ovf != (0, 0) or not counters_ok:
        raise AssertionError(f"{kernel} disagrees with its plain version: {text}")
    return text, max(errs)


def phase_k2(bvh, parts, device):
    from minipath_tpu_torch.render import kernels
    from minipath_tpu_torch.render import wavefront as W
    from minipath_tpu_torch.scene.bvh import links as L
    from minipath_tpu_torch.scene.materials import LAMBERTIAN, METAL, material_rows, sample_lights

    scene, table, lights, _, _ = parts
    ss = bvh.recommended_stack_size
    gen = torch.Generator(device=device).manual_seed(1)
    r9, live_packets, live_rays = bounce1_wavefront(parts, device, gen)
    n_live_pk = int(live_packets)
    if n_live_pk < PT_SET_PACKETS:
        raise AssertionError(f"bounce-1 wavefront has only {n_live_pk} live packets")
    # Set 1: 256 live packets spread evenly over the sorted wavefront.
    pick = torch.arange(PT_SET_PACKETS, device=device) * n_live_pk // PT_SET_PACKETS
    bounce = r9[pick].contiguous()
    out = {}

    def check(key, label, args, kw, anyhit=False):
        got = kernels.trace_packets_pt(scene, args, stack_size=ss, anyhit=anyhit, **kw)
        torch.cuda.synchronize()
        want = kernels.trace_packets_pt_reference(scene, args, stack_size=ss, anyhit=anyhit, **kw)
        text, err = compare_pt(label, got, want, anyhit)
        ms = cuda_ms(lambda: kernels.trace_packets_pt(scene, args, stack_size=ss, anyhit=anyhit, **kw), 20)
        plain_ms = cuda_ms(lambda: kernels.trace_packets_pt_reference(scene, args, stack_size=ss, anyhit=anyhit,
                                                                      **kw), 1)
        bound_ms, bound_by, bound = traversal_bound(
            "traverse_pt", scene, args, got, stack_size=ss, anyhit=anyhit,
            **{"t_max": math.inf, "live_packets": None, **kw},
        )
        log("6 k2", f"{text} | kernel {ms:.4f} ms, plain {plain_ms:.2f} ms | {bound}")
        out[key] = dict(ms=ms, plain_ms=plain_ms, err=err, bound_ms=bound_ms, bound_by=bound_by)
        return got

    hits = check("bounce1", "bounce-1 closest-hit", bounce, {})

    # Set 2: the NEE shadow segments of those hits, sorted and packed as the
    # bounce loop does ("pos" sort, candidates as a live prefix).
    flat = bounce.transpose(1, 2).reshape(-1, 9)
    o, d = flat[:, 0:3], flat[:, 3:6]
    tri = hits.tri.reshape(-1)
    normal, material, _ = W.shade_from_flat(scene.shade_flat, tri, hits.u.reshape(-1), hits.v.reshape(-1))
    nf = torch.where((d * normal).sum(-1, keepdim=True) < 0, normal, -normal)
    kind, fuzz, _, _ = material_rows(table, material)
    cand = ((kind == LAMBERTIAN) | ((kind == METAL) & (fuzz >= W.GLOSSY_MIN_FUZZ))) & (tri >= 0)
    sh_o = o + d * hits.t.reshape(-1)[:, None] + nf * W._EPS
    y, wi, pdf, _, cos_y, _ = sample_lights(lights, gen, sh_o)
    cand = cand & ((wi * nf).sum(-1) > 0) & (cos_y > 1e-6) & (pdf > 0)
    o_s, s_s, n_cand, _ = W._shadow_batch(cand, sh_o, y - wi * W._EPS - sh_o, wi)
    inv = torch.where(s_s == 0.0, torch.full_like(s_s, torch.inf), 1.0 / s_s)
    shadow9, live_s, _ = W._pack_rays9(PT_PACKET, n_cand, o_s, s_s, inv)
    log("6 k2", f"NEE shadow set: {int(n_cand)} candidate segments of {tri.numel()} hits "
        f"({int(live_s)} live packets)")
    check("shadow", "NEE shadow any-hit", shadow9, dict(t_max=W._SHADOW_T_MAX, live_packets=live_s), anyhit=True)

    # Set 3: 64 packets, each rooted at one of the root's child subtrees.
    child_links = bvh.host_arrays.node_child_links[int(bvh.host_arrays.root) >> L.COUNT_BITS]
    children = [int(c) for c in child_links if c != L.NULL_LINK]
    n_roots = min(64, PT_SET_PACKETS)
    roots = torch.tensor([children[i % len(children)] for i in range(n_roots)], dtype=torch.int32, device=device)
    check("roots", "per-packet roots", bounce[:n_roots].contiguous(), dict(roots=roots))

    ms = cuda_ms(lambda: kernels.trace_packets_pt(scene, r9, stack_size=ss, live_packets=live_packets), 5)
    log("6 k2", f"whole bounce-1 wavefront {tuple(r9.shape)}, {live_rays} live rays in {n_live_pk} packets: "
        f"kernel {ms:.3f} ms = {live_rays / ms / 1e3:.1f} Mrays/s")
    # Phase 10 traces the same sets with K3.
    sets = dict(bounce=bounce, shadow=(shadow9, live_s), wavefront=(r9, live_packets, live_rays))
    return out, sets


@functools.lru_cache(maxsize=None)
def frame_inputs(device, width, height):
    """The bench camera's sampler and the sky, made once per size: set-up,
    whose host-to-device copies stay out of a warm frame."""
    from minipath_tpu_torch.scene.materials import Environment

    return bench_camera().build_sampler((width, height), device), Environment.sky(device)


def render_pt(parts, device, width, height, spp, nee_max_depth, samples_per_packet, seed, lit=True):
    """One path-traced frame of the bench camera; returns ``(host image,
    seconds)``: host clock from the call to the image on the host. Raises
    on a non-finite image, and on a black one where the scene is ``lit``."""
    from minipath_tpu_torch.render.wavefront import render_frame_pt

    scene, table, lights, tracer, shadow = parts
    sampler, env = frame_inputs(device, width, height)
    gen = torch.Generator(device=device).manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render_frame_pt(
        tracer, scene, table, sampler, gen, width=width, height=height, spp=spp, bounces=PT_BOUNCES,
        env=env, samples_per_packet=samples_per_packet, compaction=True, lights=lights,
        shadow_tracer=shadow, nee_max_depth=nee_max_depth,
    ).cpu().numpy()
    seconds = time.perf_counter() - t0
    if img.shape != (height, width, 4) or not np.isfinite(img).all():
        raise AssertionError(f"path-traced image {img.shape} is not finite")
    if lit and not img[..., :3].mean() > 0:
        raise AssertionError("path-traced image is black")
    return img, seconds


def phase_pt_main_path(parts, device, smi):
    import warnings

    from minipath_tpu_torch.render import kernels

    paths = PT_WIDTH * PT_HEIGHT * PT_SPP
    _, cold = render_pt(parts, device, PT_WIDTH, PT_HEIGHT, PT_SPP, 1, 2, seed=0)
    for mode in kernels.trace_packets_pt.launches:
        kernels.trace_packets_pt.launches[mode] = 0
    torch.cuda.reset_peak_memory_stats(device)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            img, warm = render_pt(parts, device, PT_WIDTH, PT_HEIGHT, PT_SPP, 1, 2, seed=1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = dict(kernels.trace_packets_pt.launches)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    peak = torch.cuda.max_memory_allocated(device)
    if min(launches.values()) == 0:
        raise AssertionError(f"the path-traced frame did not launch K2 in every mode: {launches}")
    log("7 pt main path", f"render_frame_pt {PT_WIDTH}x{PT_HEIGHT} @ {PT_SPP} spp, {PT_BOUNCES} bounces, NEE at "
        f"depth 1, samples_per_packet 2 on {smi}: warm frame {warm:.3f} s = {paths / warm / 1e6:.2f} Mpaths/s "
        f"(cold {cold:.3f} s) | K2 launches {launches} | host syncs in the warm frame {syncs} | peak device memory {peak / 1e9:.2f} GB | image mean {img[..., :3].mean():.5f}, all "
        f"finite")

    w2, h2, spp2 = 960, 540, 8
    _, cold2 = render_pt(parts, device, w2, h2, spp2, None, spp2, seed=2)
    for mode in kernels.trace_packets_pt.launches:
        kernels.trace_packets_pt.launches[mode] = 0
    torch.cuda.reset_peak_memory_stats(device)
    img2, sec2 = render_pt(parts, device, w2, h2, spp2, None, spp2, seed=3)
    log("7 pt main path", f"render_frame_pt {w2}x{h2} @ {spp2} spp, {PT_BOUNCES} bounces, NEE at every vertex: "
        f"warm frame {sec2:.3f} s = {w2 * h2 * spp2 / sec2 / 1e6:.2f} Mpaths/s (cold {cold2:.3f} s) | K2 "
        f"launches {dict(kernels.trace_packets_pt.launches)} | peak device memory "
        f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB | image mean {img2[..., :3].mean():.5f}, "
        f"all finite")
    return sum(launches.values()), float(img[..., :3].mean())


def phase_card_vs_cpu(bvh, dicts, device, quantized=False, phase="8 card vs cpu"):
    """The same Sobol frame (every dimension a pure function of pixel,
    sample and seed; no roulette fires) on the card and on the CPU."""
    from minipath_tpu_torch.render.wavefront import render_frame_pt
    from minipath_tpu_torch.scene.materials import Environment

    def frame(dev):
        scene, table, lights, tracer, shadow = pt_parts(bvh, dicts, dev, quantized)
        t0 = time.perf_counter()
        img = render_frame_pt(
            tracer, scene, table, bench_camera().build_sampler((64, 64), dev), None, width=64, height=64, spp=4,
            bounces=3, env=Environment.sky(dev), samples_per_packet=4, lights=lights, shadow_tracer=shadow,
            sobol=True, shadow_rr=False, strat_seed=2024,
        ).cpu()
        return img, time.perf_counter() - t0

    got, t_card = frame(device)
    want, t_cpu = frame(torch.device("cpu"))
    close = ((got - want).abs().amax(dim=-1) <= FRAME_PIXEL_ATOL).float().mean().item()
    m_got, m_want = got[..., :3].mean().item(), want[..., :3].mean().item()
    rel = abs(m_got - m_want) / abs(m_want)
    text = (f"64x64 @ 4 spp Sobol, 3 bounces, NEE: pixels within {FRAME_PIXEL_ATOL} {close:.4f}, means card "
            f"{m_got:.6f} / cpu {m_want:.6f} (rel {rel:.2e}), max abs diff {(got - want).abs().max().item():.3g} | "
            f"card {t_card:.2f} s, cpu (plain versions) {t_cpu:.2f} s")
    if not torch.isfinite(got).all() or close < FRAME_PIXEL_SHARE or rel > FRAME_MEAN_RTOL:
        raise AssertionError(f"the card's frame disagrees with the CPU's: {text}")
    log(phase, text)


def phase_pt_cli():
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "atrium_pt.png"
        cmd = [sys.executable, "-m", "minipath_tpu_torch.cli", "--scene", "atrium", "--integrator", "pt", "--nee",
               "--width", "480", "--height", "270", "--spp", "8", "--device", "cuda", "--no-stats", "-o", str(out)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0 or not out.exists():
            raise AssertionError(f"CLI failed (exit {proc.returncode}):\n{proc.stderr[-4000:]}")
        from PIL import Image

        img = np.asarray(Image.open(out))
        if img.shape != (270, 480, 4) or not (img[..., :3] > 0).any():
            raise AssertionError(f"CLI image {img.shape} is empty")
        said = [ln for ln in proc.stderr.splitlines() if ln.startswith("path traced")]
        log("9 pt cli", f"exit 0 in {time.perf_counter() - t0:.1f}s, {out.name} {img.shape}, mean "
            f"{img[..., :3].mean():.1f}/255 | {' '.join(said)}")


def build_big_atrium(device):
    """bench.py's Sponza-scale atrium: ``make_atrium(600_000)``, leaves of up
    to 24 triangles, with its quantized layout on ``device``."""
    from minipath_tpu_torch.scene.bvh.quantize import root_frame
    from minipath_tpu_torch.scene.procedural import make_atrium
    from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh

    t0 = time.perf_counter()
    bvh = TriangleBvh.build(make_atrium(BIG_TRIANGLES), leaf_max=24)
    built = time.perf_counter() - t0
    t0 = time.perf_counter()
    q = bvh.quantized_scene(device)
    # K3 seeds its root entry with the stored box; the quantizer encoded the
    # root's children against root_frame(box). The two must be one box.
    box = q.root_box.cpu().numpy()
    if not np.array_equal(root_frame(box), box):
        raise AssertionError(f"root_frame(root_box) {root_frame(box)} differs from the stored root box {box}")
    stats = bvh.statistics()
    print(f"big atrium: {stats['triangles']} triangles, {stats['inner_nodes']} inner nodes, max depth "
          f"{stats['max_depth']}, stack {bvh.recommended_stack_size}, built in {built:.1f}s, quantized in "
          f"{time.perf_counter() - t0:.1f}s: {(q.node_q.numel() + q.tri_q.numel()) * 4 / 1e6:.1f} MB against "
          f"{bvh.f32_scene_bytes() / 1e6:.1f} MB for the f32 layout", flush=True)
    return bvh


def phase_k3(big, pt_bvh, pt_scene, sets, device):
    """K3 against its plain version in its three modes, and beside K1 or K2
    on the same rays over the f32 layout."""
    from minipath_tpu_torch.render import kernels, kernels_q
    from minipath_tpu_torch.render import wavefront as W

    out = {}

    def check(key, label, scene, r9, rival, rival_name, lean=False, anyhit=False, **kw):
        kw = {"stack_size": kw.pop("stack_size"), "t_max": math.inf, "live_packets": None, **kw}

        def run():
            return kernels_q.trace_packets_q(scene, r9, lean=lean, anyhit=anyhit, **kw)

        got = run()
        torch.cuda.synchronize()
        want = kernels_q.trace_packets_q_reference(scene, r9, lean=lean, anyhit=anyhit, **kw)
        if lean:
            text, err = compare_pt(label, got, want, anyhit, kernel="K3")
        else:
            text, err = compare(label, got, want)
        ms = cuda_ms(run, 20)
        rival_ms = cuda_ms(rival, 20)
        plain_ms = cuda_ms(lambda: kernels_q.trace_packets_q_reference(scene, r9, lean=lean, anyhit=anyhit, **kw), 1)
        bound_ms, bound_by, bound = traversal_bound(
            "traverse_q_lean" if lean else "traverse_q", kernels_q.decompressed_kernel_scene(scene), r9, got,
            anyhit=anyhit, **kw,
        )
        log("10 k3", f"{text} | K3 {ms:.4f} ms, plain {plain_ms:.2f} ms, {rival_name} on the same rays "
            f"{rival_ms:.4f} ms (K3/{rival_name} {ms / rival_ms:.3f}) | {bound}")
        out[key] = dict(ms=ms, plain_ms=plain_ms, rival_ms=rival_ms, err=err, bound_ms=bound_ms, bound_by=bound_by)

    # Full mode: the big atrium, a main-path dispatch's first 524,288 rays.
    ss = big.recommended_stack_size
    q, f32 = big.quantized_scene(device), big.kernel_scene(device)
    if not isinstance(f32, kernels.KernelScene):
        raise AssertionError("the big atrium's f32 layout should fit the card's budget")
    gen = torch.Generator(device=device).manual_seed(0)
    dispatch = dispatch_rays9(bench_camera().build_sampler((WIDTH, HEIGHT), device), device, gen)
    part = dispatch[:DISPATCH_SLICE]
    check("full", "full closest-hit, big-atrium dispatch slice", q, part,
          lambda: kernels.trace_packets(f32, part, stack_size=ss), "K1", stack_size=ss)
    n = dispatch.shape[0] * dispatch.shape[2]
    ms_q = cuda_ms(lambda: kernels_q.trace_packets_q(q, dispatch, stack_size=ss), 5)
    ms_f = cuda_ms(lambda: kernels.trace_packets(f32, dispatch, stack_size=ss), 5)
    log("10 k3", f"big-atrium main-path dispatch {tuple(dispatch.shape)} = {n} rays: K3 {ms_q:.3f} ms = "
        f"{n / ms_q / 1e3:.1f} Mrays/s, K1 {ms_f:.3f} ms = {n / ms_f / 1e3:.1f} Mrays/s")
    del dispatch, part

    # Lean modes: phase 6's sets through the path-traced atrium's QPTScene.
    ss = pt_bvh.recommended_stack_size
    qpt = pt_bvh.quantized_pt_scene(device)
    bounce = sets["bounce"]
    check("closest", "lean closest-hit, bounce-1 set", qpt, bounce,
          lambda: kernels.trace_packets_pt(pt_scene, bounce, stack_size=ss), "K2", lean=True, stack_size=ss)
    shadow9, live_s = sets["shadow"]
    check("anyhit", "lean any-hit, NEE shadow set", qpt, shadow9,
          lambda: kernels.trace_packets_pt(pt_scene, shadow9, stack_size=ss, t_max=W._SHADOW_T_MAX,
                                           live_packets=live_s, anyhit=True),
          "K2", lean=True, anyhit=True, stack_size=ss, t_max=W._SHADOW_T_MAX, live_packets=live_s)
    r9, live_packets, live_rays = sets["wavefront"]
    ms_q = cuda_ms(lambda: kernels_q.trace_packets_q(qpt, r9, stack_size=ss, live_packets=live_packets, lean=True), 5)
    ms_f = cuda_ms(lambda: kernels.trace_packets_pt(pt_scene, r9, stack_size=ss, live_packets=live_packets), 5)
    log("10 k3", f"whole bounce-1 wavefront, {live_rays} live rays: K3 {ms_q:.3f} ms = {live_rays / ms_q / 1e3:.1f} "
        f"Mrays/s, K2 {ms_f:.3f} ms = {live_rays / ms_f / 1e3:.1f} Mrays/s")
    return out


def reset_q_launches():
    from minipath_tpu_torch.render import kernels_q

    for mode in kernels_q.trace_packets_q.launches:
        kernels_q.trace_packets_q.launches[mode] = 0


def phase_q_main_path(big, device, smi):
    """bench.py's bench_big_scene on the port: the parity frame of the big
    atrium through ``render_frame`` over the quantized layout, against the
    same frame (same seed, so the same camera rays) over the f32 one."""
    from minipath_tpu_torch.render import kernels_q
    from minipath_tpu_torch.render.frame import render_frame

    sampler, _ = frame_inputs(device, WIDTH, HEIGHT)
    ss = big.recommended_stack_size

    def frame(scene, seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render_frame(scene, sampler, gen, width=WIDTH, height=HEIGHT, spp=SPP, stack_size=ss,
                           samples_per_packet=32).cpu().numpy()
        seconds = time.perf_counter() - t0
        if img.shape != (HEIGHT, WIDTH, 4) or not np.isfinite(img).all() or not (img[..., 3] > 0).any():
            raise AssertionError(f"parity frame {img.shape} is not finite or has no hit")
        return img, seconds

    q, f32 = big.quantized_scene(device), big.kernel_scene(device)
    _, cold = frame(q, 0)
    reset_q_launches()
    img_q, warm = frame(q, 1)
    launches = dict(kernels_q.trace_packets_q.launches)
    _, cold_f = frame(f32, 0)
    img_f, warm_f = frame(f32, 1)
    if launches["full"] == 0:
        raise AssertionError("the quantized parity frame launched no K3")
    m_q, m_f = float(img_q[..., 0].mean()), float(img_f[..., 0].mean())
    shift = (m_q - m_f) / m_f
    rays = WIDTH * HEIGHT * SPP
    text = (f"render_frame {WIDTH}x{HEIGHT} @ {SPP} spp, 32 samples per packet, on {smi}: quantized warm "
            f"{warm:.3f} s = {rays / warm / 1e6:.1f} Mrays/s (cold {cold:.3f} s), K3 launches {launches} | f32 warm "
            f"{warm_f:.3f} s = {rays / warm_f / 1e6:.1f} Mrays/s (cold {cold_f:.3f} s) | mean value quantized "
            f"{m_q:.6f} / f32 {m_f:.6f} (shift {shift:+.3e}), alpha coverage {float(img_q[..., 3].mean()):.4f} / "
            f"{float(img_f[..., 3].mean()):.4f}, pixels within 1e-2 {float((np.abs(img_q - img_f).max(-1) <= 1e-2).mean()):.4f}")
    if abs(shift) > LAYOUT_MEAN_RTOL:
        raise AssertionError(f"the quantized frame's mean is off the f32 frame's: {text}")
    log("11 q main path", text)
    return launches


def phase_q_pt(big, pt_bvh, dicts, device, smi, f32_mean):
    """The path tracer over the quantized layout: bench.py's bench_pt_big,
    then phase 7's NEE-capped frame over the path-traced atrium's QPTScene,
    then phase 8's Sobol frame on the card and the CPU."""
    from minipath_tpu_torch.render import kernels_q
    from minipath_tpu_torch.render.wavefront import make_pt_tracer
    from minipath_tpu_torch.scene.materials import lambertian, material_table

    table = material_table([lambertian((0.73, 0.73, 0.73))], device)

    def big_parts(scene):
        tracer, _ = make_pt_tracer(scene, stack_size=big.recommended_stack_size, packet_size=PT_PACKET)
        return scene, table, None, tracer, None

    # The hall is a closed shell and this workload has no emitter, so no
    # path reaches the sky and the frame is black on either layout: it
    # measures traversal and the bounce loop, and its check is the f32
    # frame under the same seed.
    parts = big_parts(big.quantized_pt_scene(device))
    w, h, spp = 960, 540, 8
    _, cold = render_pt(parts, device, w, h, spp, None, spp, seed=60, lit=False)
    reset_q_launches()
    img, warm = render_pt(parts, device, w, h, spp, None, spp, seed=61, lit=False)
    launches = dict(kernels_q.trace_packets_q.launches)
    img_f, warm_f = render_pt(big_parts(big.pt_scene(device)), device, w, h, spp, None, spp, seed=61, lit=False)
    if launches["closest"] == 0:
        raise AssertionError("the big path-traced frame launched no K3")
    m_q, m_f = float(img[..., :3].mean()), float(img_f[..., :3].mean())
    text = (f"bench_pt_big: render_frame_pt of the big atrium, grey Lambertian, sky, {w}x{h} @ {spp} spp, "
            f"{PT_BOUNCES} bounces on {smi}: warm {warm:.3f} s = {w * h * spp / warm / 1e6:.2f} Mpaths/s (cold "
            f"{cold:.3f} s) | K3 launches {launches} | f32 layout, same seed: {warm_f:.3f} s | image mean "
            f"{m_q:.6f} / f32 {m_f:.6f}, all finite")
    if abs(m_q - m_f) > LAYOUT_MEAN_RTOL * abs(m_f) + 1e-6:
        raise AssertionError(f"the quantized frame's mean is off the f32 frame's: {text}")
    log("12 q pt", text)

    parts = pt_parts(pt_bvh, dicts, device, quantized=True)
    reset_q_launches()
    img, warm = render_pt(parts, device, PT_WIDTH, PT_HEIGHT, PT_SPP, 1, 2, seed=1)
    nee_launches = dict(kernels_q.trace_packets_q.launches)
    if nee_launches["closest"] == 0 or nee_launches["anyhit"] == 0:
        raise AssertionError(f"the NEE frame did not launch K3 in both lean modes: {nee_launches}")
    m_q = float(img[..., :3].mean())
    shift = (m_q - f32_mean) / f32_mean
    text = (f"render_frame_pt {PT_WIDTH}x{PT_HEIGHT} @ {PT_SPP} spp, {PT_BOUNCES} bounces, NEE at depth 1 over "
            f"the path-traced atrium's QPTScene: warm {warm:.3f} s = {PT_WIDTH * PT_HEIGHT * PT_SPP / warm / 1e6:.2f} "
            f"Mpaths/s | K3 launches {nee_launches} | image mean {m_q:.5f} against phase 7's {f32_mean:.5f} under "
            f"the same seed (shift {shift:+.3e})")
    if abs(shift) > LAYOUT_MEAN_RTOL:
        raise AssertionError(f"the quantized path-traced frame's mean is off the f32 frame's: {text}")
    log("12 q pt", text)
    phase_card_vs_cpu(pt_bvh, dicts, device, quantized=True, phase="12 q pt")
    return {m: launches[m] + nee_launches[m] for m in launches}


# Phase 13: the chain kernels' checks and shapes. K4 at the device-health
# probe's shape; K5 at the bf16 tool's default and at a card-filling shape.
CHAIN_CHECK_ITERS = (1, 7, 64, 65536)
K5_SHAPES = {"default": ((256, 128), 256), "card-filling": ((16384, 128), 4096)}
# One element and iteration of the chain executes two multiplies and a min and
# a max (``a * 0.5`` is hoisted), and the SASS holds them as FMUL and FMNMX
# (f32) or HMUL2/HFMA2 and HMNMX2 (bf16x2, two elements a lane). Results per
# clock and SM on compute capability 9.0 (the CUDA C++ Programming Guide's
# throughput table): 128 for a float32 multiply, 64 for compare, minimum and
# maximum; 256 for a 16-bit multiply. No rate is listed for HMNMX2: taken as
# twice FMNMX's, two results a lane.
CHAIN_MULS, CHAIN_MINMAX, SMS = 2, 2, 132
CHAIN_RATES = {torch.float32: (128, 64), torch.bfloat16: (256, 128)}  # (multiply, min/max)
BENCH_BUDGET_S, BENCH_TIMEOUT_S = 420, 600
# The last line of the JAX bench (bench.py:587-611), all rungs run.
JAX_BENCH_KEYS = [
    "metric", "value", "unit", "vs_baseline", "pt_wavefront_mpaths_per_s", "pt_nee_mpaths_per_s",
    "pt_nee_capped_mpaths_per_s", "pt_1080p64_wavefront_s", "pt_1080p64_wavefront_mpaths_per_s",
    "pt_1080p64_nee_capped_s", "pt_1080p64_nee_capped_mpaths_per_s", "pt_big_scene_mpaths_per_s",
]


def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def chain_bound(shape, iters, dtype, clock_hz):
    """The least time of one chain call, as ``(ms, "operations" or
    "bytes", text)``: its multiplies and min/max at the card's documented
    rates for them at the maximum SM clock, against its input read once and
    its output written once over the HBM rate."""
    n = shape[0] * shape[1]
    mul_rate, minmax_rate = CHAIN_RATES[dtype]
    clocks = n * iters * (CHAIN_MULS / mul_rate + CHAIN_MINMAX / minmax_rate) / SMS
    lane_ops = n * iters * (CHAIN_MULS + CHAIN_MINMAX)
    nbytes = 2 * n * (4 if dtype == torch.float32 else 2)
    op_ms, byte_ms = clocks / clock_hz * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    by = "operations" if op_ms >= byte_ms else "bytes"
    text = (f"bound {max(op_ms, byte_ms):.5f} ms by {by} ({lane_ops / 1e9:.3f} G multiplies and min/max = "
            f"{op_ms:.5f} ms; {nbytes / 1e6:.3f} MB = {byte_ms:.5f} ms)")
    return max(op_ms, byte_ms), by, text


def check_chain(label, shape, dtype, iters, device, clock_hz, reps=20):
    """One chain kernel call against its plain version on the same input,
    bit for bit; returns its times and bound."""
    from minipath_tpu_torch.utils import calibrate

    x = calibrate.chain_input(shape, dtype, device)
    got = calibrate.vpu_chain(x, iters)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = calibrate.vpu_chain_reference(x, iters)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    equal = torch.equal(got.view(bits), want.view(bits))
    err = (got.float() - want.float()).abs().max().item()
    ms = cuda_ms(lambda: calibrate.vpu_chain(x, iters), reps)
    bound_ms, bound_by, bound = chain_bound(shape, iters, dtype, clock_hz)
    text = (f"{label} {str(dtype).removeprefix('torch.')} {shape} x {iters}: bit for bit {equal}, max abs err "
            f"{err:.3g}, kernel {ms:.5f} ms, plain {plain_ms:.2f} ms | {bound} | kernel at "
            f"{bound_ms / ms:.1%} of it")
    if not equal or not torch.isfinite(got.float()).all():
        raise AssertionError(f"the chain kernel disagrees with its plain version: {text}")
    log("13 chain", text)
    return dict(ms=ms, plain_ms=plain_ms, err=err, bound_ms=bound_ms, bound_by=bound_by)


def phase_chain(device, smi):
    """K4 and K5 against their plain version, then their main paths:
    ``device_health`` (K4) and the bf16 tool (K5), launches counted."""
    import contextlib
    import io

    from minipath_tpu_torch.tools import microbench_vpu_bf16 as tool
    from minipath_tpu_torch.utils import calibrate

    clock = max_sm_clock_hz()
    log("13 chain", f"max SM clock {clock / 1e9:.3f} GHz on {smi}")
    k4 = {n: check_chain("K4", calibrate.CHAIN_SHAPE, torch.float32, n, device, clock) for n in CHAIN_CHECK_ITERS}
    k5 = {}
    for key, (shape, iters) in K5_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            k5[key, dtype] = check_chain(f"K5 {key}", shape, dtype, iters, device, clock)
    for key in K5_SHAPES:
        f32, bf16 = k5[key, torch.float32]["ms"], k5[key, torch.bfloat16]["ms"]
        log("13 chain", f"K5 {key}: bf16 speedup over f32 {f32 / bf16:.3f}x")

    # The wrappers' host time a launch, beside one Path.resolve() (which the
    # library lookup avoids): what a launch costs where the kernel is short.
    x = calibrate.chain_input((256, 128), torch.float32, device)
    host_us = {}
    for name, fn in (("Path.resolve", calibrate._SOURCE.resolve), ("vpu_chain, 1 iteration",
                                                                    lambda: calibrate.vpu_chain(x, 1))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        host_us[name] = round((time.perf_counter() - t0) / 200 * 1e6, 2)
    log("13 chain", f"host microseconds a call: {json.dumps(host_us)}")

    calibrate.vpu_chain.launches.update(float32=0, bfloat16=0)
    health = calibrate.device_health("cuda")
    k4_launches = calibrate.vpu_chain.launches["float32"]
    missing = [k for k, v in health.items() if v is None]
    if missing or k4_launches == 0:
        raise AssertionError(f"device_health: null {missing}, K4 launches {k4_launches}: {health}")
    log("13 chain", f"device_health on {smi}: {json.dumps(health)} | K4 launches {k4_launches}")

    calibrate.vpu_chain.launches.update(float32=0, bfloat16=0)
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        rc = tool.main(["--device", "cuda"])
    k5_launches = dict(calibrate.vpu_chain.launches)
    if rc != 0 or min(k5_launches.values()) == 0:
        raise AssertionError(f"the bf16 tool exited {rc} with K5 launches {k5_launches}")
    log("13 chain", f"tool main: {' | '.join(said.getvalue().splitlines())} | K5 launches {k5_launches}")
    return k4, k4_launches, k5, k5_launches, health


def phase_bench(smi):
    """``python -m minipath_tpu_torch.bench --device cuda`` under a time
    budget: exit 0, every rung's line, the JAX bench's keys last."""
    from minipath_tpu_torch import bench

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        extra = Path(tmp) / "extra.json"
        cmd = [sys.executable, "-m", "minipath_tpu_torch.bench", "--device", "cuda", "--budget-s",
               str(BENCH_BUDGET_S), "--out", str(extra)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
        for line in lines:
            log("13 bench", json.dumps(line))
        rungs = [ln.get("rung") for ln in lines if "rung" in ln and "error" not in ln]
        want = [name for name, _ in bench.RUNGS]
        if proc.returncode != 0 or rungs != want or not lines or list(lines[-1]) != JAX_BENCH_KEYS:
            raise AssertionError(f"bench exited {proc.returncode}, rungs {rungs}:\n{proc.stderr[-4000:]}")
        artifact = json.loads(extra.read_text())
    log("13 bench", f"exit 0 in {seconds:.1f}s on {smi}, every rung's line, last line keys {list(lines[-1])}, "
        f"artifact keys {list(artifact)}")


def profile_pt_frame(parts, device, out_dir: Path, name="pt"):
    """A ``torch.profiler`` trace of one warm path-traced frame; writes the
    per-kernel table and a summary by kind to ``out_dir`` as
    ``profile_<name>.txt`` and ``profile_<name>.json``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, seconds = render_pt(parts, device, PT_WIDTH, PT_HEIGHT, PT_SPP, 1, 2, seed=4)
    kinds = {}
    intervals = []
    for evt in prof.events():
        if getattr(evt, "device_type", None) is None or "CUDA" not in str(evt.device_type):
            continue
        dur = evt.time_range.end - evt.time_range.start
        intervals.append((evt.time_range.start, evt.time_range.end))
        kernel = evt.name
        if "traverse_kernel<true, false>" in kernel:
            kind = "K2 closest-hit"
        elif "traverse_kernel<true, true>" in kernel:
            kind = "K2 any-hit"
        elif "traverse_q_kernel<true, false>" in kernel:
            kind = "K3 closest-hit"
        elif "traverse_q_kernel<true, true>" in kernel:
            kind = "K3 any-hit"
        elif "sort" in kernel.lower() or "radix" in kernel.lower() or "cub::" in kernel:
            kind = "sorts"
        elif "CatArray" in kernel:
            kind = "cat copies"
        elif "index" in kernel.lower() or "gather" in kernel.lower() or "scatter" in kernel.lower():
            kind = "gathers and scatters"
        elif "elementwise" in kernel.lower() or "vectorized" in kernel.lower() or "reduce" in kernel.lower():
            kind = "elementwise and reductions"
        elif "memcpy" in kernel.lower() or "memset" in kernel.lower():
            kind = "copies and fills"
        else:
            kind = "other"
        kinds[kind] = kinds.get(kind, 0.0) + dur
    busy = 0.0
    end = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    span = (max(b for _, b in intervals) - min(a for a, _ in intervals)) if intervals else 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60)
    (out_dir / f"profile_{name}.txt").write_text(table)
    summary = {
        "frame_s": seconds, "device_span_ms": span / 1e3, "device_busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / span if span else None,
        "by_kind_ms": {k: v / 1e3 for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])},
    }
    (out_dir / f"profile_{name}.json").write_text(json.dumps(summary, indent=1))
    log(f"profile {name}", json.dumps(summary))


def main() -> int:
    parser = argparse.ArgumentParser(description="Smoke test of minipath_tpu_torch on one NVIDIA GPU.")
    parser.add_argument("--profile", type=Path, default=None, metavar="DIR",
                        help="also profile one warm path-traced frame on each layout and write the summaries to DIR")
    args = parser.parse_args()
    smi = phase_device()
    phase_build()
    from minipath_tpu_torch.scene.procedural import make_atrium
    from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh

    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    bvh = TriangleBvh.build(make_atrium(250_000))
    stats = bvh.statistics()
    print(f"atrium: {stats['triangles']} triangles, {stats['inner_nodes']} inner nodes, "
          f"max depth {stats['max_depth']}, stack {bvh.recommended_stack_size}, "
          f"built in {time.perf_counter() - t0:.1f}s", flush=True)
    kernel = phase_kernel(bvh, device)
    launches = phase_main_path(bvh, device, smi)
    phase_cli()

    pt_bvh, dicts = build_pt_atrium()
    parts = pt_parts(pt_bvh, dicts, device)
    k2, sets = phase_k2(pt_bvh, parts, device)
    k2_launches, pt_mean = phase_pt_main_path(parts, device, smi)
    phase_card_vs_cpu(pt_bvh, dicts, device)
    phase_pt_cli()
    if args.profile is not None:
        profile_pt_frame(parts, device, args.profile)

    big = build_big_atrium(device)
    k3 = phase_k3(big, pt_bvh, parts[0], sets, device)
    del sets
    q_launches = phase_q_main_path(big, device, smi)
    for mode, n in phase_q_pt(big, pt_bvh, dicts, device, smi, pt_mean).items():
        q_launches[mode] += n
    if args.profile is not None:
        profile_pt_frame(pt_parts(pt_bvh, dicts, device, quantized=True), device, args.profile, name="pt_q")
    del big, pt_bvh, parts
    k4, k4_launches, k5, k5_launches, _ = phase_chain(device, smi)
    phase_bench(smi)

    def entry(name, source, replaces, launches, results, key, **extra):
        r = results[key]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "max_abs_err": max(x["err"] for x in results.values()), "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            # No PyTorch call traverses a BVH, and no single call computes a
            # dependent chain.
            "library_ms": None,
            **extra,
        }

    chain = "minipath_tpu_torch/csrc/chain.cu"
    print(json.dumps({"kernels": [
        entry("traverse", "minipath_tpu_torch/csrc/traverse.cu", "minipath_tpu/render/pallas_kernels.py:165",
              launches, kernel, "dispatch slice"),
        entry("traverse_pt", "minipath_tpu_torch/csrc/traverse.cu", "minipath_tpu/render/pallas_kernels.py:1375",
              k2_launches, k2, "bounce1"),
        entry("traverse_q", "minipath_tpu_torch/csrc/traverse_q.cu", "minipath_tpu/render/pallas_kernels.py:650",
              sum(q_launches.values()), k3, "full", launches_by_mode=q_launches),
        entry("vpu_chain", chain, "minipath_tpu/utils/calibrate.py:44", k4_launches, k4, CHAIN_CHECK_ITERS[-1]),
        *(entry(f"chain_{short}", chain, "tools/microbench_vpu_bf16.py:24", k5_launches[str(dtype)[6:]],
                {key: r for (key, d), r in k5.items() if d == dtype}, "default",
                card_filling=k5["card-filling", dtype])
          for short, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
