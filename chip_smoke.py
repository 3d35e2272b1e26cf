#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``minipath_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Five phases,
each printing one line; any failure raises and the script exits non-zero.
There is no CPU path: without a CUDA device it fails at once.

1. Device: the card's name and power limit.
2. Build: compiles the traversal kernel (``csrc/traverse.cu``) with nvcc.
3. Kernel against its plain PyTorch version on the card, on the
   249,284-triangle procedural atrium: 16,384 coherent camera rays from the
   benchmark camera, 16,384 incoherent rays inside the atrium, and the first
   524,288 rays of one dispatch of the main path, made as ``render()`` makes
   them. Prints the agreement and the time of each version at these shapes,
   and the kernel's time at the whole dispatch.
4. Main path: ``render()`` of the atrium at 1920x1080 @ 64 spp in frame
   mode, once cold and once warm; the warm frame counts kernel launches.
5. CLI: ``python -m minipath_tpu_torch.cli --device cuda`` writes a PNG.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
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
    from minipath_tpu_torch.render import kernels

    t0 = time.perf_counter()
    built = kernels.load_library()
    regs = [ln.strip() for ln in built.log.splitlines() if "registers" in ln or "spill" in ln]
    log("2 build", f"{built.path.name} nvcc {built.build_seconds:.2f}s "
        f"(load {time.perf_counter() - t0:.2f}s) | {' | '.join(regs)}")


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
        log("3 kernel", f"{text} | kernel {ms:.4f} ms, plain {plain_ms:.2f} ms")
        results[name] = dict(ms=ms, plain_ms=plain_ms, err=err)

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


def main() -> int:
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
    print(json.dumps({"kernels": [{
        "name": "traverse",
        "route": "cuda",
        "source": "minipath_tpu_torch/csrc/traverse.cu",
        "replaces": "minipath_tpu/render/pallas_kernels.py:165",
        "launches": launches,
        "max_abs_err": max(r["err"] for r in kernel.values()),
        "ms": kernel["dispatch slice"]["ms"],
        "plain_ms": kernel["dispatch slice"]["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
