"""Big-scene demo: a 1.5M-triangle atrium on both scene layouts.

Port of ``tools/demo_bigscene.py``. On the TPU the demo showed the 16-bit
quantized layout carrying a scene that the f32 layout's VMEM budget
refuses. On the card both layouts live in device memory; the port's rule
(``scene/triangle_bvh.py``) takes the quantized one only where the f32
bytes exceed ``scene_budget_bytes``, half the card's memory. So the demo
reports both layouts' bytes and what the rule picks, and renders the parity
frame over each layout:

* the atrium of 1,500,000 triangles requested, no materials, leaves of up
  to 56 (:func:`~minipath_tpu_torch.tools.common.atrium`, cached);
* ``render_frame`` at 1920x1080 @ 16 spp, 16 samples a packet, over K1 (the
  f32 layout) and over K3 in full mode (the quantized layout): one warm-up
  and three timed frames each, the best kept, with the frame's coverage;
* the portable engine's rate on a small set of camera rays (1920x16 px x 4
  samples) beside K3's on the same rays (:func:`engine_rates`).

Two gates (:func:`gates`), past which the run exits 1 after its JSON: K3
and the portable engine agree on hit or miss for more than 99.5% of the
small set, and the two layouts' frames agree in mean and coverage within
1%.

Prints one JSON line with the JAX demo's keys (``value`` is the quantized
frame's Mrays/s; ``f32_layout_fits`` is the port's decision, true on the
card); ``--out`` also writes it.

Usage: ``python -m minipath_tpu_torch.tools.demo_bigscene [--device cuda]
[--out PATH] [n_triangles W H spp]``
"""

from __future__ import annotations

import sys
import time

import torch

from minipath_tpu_torch.tools import common

SIZE = (1_500_000, 1920, 1080, 16)
LEAF_MAX = 56
SAMPLES_PER_PACKET = 16
TIMED_FRAMES = 3
# The small ray set of the engines' rates: width x SMALL_ROWS px x samples.
SMALL_ROWS, SMALL_SAMPLES = 16, 4
# The gates: hit agreement of K3 and the portable engine on the small set;
# the two layouts' frames (quantized vertices move silhouettes by a fraction
# of a pixel).
HIT_AGREEMENT, LAYOUT_RTOL = 0.995, 0.01


def layouts(bvh, device) -> dict:
    """Both layouts' bytes, the budget, and what the port's rule picks."""
    from minipath_tpu_torch.scene.triangle_bvh import scene_budget_bytes

    budget = scene_budget_bytes(device)
    f32, quantized = bvh.f32_scene_bytes(), bvh.quantized_scene_bytes()
    return {
        "f32_mb": f32 / 1e6,
        "quantized_mb": quantized / 1e6,
        "f32_pt_mb": bvh.f32_scene_bytes(pt=True) / 1e6,
        "quantized_pt_mb": bvh.quantized_scene_bytes(pt=True) / 1e6,
        "scene_budget_mb": None if budget is None else budget / 1e6,
        "f32_share_of_budget": None if budget is None else f32 / budget,
        "f32_over_budget": budget is not None and f32 > budget,
        "quantized_over_budget": budget is not None and quantized > budget,
        "rule_picks": "quantized" if budget is not None and f32 > budget else "f32",
    }


def parity_frames(bvh, device, W, H, spp, timed=TIMED_FRAMES) -> dict:
    """``render_frame`` over the f32 layout (K1) and the quantized one (K3
    full): per layout the best warm seconds, Mrays/s, coverage and mean."""
    from minipath_tpu_torch.bench import bench_camera
    from minipath_tpu_torch.render.frame import render_frame
    from minipath_tpu_torch.render.kernels import prepare_scene

    sampler = bench_camera().build_sampler((W, H), device)
    out = {}
    for name, make in (("f32", lambda: prepare_scene(bvh.arrays(device))),
                       ("quantized", lambda: bvh.quantized_scene(device))):
        t0 = time.perf_counter()
        scene = make()
        laid_out = time.perf_counter() - t0

        def frame(seed):
            img = render_frame(scene, sampler, torch.Generator(device=device).manual_seed(seed), width=W, height=H,
                               spp=spp, stack_size=bvh.recommended_stack_size,
                               samples_per_packet=min(SAMPLES_PER_PACKET, spp))
            alpha = img[..., 3].cpu().numpy()
            return float((alpha > 0).mean()), float(img[..., :3].mean())

        times, (coverage, mean) = common.frame_seconds(frame, timed, 1, name)
        best = float(times.min())
        out[name] = {"seconds_per_frame": best, "mrays_per_s": W * H * spp / best / 1e6, "coverage": coverage,
                     "mean": mean, "layout_seconds": laid_out}
        common.log(f"{name}: {best:.3f}s = {out[name]['mrays_per_s']:.1f} Mrays/s, coverage {coverage:.4f}")
        del scene
    return out


def engine_rates(bvh, device, W) -> dict:
    """Mrays/s of the portable engine and of K3 (full mode) on the same
    ``W x SMALL_ROWS x SMALL_SAMPLES`` camera rays, each traced once warm; a
    CUDA-event time on the card, the host clock on the CPU."""
    from minipath_tpu_torch.bench import bench_camera
    from minipath_tpu_torch.render.frame import gen_frame_rays9
    from minipath_tpu_torch.render.kernels_q import trace_scene
    from minipath_tpu_torch.render.wavefront import make_portable_tracer

    sampler = bench_camera().build_sampler((W, SMALL_ROWS), device)
    r9, _ = gen_frame_rays9(sampler, torch.Generator(device=device).manual_seed(0), width=W, height=SMALL_ROWS,
                            px_block=(16, 16), samples=SMALL_SAMPLES)
    n = r9.shape[0] * r9.shape[2]
    flat = r9.transpose(1, 2).reshape(n, 9)
    arrays, stack = bvh.arrays(device), bvh.recommended_stack_size
    portable, _ = make_portable_tracer(arrays, stack_size=stack)
    scene = bvh.quantized_scene(device)
    rates, hits = {}, {}
    for name, fn in (("portable", lambda: portable(arrays, flat[:, 0:3], flat[:, 3:6], flat[:, 6:9])),
                     ("kernel", lambda: trace_scene(scene, r9, stack_size=stack))):
        fn()
        timer = common.DeviceTimer(device).start()
        hits[name] = fn()
        rates[name] = n / timer.stop() / 1e3
    same = float((hits["kernel"].tri.reshape(-1) >= 0).eq(hits["portable"].tri >= 0).float().mean())
    common.log(f"small set of {n} rays: portable {rates['portable']:.3f}, K3 {rates['kernel']:.1f} Mrays/s")
    return {"rays": n, "portable_mrays_per_s": rates["portable"], "kernel_mrays_per_s": rates["kernel"],
            "hit_agreement": same}


def gates(frames, rates) -> list:
    """The names of the gates that failed."""
    f, q = frames["f32"], frames["quantized"]
    checks = (
        (f"K3 and the portable engine agree on more than {HIT_AGREEMENT} of hits",
         rates["hit_agreement"] > HIT_AGREEMENT),
        (f"layouts' frame means within {LAYOUT_RTOL}", abs(q["mean"] - f["mean"]) <= LAYOUT_RTOL * f["mean"]),
        (f"layouts' coverage within {LAYOUT_RTOL}", abs(q["coverage"] - f["coverage"]) <= LAYOUT_RTOL),
    )
    failed = [name for name, ok in checks if not ok]
    if failed:
        common.log(f"gates failed: {failed}")
    return failed


def main(argv=None) -> int:
    p = common.parser("The 1.5M-triangle atrium on both scene layouts.", "n_triangles W H spp (default 1500000 "
                      "1920 1080 16)")
    args = p.parse_args(argv)
    n_tris, W, H, SPP = common.sizes(args, p, SIZE)
    device = common.device_or_none(args)
    if device is None:
        return 2
    scene = common.atrium(n_tris, materials=False, leaf_max=LEAF_MAX)
    bvh = scene.bvh
    lay = layouts(bvh, device)
    frames = parity_frames(bvh, device, W, H, SPP)
    rates = engine_rates(bvh, device, W)
    q = frames["quantized"]
    out = {
        "metric": f"bigscene_{bvh.build_result.triangle_count}tris_1080p_{SPP}spp",
        "value": q["mrays_per_s"],
        "unit": "Mrays/s",
        "device": common.device_name(device),
        "f32_layout_fits": not lay["f32_over_budget"],
        "quantized_vmem_mb": lay["quantized_mb"],
        "triangles": bvh.build_result.triangle_count,
        "build_s": scene.build_s,
        "build_cached": scene.cached,
        "layouts": lay,
        "frames": frames,
        "kernel_launches": common.kernel_launches(),
        "engines": rates,
        "gates_failed": gates(frames, rates),
        "note": ("quantized_vmem_mb is the quantized layout's device bytes (no VMEM on the card); value is the "
                 "frame over K3 in full mode, frames.f32 the same frame over K1"),
    }
    common.emit(out, args.out)
    return 1 if out["gates_failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
