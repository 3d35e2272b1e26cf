"""Huge-scene demo: a 5M-triangle atrium with its materials, on both scene
layouts, as a parity frame and as a path-traced frame.

Port of ``tools/demo_hugescene.py``. On the TPU the demo streamed the
triangles of a scene too large for either on-chip layout from HBM. On the
card every layout lives in device memory, so the demo reports both
layouts' bytes, what the port's rule (``scene_budget_bytes``) picks, and:

* the atrium of 5,000,000 triangles requested (4,999,484 built) with
  ``atrium_materials``, leaves of up to 56
  (:func:`~minipath_tpu_torch.tools.common.atrium`, cached);
* the parity frame at 1920x1080 @ 16 spp over K1 and over K3 in full mode,
  with its coverage (``demo_bigscene.parity_frames``);
* the path-traced frame at 960x540 @ 4 spp, 4 bounces, the sky, BSDF
  sampling, over K2 (the f32 layout) and over K3 in lean mode (the
  quantized one), one warm-up and one timed frame each, with its mean;
* the portable engine's rate on a small set of camera rays beside K3's
  (``demo_bigscene.engine_rates``).

Prints the keys of the JAX-era ``BENCH_huge.json``: ``value`` is the
quantized parity frame's Mrays/s; ``f32_refused`` and
``quantized_vmem_refused`` say whether the port's rule would refuse each
layout (false on the card); ``node_vmem_mb`` and ``tri_hbm_mb`` are the
quantized layout's node and triangle bytes in device memory;
``xla_engine_mrays_per_s`` is the portable engine's rate and
``hbm_vs_xla`` the kernel's rate over it on the same rays. The gates are
``demo_bigscene``'s, and the two path-traced frames' means agree within
5% (the same generator seed; the layouts' hits differ by the quantized
vertices): past one the run exits 1 after its JSON. ``--out`` also writes
the JSON.

Usage: ``python -m minipath_tpu_torch.tools.demo_hugescene [--device cuda]
[--out PATH] [n_triangles W H spp]``
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from minipath_tpu_torch.tools import common
from minipath_tpu_torch.tools.demo_bigscene import engine_rates, gates, layouts, parity_frames

SIZE = (5_000_000, 1920, 1080, 16)
LEAF_MAX = 56
PT_SIZE, PT_BOUNCES = (960, 540, 4), 4
PT_MEAN_RTOL = 0.05


def pt_frame(bvh, table, device, engine, size) -> dict:
    """One warm path-traced frame of ``size`` = (W, H, spp) over ``engine``
    (``"f32"`` or ``"quantized"``, ``common.pt_tracers``); raises on a
    non-finite or black image."""
    from minipath_tpu_torch.bench import bench_camera
    from minipath_tpu_torch.render.wavefront import render_frame_pt
    from minipath_tpu_torch.scene.materials import Environment

    W, H, spp = size
    tracer, _, state = common.pt_tracers(bvh, device, engine)
    sampler, env = bench_camera().build_sampler((W, H), device), Environment.sky(device)

    def frame(seed):
        img = render_frame_pt(tracer, state, table, sampler, torch.Generator(device=device).manual_seed(seed),
                              width=W, height=H, spp=spp, bounces=PT_BOUNCES, env=env, samples_per_packet=spp,
                              compaction=True)[..., :3].cpu().numpy()
        if not np.isfinite(img).all() or not img.mean() > 0:
            raise AssertionError(f"the {engine} path-traced frame is not finite, or black")
        return float(img.mean())

    times, mean = common.frame_seconds(frame, 1, 99, f"pt {engine}")
    seconds = float(times[0])
    label = {"f32": "K2 over the f32 layout", "quantized": "K3 lean over the quantized layout"}[engine]
    return {"workload": f"{W}x{H} @ {spp}spp, {PT_BOUNCES} bounces, {label}", "seconds": seconds,
            "mpaths_per_s": W * H * spp / seconds / 1e6, "mean_rgb": mean}


def main(argv=None) -> int:
    p = common.parser("The 5M-triangle atrium with its materials on both scene layouts.",
                      "n_triangles W H spp (default 5000000 1920 1080 16)")
    args = p.parse_args(argv)
    n_tris, W, H, SPP = common.sizes(args, p, SIZE)
    device = common.device_or_none(args)
    if device is None:
        return 2

    from minipath_tpu_torch.scene.materials import build_light_table, table_from_numpy

    scene = common.atrium(n_tris, materials=True, leaf_max=LEAF_MAX)
    bvh = scene.bvh
    lay = layouts(bvh, device)
    frames = parity_frames(bvh, device, W, H, SPP)
    rates = engine_rates(bvh, device, W)
    table = table_from_numpy(scene.material_fields, device)
    t0 = time.perf_counter()
    lights = build_light_table(bvh.host_arrays.tri_packets, bvh.host_arrays.tri_material, table)
    light_s = time.perf_counter() - t0
    pw, ph, pspp = PT_SIZE
    pt_size = (min(pw, W), min(ph, H), min(pspp, SPP))
    pt_q = pt_frame(bvh, table, device, "quantized", pt_size)
    pt_f = pt_frame(bvh, table, device, "f32", pt_size)
    q = bvh.quantized_scene(device)
    out = {
        "metric": f"hugescene_{bvh.build_result.triangle_count}tris_1080p_{SPP}spp",
        "value": frames["quantized"]["mrays_per_s"],
        "unit": "Mrays/s",
        "device": common.device_name(device),
        "seconds_per_frame": frames["quantized"]["seconds_per_frame"],
        "coverage": frames["quantized"]["coverage"],
        "f32_refused": lay["f32_over_budget"],
        "quantized_vmem_refused": lay["quantized_over_budget"],
        "node_vmem_mb": (q.node_q.numel() + q.node_frame.numel()) * 4 / 1e6,
        "tri_hbm_mb": q.tri_q.numel() * 4 / 1e6,
        "xla_engine_mrays_per_s": rates["portable_mrays_per_s"],
        "hbm_vs_xla": rates["kernel_mrays_per_s"] / rates["portable_mrays_per_s"],
        "pt_frame": pt_q,
        "pt_frame_f32": pt_f,
        "triangles": bvh.build_result.triangle_count,
        "build_s": scene.build_s,
        "build_cached": scene.cached,
        "emitters": int(lights.pmf.shape[0]),
        "light_table_s": light_s,
        "layouts": lay,
        "frames": frames,
        "kernel_launches": common.kernel_launches(),
        "engines": rates,
        "gates_failed": gates(frames, rates) + (
            [] if abs(pt_q["mean_rgb"] - pt_f["mean_rgb"]) <= PT_MEAN_RTOL * pt_f["mean_rgb"]
            else [f"path-traced frames' means within {PT_MEAN_RTOL}"]),
        "note": ("the refusals are the port's own rule (the f32 layout above scene_budget_bytes, half the card's "
                 "memory); node_vmem_mb and tri_hbm_mb are device bytes; hbm_vs_xla is K3 (full mode) over the "
                 "portable engine (render/traversal.py) on the same small ray set"),
    }
    common.emit(out, args.out)
    return 1 if out["gates_failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
