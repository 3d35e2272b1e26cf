"""Leaf size against trace time on the atrium.

Port of ``tools/perf_leaf.py``. For each ``leaf_max`` in :data:`LEAVES`
(56, the format's limit, down to 8), the 250k-triangle atrium is built with
leaves of up to that many triangles by the native builder (the one the CLI
and the bench use; the JAX tool used the Python builder), cached in
``bench_cache_dir()`` (``utils/cuda_build.py``), and traced by K1 over the benchmark camera's
1920x1080 @ 32 spp camera rays (one ``gen_frame_rays9`` dispatch, 16x16
pixel packets, 66.8M rays): one warm-up launch, then the best of
:data:`TRACE_REPS` timed by CUDA events. A row reports the build's seconds
(as recorded when it was built), its depth, inner nodes and triangle
packets, the f32 layout's megabytes, the trace's milliseconds and rate, and
its agreement with the first tree's trace. The gate: every tree agrees with
the first on hit or miss for every ray, and on ``t`` within 1e-5 relative on
99.99% of the hits.

The JAX tool printed its rows; ``--out`` writes the JSON, and nothing else
is written.

Usage: ``python -m minipath_tpu_torch.tools.perf_leaf [--device cuda] [--out
PATH] [n_triangles W H spp]``
"""

from __future__ import annotations

import sys

import torch

from minipath_tpu_torch.tools import common

SIZE = (250_000, 1920, 1080, 32)
LEAVES = (56, 32, 24, 16, 8)
TRACE_REPS = 2


def main(argv=None) -> int:
    p = common.parser("Leaf size against K1's trace time on the atrium.",
                      "n_triangles W H spp (default 250000 1920 1080 32)")
    args = p.parse_args(argv)
    n_tris, W, H, SPP = common.sizes(args, p, SIZE)
    device = common.device_or_none(args)
    if device is None:
        return 2

    from minipath_tpu_torch.bench import bench_camera, scene_mb
    from minipath_tpu_torch.render import kernels
    from minipath_tpu_torch.render.frame import gen_frame_rays9

    sampler = bench_camera().build_sampler((W, H), device)
    rays9, _ = gen_frame_rays9(sampler, torch.Generator(device=device).manual_seed(0), width=W, height=H,
                               px_block=(16, 16), samples=SPP)
    n_rays = rays9.shape[0] * rays9.shape[2]
    timer = common.DeviceTimer(device)
    failed, rows, ref, tris = [], [], None, None
    for leaf_max in LEAVES:
        built = common.atrium(n_tris, materials=False, leaf_max=leaf_max)
        bvh, stack = built.bvh, built.bvh.recommended_stack_size
        tris = bvh.build_result.triangle_count
        scene = kernels.prepare_scene(bvh.arrays(device))

        kh = kernels.trace_packets(scene, rays9, stack_size=stack)
        times = []
        for _ in range(TRACE_REPS):
            timer.start()
            kernels.trace_packets(scene, rays9, stack_size=stack)
            times.append(timer.stop())
        best = min(times)
        if int(kh.overflow.sum()):
            failed.append(f"leaf_max={leaf_max}: stack overflow")
        hit = kh.tri >= 0
        if ref is None:
            ref = (hit, kh.t)
        stats = bvh.statistics()
        row = {"leaf_max": leaf_max, "build_s": built.build_s, "cached": built.cached, "depth": stats["max_depth"],
               "inner_nodes": stats["inner_nodes"], "packets": stats["triangle_packets"],
               "layout_mb": scene_mb(scene), "trace_ms": best, "mrays_per_s": n_rays / best / 1e3,
               **common.tree_agreement(f"leaf_max={leaf_max}", hit, kh.t, *ref, failed)}
        common.log(f"leaf_max={leaf_max:2d}: build {row['build_s']:.1f}s depth={row['depth']} packets={row['packets']} "
                   f"layout={row['layout_mb']:.1f}MB trace {best:.2f} ms -> {row['mrays_per_s']:.0f} Mrays/s")
        rows.append(row)
    out = {
        "device": common.device_name(device),
        "workload": f"atrium ({tris} triangles, native builds), K1 over the benchmark camera's {W}x{H} @ {SPP}spp "
                    f"camera rays, best of {TRACE_REPS} launches",
        "rays": n_rays,
        "rows": rows,
        "kernel_launches": common.kernel_launches(),
        "gates_failed": failed,
    }
    return common.finish(out, args.out)


if __name__ == "__main__":
    sys.exit(main())
