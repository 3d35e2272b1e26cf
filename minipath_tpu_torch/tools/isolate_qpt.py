"""K3 (lean, over the 16-bit quantized layout) against K2 (lean, over the
f32 layout) on the same scene and the same rays.

Port of ``tools/isolate_qpt.py``. Both layouts hold the 249k-triangle atrium
(:func:`~minipath_tpu_torch.tools.common.build_scene`), so this separates
what the quantized kernel costs from what a bigger scene costs:

* whole path-traced frames, 960x540 @ 8 spp, 5 bounces, BSDF only, one
  warm-up and three timed frames through ``make_pt_tracer`` over a
  ``PTScene`` (K2) and over a ``QPTScene`` (K3 lean): seconds, Mpaths/s,
  and the ratio;
* the trace alone on one 4.18M-ray primary batch (the same frame's camera
  rays, one launch each), timed by CUDA events over three launches after a
  warm-up: milliseconds, the ``inner_visits`` and ``leaf_tests`` counters
  (the same tree, so nearly the same counts; quantized boxes are rounded
  outward and can only add visits), and the cost of one visit.

On the card a visit is one ray's: one thread slab-tests a node's 8 children
or tests a leaf packet's 8 triangles for its own ray, where on the TPU a
visit was a 2048-lane packet's. ``*_us_per_packet_visit`` keeps the JAX-era
key and means microseconds per such per-ray visit (inner visits plus leaf
tests); ``*_ns_per_visit`` is the same in nanoseconds. Prints the JSON (the
keys of ``ISOLATE_QPT.json``); ``--out`` also writes it.

Usage: ``python -m minipath_tpu_torch.tools.isolate_qpt [--device cuda]
[--out PATH] [W H spp]``
"""

from __future__ import annotations

import sys

import torch

from minipath_tpu_torch.tools import common

SIZE = (960, 540, 8)
BOUNCES = 5
PACKET = 2048
TIMED_FRAMES = 3
TRACE_REPS = 3


def main(argv=None) -> int:
    p = common.parser("K3 lean against K2 lean on the same scene and rays.", "W H spp (default 960 540 8)")
    args = p.parse_args(argv)
    W, H, SPP = common.sizes(args, p, SIZE)
    device = common.device_or_none(args)
    if device is None:
        return 2

    from minipath_tpu_torch.bench import bench_camera
    from minipath_tpu_torch.render.frame import gen_frame_rays9
    from minipath_tpu_torch.render.kernels import prepare_scene_pt
    from minipath_tpu_torch.render.kernels_q import prepare_scene_qpt
    from minipath_tpu_torch.render.wavefront import _trace_pt_any, make_pt_tracer, render_frame_pt
    from minipath_tpu_torch.scene.bvh.build import from_numpy
    from minipath_tpu_torch.scene.materials import Environment
    from minipath_tpu_torch.utils.calibrate import device_health

    arrays, table, stack = common.build_scene(device)
    scenes = (
        ("f32_lean", prepare_scene_pt(from_numpy(arrays._asdict(), device))),
        ("quantized_lean", prepare_scene_qpt(arrays, device)),
    )
    sampler = bench_camera().build_sampler((W, H), device)
    env = Environment.sky(device)
    paths = W * H * SPP
    # Padding lanes of the leaf packets are all-zero triangles.
    n_tris = int((arrays.tri_packets.reshape(-1, 9) != 0).any(axis=1).sum())
    out = {
        "workload": f"SAME {n_tris // 1000}k-tri atrium, PT {W}x{H} @ {SPP}spp, {BOUNCES} bounces, BSDF-only, "
                    f"packet {PACKET}",
        "triangle_count": n_tris,
        "device": common.device_name(device),
    }

    for name, scene in scenes:
        tracer, _ = make_pt_tracer(scene, stack_size=stack, packet_size=PACKET)

        def frame(seed, tracer=tracer, scene=scene):
            img = render_frame_pt(tracer, scene, table, sampler, torch.Generator(device=device).manual_seed(seed),
                                  width=W, height=H, spp=SPP, bounces=BOUNCES, env=env, samples_per_packet=SPP,
                                  compaction=True)
            return float(img[..., :3].mean())

        times, mean = common.frame_seconds(frame, TIMED_FRAMES, 30, name)
        out[f"{name}_s_per_frame"] = round(float(times.mean()), 4)
        out[f"{name}_mpaths_per_s"] = round(paths / times.mean() / 1e6, 3)
        out[f"{name}_frame_mean"] = round(mean, 5)
        common.log(f"{name}: {times.mean():.3f}s/frame ({out[f'{name}_mpaths_per_s']} Mpaths/s)")
    out["frame_ratio_q_over_f32"] = round(out["quantized_lean_s_per_frame"] / out["f32_lean_s_per_frame"], 3)

    # The trace alone: one primary batch, one launch a layout.
    r9, _ = gen_frame_rays9(sampler, torch.Generator(device=device).manual_seed(9), width=W, height=H,
                            px_block=(16, 16), samples=SPP)
    out["trace_rays"] = int(r9.shape[0] * r9.shape[2])
    timer = common.DeviceTimer(device)
    for name, scene in scenes:
        def trace(scene=scene):
            return _trace_pt_any(scene, r9, stack_size=stack, live_packets=None)

        hits = trace()
        timer.start()
        for _ in range(TRACE_REPS):
            trace()
        ms = timer.stop() / TRACE_REPS
        visits, tests = int(hits.inner_visits.sum()), int(hits.leaf_tests.sum())
        out[f"{name}_trace_s"] = round(ms / 1e3, 6)
        out[f"{name}_inner_visits"] = visits
        out[f"{name}_leaf_tests"] = tests
        out[f"{name}_us_per_packet_visit"] = round(ms * 1e3 / (visits + tests), 8)
        out[f"{name}_ns_per_visit"] = round(ms * 1e6 / (visits + tests), 5)
        common.log(f"{name} trace: {ms:.3f} ms, visits {visits}, leaf tests {tests}, "
                   f"{out[f'{name}_ns_per_visit']} ns a visit")

    out["kernel_ratio_q_over_f32"] = round(out["quantized_lean_trace_s"] / out["f32_lean_trace_s"], 3)
    out["visit_ratio_q_over_f32"] = round(
        (out["quantized_lean_inner_visits"] + out["quantized_lean_leaf_tests"])
        / (out["f32_lean_inner_visits"] + out["f32_lean_leaf_tests"]), 3)
    out["ns_per_visit_ratio_q_over_f32"] = round(out["quantized_lean_ns_per_visit"] / out["f32_lean_ns_per_visit"], 3)
    out["device_health"] = device_health(device)
    common.emit(out, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
