"""Path-tracer parity on a Sponza-scale atrium: the lean kernels against the
portable engine.

Port of ``tools/parity_big.py``. On the 650,000-triangle atrium with its
materials (649,684 built, leaves of up to 24 triangles,
:func:`~minipath_tpu_torch.tools.common.atrium`) it holds two kernels to the
portable engine (``render/wavefront.py::make_portable_tracer`` and
``make_portable_shadow_tracer``, which share no code with them):

* K3 in lean mode over the quantized layout (``quantized_pt_scene``), taken
  explicitly: on the card the f32 layout fits the port's budget, and
  ``over_f32_budget`` reports what that rule decided;
* K2 over the f32 layout (the ``f32`` block).

For each, three checks with the JAX tool's thresholds, each a gate:

1. rays: 4,096 rays, half from the benchmark viewpoint into the hall, half
   from random points inside it; hit agreement above 0.995 and the 99th
   percentile of the relative ``t`` difference, where both found the same
   triangle, below 5e-3 (the quantized vertices move a hit legitimately);
2. occlusion: 4,096 segments to random points inside the hall, the any-hit
   kernel against the portable shadow tracer; agreement above 0.99;
3. frames: one 160x90 @ 8 spp, 4-bounce path-traced frame with NEE through
   each engine from the same generator seed; the means within 5%
   (``mean_shift_frac``).

A failed gate exits 1 after the JSON line. The keys are those of the JAX-era
``PARITY_BIG.json``, where ``xla`` names the portable engine; ``--out``
writes the JSON. The frame seconds are single calls, parity evidence and no
speed comparison.

Usage: ``python -m minipath_tpu_torch.tools.parity_big [--device cuda] [--out
PATH] [n_triangles W H spp]``
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from minipath_tpu_torch.tools import common

SIZE = (650_000, 160, 90, 8)
BOUNCES = 4
LEAF_MAX = 24
N_RAYS = 4096
FRAME_SEED = 3
HIT_AGREEMENT, DT_REL_P99, OCCLUSION_AGREEMENT, MEAN_SHIFT = 0.995, 5e-3, 0.99, 0.05
TIMING_NOTE = ("seconds_* are single calls of render_frame_pt, warm for the kernels' libraries: parity evidence, "
               "not a speed comparison; the kernels' rates are in chip_smoke.py's phases 3, 6 and 10")


def rays_and_segments(n: int, seed: int = 7):
    """``(origin, direction, inv_direction, segment)`` as float32 NumPy
    arrays: the JAX tool's rays and segments."""
    rng = np.random.default_rng(seed)
    o = np.concatenate([
        np.tile(np.float32([-16.0, 4.0, 0.0]), (n // 2, 1)),
        rng.uniform([-18, 0.5, -8], [18, 12, 8], (n // 2, 3)).astype(np.float32),
    ])
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 2] += np.float32([3.0, 0.0, 0.0])  # into the hall
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    iv = np.where(d == 0, np.inf, 1.0 / d).astype(np.float32)
    tgt = rng.uniform([-18, 0.5, -8], [18, 12, 8], (n, 3)).astype(np.float32)
    return o, d, iv, tgt - o


def ray_parity(got, want) -> dict:
    """Hit agreement of two tracers' ``KernelHits``, and the relative ``t``
    difference where both found the same triangle."""
    tri_a, tri_b = got.tri.cpu().numpy(), want.tri.cpu().numpy()
    ha, hb = tri_a >= 0, tri_b >= 0
    same = ha & hb & (tri_a == tri_b)
    t_a, t_b = got.t.cpu().numpy()[same], want.t.cpu().numpy()[same]
    rel = np.abs(t_a - t_b) / np.maximum(t_b, 1e-3)
    return {
        "rays": int(tri_a.size),
        "hit_agreement": float((ha == hb).mean()),
        "same_winner_frac": float(same.mean()),
        "dt_rel_p99_same_winner": float(np.quantile(rel, 0.99)) if rel.size else 0.0,
    }


def main(argv=None) -> int:
    p = common.parser("Parity of K3 and K2 against the portable engine on a Sponza-scale atrium.",
                      "n_triangles W H spp (default 650000 160 90 8)")
    args = p.parse_args(argv)
    n_tris, W, H, SPP = common.sizes(args, p, SIZE)
    device = common.device_or_none(args)
    if device is None:
        return 2

    from minipath_tpu_torch.bench import bench_camera
    from minipath_tpu_torch.render.wavefront import render_frame_pt
    from minipath_tpu_torch.scene.materials import Environment, build_light_table, table_from_numpy
    from minipath_tpu_torch.scene.triangle_bvh import scene_budget_bytes

    scene = common.atrium(n_tris, materials=True, leaf_max=LEAF_MAX)
    bvh = scene.bvh
    budget = scene_budget_bytes(device)
    table = table_from_numpy(scene.material_fields, device)
    lights = build_light_table(bvh.host_arrays.tri_packets, bvh.host_arrays.tri_material, table)
    engines = {name: common.pt_tracers(bvh, device, name) for name in ("quantized", "f32", "portable")}
    sampler = bench_camera().build_sampler((W, H), device)
    env = Environment.sky(device)
    o, d, iv, seg = (torch.from_numpy(a).to(device) for a in rays_and_segments(N_RAYS))

    def frame(name):
        tracer, shadow, state = engines[name]
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render_frame_pt(
            tracer, state, table, sampler, torch.Generator(device=device).manual_seed(FRAME_SEED), width=W,
            height=H, spp=SPP, bounces=BOUNCES, env=env, samples_per_packet=SPP, compaction=True, lights=lights,
            shadow_tracer=shadow,
        )[..., :3].cpu().numpy()
        seconds = time.perf_counter() - t0
        if not np.isfinite(img).all():
            raise FloatingPointError(f"{name} frame is not finite")
        common.log(f"  {name} frame: {seconds:.2f}s, mean {img.mean():.5f}")
        return float(img.mean()), seconds

    tracer_x, shadow_x, state_x = engines["portable"]
    want = tracer_x(state_x, o, d, iv)
    occ_x = shadow_x(state_x, o, seg).cpu().numpy()
    mean_x, seconds_x = frame("portable")
    failed = []

    def against_portable(name, label):
        tracer, shadow, state = engines[name]
        rays = ray_parity(tracer(state, o, d, iv), want)
        occ = shadow(state, o, seg).cpu().numpy()
        anyhit = {"segments": N_RAYS, "occlusion_agreement": float((occ == occ_x).mean()),
                  "occluded_frac": float(occ_x.mean())}
        mean, seconds = frame(name)
        shift = abs(mean - mean_x) / max(mean_x, 1e-9)
        frames = {
            "workload": f"{W}x{H} @ {SPP}spp, {BOUNCES} bounces, PT+NEE",
            f"mean_{label}": mean, "mean_xla": mean_x, "mean_shift_frac": shift,
            f"seconds_{label}_lean": seconds, "seconds_xla": seconds_x, "timing_note": TIMING_NOTE,
        }
        for what, ok in ((f"{name} hit agreement > {HIT_AGREEMENT}", rays["hit_agreement"] > HIT_AGREEMENT),
                         (f"{name} p99 relative dt < {DT_REL_P99}", rays["dt_rel_p99_same_winner"] < DT_REL_P99),
                         (f"{name} occlusion agreement > {OCCLUSION_AGREEMENT}",
                          anyhit["occlusion_agreement"] > OCCLUSION_AGREEMENT),
                         (f"{name} mean shift < {MEAN_SHIFT}", shift < MEAN_SHIFT)):
            if not ok:
                failed.append(what)
        common.log(f"{name}: {rays} | {anyhit} | mean shift {shift:.5f}")
        return rays, anyhit, frames

    ray_q, anyhit_q, frame_q = against_portable("quantized", "quantized")
    ray_f, anyhit_f, frame_f = against_portable("f32", "f32")
    out = {
        "device": common.device_name(device),
        "triangle_count": bvh.build_result.triangle_count,
        "over_f32_budget": budget is not None and bvh.f32_scene_bytes(pt=True) > budget,
        "layout": "quantized (QPTScene), taken explicitly; over_f32_budget is the port's own rule",
        "f32_scene_mb": bvh.f32_scene_bytes(pt=True) / 1e6,
        "quantized_scene_mb": bvh.quantized_scene_bytes(pt=True) / 1e6,
        "scene_budget_mb": None if budget is None else budget / 1e6,
        "engines": {"quantized": "K3 lean over the quantized layout", "f32": "K2 over the f32 layout",
                    "xla": "the portable engine (render/traversal.py), packets of 256"},
        "ray_parity": ray_q,
        "anyhit_parity": anyhit_q,
        "frame_parity": frame_q,
        "f32": {"ray_parity": ray_f, "anyhit_parity": anyhit_f, "frame_parity": frame_f},
        "kernel_launches": common.kernel_launches(),
        "gates_failed": failed,
    }
    common.emit(out, args.out)
    if failed:
        common.log(f"gates failed: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
