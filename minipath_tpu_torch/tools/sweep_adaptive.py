"""Adaptive against uniform sampling at equal budget, by Monte-Carlo
efficiency.

Port of ``tools/sweep_adaptive.py``. The atrium with its materials (250k
triangles, leaves of up to 24, the benchmark camera, the sky) at 960x540, 5
bounces, over K2: a reference frame at 128 spp (uniform), then at each
average budget (10 and 18 spp) three frames with ``render_frame_pt``
(uniform, chunks of 8 samples) and three with ``render_frame_pt_adaptive``
(a 2-spp pilot, then packets of noisier pixels get more chunks). A row
reports each sampler's RMSE against the reference (the three frames' mean
RMSE), its seconds a frame (the last two frames' mean), the efficiency
1 / (MSE x seconds) of adaptive over uniform, the adaptive spp map's
spread, and the frame means. With ``--nee``, every frame, the reference's
too, adds next-event estimation at every vertex. The gate: each sampler's
frame mean within 1% of the reference's (both are unbiased), or within 4
standard errors of its three frames' means.

The JAX tool printed its rows and wrote no file; the rows here carry the
keys of ``QUALITY.json``'s ``adaptive`` rows and the times beside them.
``--out`` writes the JSON; nothing else is written.

Usage: ``python -m minipath_tpu_torch.tools.sweep_adaptive [--device cuda]
[--out PATH] [--nee] [W H]``
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from minipath_tpu_torch.tools import common

SIZE = (960, 540)
BOUNCES = 5
REFERENCE_SPP = 128
BUDGETS = (10, 18)
FRAMES = 3
SAMPLES_PER_PACKET = 8
PILOT_SPP = 2


def main(argv=None) -> int:
    p = common.parser("Adaptive against uniform sampling at equal budget on the atrium.", "W H (default 960 540)")
    p.add_argument("--nee", action="store_true", help="next-event estimation at every vertex")
    args = p.parse_args(argv)
    W, H = common.sizes(args, p, SIZE)
    device = common.device_or_none(args)
    if device is None:
        return 2

    from minipath_tpu_torch.bench import bench_camera
    from minipath_tpu_torch.render.adaptive import render_frame_pt_adaptive
    from minipath_tpu_torch.render.wavefront import render_frame_pt
    from minipath_tpu_torch.scene.materials import Environment

    w = common.pt_workload(*common.build_scene(device), device)
    sampler = bench_camera().build_sampler((W, H), device)
    kw = dict(width=W, height=H, bounces=BOUNCES, env=Environment.sky(device), samples_per_packet=SAMPLES_PER_PACKET,
              lights=w.lights if args.nee else None, shadow_tracer=w.shadow if args.nee else None)

    def generator(seed):
        return torch.Generator(device=device).manual_seed(seed)

    def uniform(seed, spp):
        return common.host_rgb(render_frame_pt(w.tracer, w.scene, w.table, sampler, generator(seed), spp=spp, **kw)), None

    def adaptive(seed, spp):
        img, spp_map = render_frame_pt_adaptive(w.tracer, w.scene, w.table, sampler, generator(seed), spp=spp,
                                                pilot_spp=PILOT_SPP, return_spp_map=True, **kw)
        return common.host_rgb(img), spp_map.cpu().numpy()

    t0 = time.perf_counter()
    ref, _ = uniform(99, REFERENCE_SPP)
    ref = ref.astype(np.float64)
    ref_mean = float(ref.mean())
    common.log(f"reference (uniform {REFERENCE_SPP} spp) in {time.perf_counter() - t0:.1f}s, mean {ref_mean:.5f}")

    failed, rows = [], []
    for spp in BUDGETS:
        row = {"avg_spp": spp}
        for name, fn in (("uniform", uniform), ("adaptive", adaptive)):
            errs, times, means, spp_map = [], [], [], None
            for i in range(FRAMES):
                t0 = time.perf_counter()
                img, spp_map = fn(10 * spp + i, spp)
                times.append(time.perf_counter() - t0)
                errs.append(float(np.sqrt(np.mean((img.astype(np.float64) - ref) ** 2))))
                means.append(float(img.mean(dtype=np.float64)))
            mse = float(np.mean(errs)) ** 2
            seconds = float(np.mean(times[1:] if len(times) > 1 else times))
            row[f"rmse_{name}"] = float(np.mean(errs))
            row[f"s_per_frame_{name}"] = seconds
            row[f"efficiency_{name}"] = 1.0 / (mse * seconds)
            row[f"mean_{name}"] = float(np.mean(means))
            stderr = float(np.std(means, ddof=1) / np.sqrt(len(means))) if len(means) > 1 else 0.0
            if spp_map is not None:
                row["spp_min"], row["spp_mean"], row["spp_max"] = (float(spp_map.min()), float(spp_map.mean()),
                                                                   float(spp_map.max()))
            common.mean_gate(f"{name} at {spp} spp", row[f"mean_{name}"], ref_mean, failed, stderr)
            common.log(f"{name} spp={spp}: rmse={row[f'rmse_{name}']:.5f} t={seconds:.3f}s "
                       f"eff={row[f'efficiency_{name}']:.1f}")
        row["mse_ratio_uniform_over_adaptive"] = (row["rmse_uniform"] / row["rmse_adaptive"]) ** 2
        row["efficiency_ratio_adaptive_over_uniform"] = row["efficiency_adaptive"] / row["efficiency_uniform"]
        rows.append(row)
    out = {
        "device": common.device_name(device),
        "workload": (f"atrium {'NEE' if args.nee else 'BSDF-only'} {W}x{H}, {BOUNCES} bounces, chunks of "
                     f"{SAMPLES_PER_PACKET}, adaptive pilot {PILOT_SPP} spp, {FRAMES} frames a sampler and budget, "
                     "K2 over the f32 layout"),
        "reference_spp": REFERENCE_SPP,
        "reference_mean": ref_mean,
        "adaptive": rows,
        "kernel_launches": common.kernel_launches(),
        "gates_failed": failed,
    }
    return common.finish(out, args.out)


if __name__ == "__main__":
    sys.exit(main())
