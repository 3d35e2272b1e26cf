"""What Owen-scrambled Sobol samples cost a frame against jittered strata.

Port of ``tools/sobol_cost.py``. ``QUALITY.json``'s ``sobol`` section
measures Sobol's error against strata at equal samples; this measures the
other half of that choice, the seconds a frame: the atrium with its
materials (250k triangles, leaves of up to 24, the benchmark camera, the
sky) at 960x540 @ 8 spp, 5 bounces, BSDF sampling only, over K2 (packets of
2048), in each mode one warm-up frame and four timed ones, the best three
averaged. It reports the keys of the JAX tool's ``frame_cost`` block (the
frame mean is the warm-up frame's). The gate: Sobol's frame mean within 1%
of the strata's (both are unbiased).

The JAX tool appends the block to ``QUALITY.json``; this tool prints it, and
``--out`` writes it, and writes nothing else.

Usage: ``python -m minipath_tpu_torch.tools.sobol_cost [--device cuda] [--out
PATH] [W H spp]``
"""

from __future__ import annotations

import sys
import time

import numpy as np

from minipath_tpu_torch.tools import common

SIZE = (960, 540, 8)
BOUNCES = 5
TIMED_FRAMES = 4
BEST = 3


def main(argv=None) -> int:
    p = common.parser("Seconds a path-traced frame with Sobol samples against strata.", "W H spp (default 960 540 8)")
    args = p.parse_args(argv)
    W, H, SPP = common.sizes(args, p, SIZE)
    device = common.device_or_none(args)
    if device is None:
        return 2

    from minipath_tpu_torch.bench import bench_camera
    from minipath_tpu_torch.scene.materials import Environment

    w = common.pt_workload(*common.build_scene(device), device)
    sampler = bench_camera().build_sampler((W, H), device)
    env = Environment.sky(device)

    def frame(seed, sobol):
        img = common.pt_frame(w, sampler, seed, width=W, height=H, spp=SPP, nee=False, bounces=BOUNCES, env=env,
                              sobol=sobol)
        return float(img[..., :3].mean())

    out = {"device": common.device_name(device)}
    for name, sobol in (("stratified", False), ("sobol", True)):
        mean = frame(7, sobol)  # the warm-up
        times = []
        for i in range(TIMED_FRAMES):
            t0 = time.perf_counter()
            frame(i, sobol)
            times.append(time.perf_counter() - t0)
        out[f"{name}_s_per_frame"] = float(np.mean(sorted(times)[:BEST]))
        out[f"{name}_frame_mean"] = mean
        common.log(f"{name}: {out[f'{name}_s_per_frame']:.4f} s/frame, mean {mean:.5f}")
    out["cost_ratio_sobol_over_stratified"] = out["sobol_s_per_frame"] / out["stratified_s_per_frame"]
    out["workload"] = (f"atrium f32-lean PT {W}x{H} @ {SPP}spp, {BOUNCES} bounces, BSDF-only, K2, packet 2048, warm, "
                       f"best-{BEST}-of-{TIMED_FRAMES}")
    failed = []
    common.mean_gate("sobol", out["sobol_frame_mean"], out["stratified_frame_mean"], failed)
    out["kernel_launches"] = common.kernel_launches()
    out["gates_failed"] = failed
    return common.finish(out, args.out)


if __name__ == "__main__":
    sys.exit(main())
