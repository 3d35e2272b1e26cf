"""The NEE depth cap on the atrium: shadow-ray cost against variance, by
Monte-Carlo efficiency.

Port of ``tools/sweep_pt17.py``. ``nee_max_depth=K`` light-samples the
first K vertices of a path only; deeper emitter hits keep their full BSDF
weight, so the estimator stays unbiased at every K while the any-hit trace
past the cap disappears. Each cap (default none, 3, 2, 1; ``--caps``, where
the JAX tool takes them as its arguments) renders the atrium with its
materials (250k triangles, leaves of up to 24, the benchmark camera, the
sky) at 960x540 @ 8 spp, 5 bounces, over K2: one warm-up and five timed
frames, six seeds (``common.cap_sweep``). A row reports its seconds a
frame, the frame mean, the per-pixel variance across the seeds and its
efficiency 1 / (variance x seconds) over the first cap's. Every cap is
unbiased, but at 5 bounces the caps below 5 leave the last vertex's direct
light out, which NEE there adds: the uncapped frame's mean sits about 1.4%
higher. The gate holds each capped row's mean to the first capped row's,
within 1% or 4 standard errors of their difference (``common.row_gate``).

The JSON line has the keys of ``sweep_pt19``'s ``SWEEP_NEE_CAP2.json`` (the
JAX tool printed a table and wrote no file); ``--out`` writes it.

Usage: ``python -m minipath_tpu_torch.tools.sweep_pt17 [--device cuda] [--out
PATH] [--caps none,3,2,1] [W H spp]``
"""

from __future__ import annotations

import sys

from minipath_tpu_torch.tools import common

SIZE = (960, 540, 8)
BOUNCES = 5
SEEDS = 6
CAPS = "none,3,2,1"


def main(argv=None) -> int:
    p = common.parser("The NEE depth cap on the atrium, by Monte-Carlo efficiency.", "W H spp (default 960 540 8)")
    p.add_argument("--caps", type=common.caps, default=common.caps(CAPS), metavar="C,...",
                   help=f"NEE depth caps, 'none' for no cap (default {CAPS})")
    args = p.parse_args(argv)
    W, H, SPP = common.sizes(args, p, SIZE)
    device = common.device_or_none(args)
    if device is None:
        return 2

    from minipath_tpu_torch.bench import bench_camera
    from minipath_tpu_torch.scene.materials import Environment

    w = common.pt_workload(*common.build_scene(device), device)
    failed = []
    rows = common.cap_sweep(w, bench_camera().build_sampler((W, H), device), Environment.sky(device), args.caps,
                            width=W, height=H, spp=SPP, bounces=BOUNCES, seeds=SEEDS, failed=failed)
    out = {
        "device": common.device_name(device),
        "workload": f"atrium (ceiling panels) {W}x{H} @ {SPP}spp, {BOUNCES} bounces, {SEEDS} seeds, K2 over the f32 "
                    "layout",
        "rows": rows,
        "kernel_launches": common.kernel_launches(),
        "gates_failed": failed,
    }
    return common.finish(out, args.out)


if __name__ == "__main__":
    sys.exit(main())
