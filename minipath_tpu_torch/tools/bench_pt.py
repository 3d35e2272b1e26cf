"""Path-tracer benchmark: wavefront compaction against the masked megakernel.

Port of ``tools/bench_pt.py``: the atrium with its materials (250k
triangles, :func:`~minipath_tpu_torch.tools.common.build_scene`), 960x540 @
8 spp, 5 bounces, through ``render_frame_pt`` over K2 in four modes, one
warm-up and three timed frames each:

* ``wavefront``: the bounce loop with compaction (dead paths sorted to a
  suffix between bounces, live ones regrouped by direction and position);
* ``megakernel``: the same loop uncompacted (``compaction=False``, the
  CLI's ``--no-compaction``): every bounce traces the whole wavefront with
  its dead lanes masked;
* ``nee``: next-event estimation with MIS at every vertex;
* ``nee_capped``: NEE at the first vertex only.

Both estimators are the same; ``estimator_mean_delta`` (the largest channel
difference of the last frames' means) says how far the megakernel's frame
sits from the wavefront's. ``device_health`` comes from the port's
``utils/calibrate.py``. Prints the JSON (the keys of the JAX-era
``BENCH_pt.json``); ``--out`` also writes it.

Usage: ``python -m minipath_tpu_torch.tools.bench_pt [--device cuda] [--out
PATH] [W H spp]``
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from minipath_tpu_torch.tools import common

SIZE = (960, 540, 8)
BOUNCES = 5
PACKET = 2048
TIMED_FRAMES = 3
# NEE at the first vertex only: the measured Monte-Carlo-efficiency optimum on
# this scene (a sweep on the TPU, tools/sweep_pt17.py); unbiased.
NEE_CAP = 1


def main(argv=None) -> int:
    p = common.parser("Wavefront against megakernel path tracing on the atrium.", "W H spp (default 960 540 8)")
    args = p.parse_args(argv)
    W, H, SPP = common.sizes(args, p, SIZE)
    device = common.device_or_none(args)
    if device is None:
        return 2

    from minipath_tpu_torch.bench import bench_camera
    from minipath_tpu_torch.render.kernels import prepare_scene_pt
    from minipath_tpu_torch.render.wavefront import make_pt_shadow_tracer, make_pt_tracer, render_frame_pt
    from minipath_tpu_torch.scene.bvh.build import from_numpy
    from minipath_tpu_torch.scene.materials import Environment, build_light_table
    from minipath_tpu_torch.utils.calibrate import device_health

    arrays, table, stack = common.build_scene(device)
    scene = prepare_scene_pt(from_numpy(arrays._asdict(), device))
    tracer, _ = make_pt_tracer(scene, stack_size=stack, packet_size=PACKET)
    shadow, _ = make_pt_shadow_tracer(scene, stack_size=stack, packet_size=PACKET)
    lights = build_light_table(arrays.tri_packets, arrays.tri_material, table)
    sampler = bench_camera().build_sampler((W, H), device)
    env = Environment.sky(device)
    paths = W * H * SPP

    def frame_fn(compaction=True, nee=False, cap=None):
        def frame(seed):
            img = render_frame_pt(
                tracer, scene, table, sampler, torch.Generator(device=device).manual_seed(seed), width=W, height=H,
                spp=SPP, bounces=BOUNCES, env=env, samples_per_packet=min(8, SPP), compaction=compaction,
                lights=lights if nee else None, shadow_tracer=shadow if nee else None, nee_max_depth=cap,
            )
            m = img[..., :3].mean(dim=(0, 1)).cpu().numpy()
            if not np.isfinite(m).all():
                raise FloatingPointError(f"path-traced frame mean {m}")
            return m

        return frame

    modes = (
        ("wavefront", frame_fn(), 10),
        ("megakernel", frame_fn(compaction=False), 10),
        ("nee", frame_fn(nee=True), 20),
        ("nee_capped", frame_fn(nee=True, cap=NEE_CAP), 20),
    )
    results = {}
    for name, frame, first_seed in modes:
        times, m = common.frame_seconds(frame, TIMED_FRAMES, first_seed, name)
        results[name] = (times, m)
        common.log(f"{name}: {times.mean():.3f}s/frame (+-{times.std():.3f}) {paths / times.mean() / 1e6:.2f} "
                   f"Mpaths/s ({BOUNCES} bounces) mean_rgb={m.round(4)}")

    wf, mk = results["wavefront"], results["megakernel"]
    speedup = mk[0].mean() / wf[0].mean()
    delta = float(np.abs(wf[1] - mk[1]).max())
    common.log(f"speedup wavefront vs megakernel: {speedup:.2f}x; estimator mean delta: {delta:.5f}")
    nee_s, cap_s = results["nee"][0].mean(), results["nee_capped"][0].mean()
    out = {
        "metric": f"pt_atrium_{W}x{H}_{SPP}spp_{BOUNCES}bounces",
        "value": round(paths / wf[0].mean() / 1e6, 3),
        "unit": "Mpaths/s",
        "device": common.device_name(device),
        "wavefront_mean_s": round(float(wf[0].mean()), 4),
        "wavefront_std_s": round(float(wf[0].std()), 4),
        "megakernel_mean_s": round(float(mk[0].mean()), 4),
        "wavefront_vs_megakernel": round(float(speedup), 2),
        "estimator_mean_delta": round(delta, 5),
        "nee_mean_s": round(float(nee_s), 4),
        "nee_mpaths_per_s": round(paths / nee_s / 1e6, 3),
        "nee_mean_delta": round(float(np.abs(results["nee"][1] - wf[1]).max()), 5),
        # At a fixed bounce budget NEE also collects direct light at the last
        # path vertex (a shadow ray is not a bounce), so its mean sits above
        # the BSDF-only truncation.
        "nee_note": "delta vs wavefront = extra final-vertex direct light, not bias",
        "nee_capped_depth": NEE_CAP,
        "nee_capped_mean_s": round(float(cap_s), 4),
        "nee_capped_mpaths_per_s": round(paths / cap_s / 1e6, 3),
        "nee_capped_vs_wavefront": round(float(cap_s / wf[0].mean()), 2),
        "nee_capped_note": "production NEE config: light-sample the first vertex only (unbiased)",
        "device_health": device_health(device),
    }
    common.emit(out, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
