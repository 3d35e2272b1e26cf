"""Wavefront-against-megakernel convergence run.

Port of ``tools/convergence_pt.py``. Both modes sample the same estimator:
the wavefront loop only reorders rays (the compaction sort) and skips dead
packets; the megakernel mode (``compaction=False``) runs the same bounce
loop masked and uncompacted. On the atrium with its materials (480x270, 5
bounces, no NEE) this renders an spp ladder (8, 32, 128, ... up to the top
rung, 1024 by default) with the wavefront tracer and the top rung with the
megakernel, then records:

* each rung's RMSE against the top wavefront rung (about 1/sqrt(spp),
  until the top rung's own noise dominates);
* the megakernel's RMSE against the top wavefront rung, beside the Monte
  Carlo noise floor: the RMSE of a second wavefront frame of another seed
  at the top rung. ``estimators_agree`` is true where the megakernel sits
  below twice that floor;
* each rung's seconds and the two modes' speed ratio at the top rung;
* what per-pixel stratification buys at the two lowest rungs: the iid
  estimator's RMSE against the stratified one's, three seeds each.

Prints the JSON (the keys of the JAX-era ``CONVERGENCE.json``); ``--out``
also writes it.

Usage: ``python -m minipath_tpu_torch.tools.convergence_pt [--device cuda]
[--out PATH] [W H top_spp]``
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from minipath_tpu_torch.tools import common

SIZE = (480, 270, 1024)
BOUNCES = 5
PACKET = 2048
# Rays a chunk at most: the samples a chunk shrink as the frame grows (8 at
# 480x270, 2 at 1080p).
CHUNK_RAYS = 4_200_000
STRAT_SEEDS = 3


def rmse(a, b) -> float:
    return float(np.sqrt(np.mean((a[..., :3].astype(np.float64) - b[..., :3].astype(np.float64)) ** 2)))


def ladder(top: int) -> list:
    """8, 32, 128, ... below ``top``, then ``top``."""
    rungs, spp = [], 8
    while spp < top:
        rungs.append(spp)
        spp *= 4
    return rungs + [top]


def main(argv=None) -> int:
    p = common.parser("Convergence ladder of the wavefront path tracer against the megakernel.",
                      "W H top_spp (default 480 270 1024)")
    args = p.parse_args(argv)
    W, H, TOP = common.sizes(args, p, SIZE)
    device = common.device_or_none(args)
    if device is None:
        return 2

    from minipath_tpu_torch.bench import bench_camera
    from minipath_tpu_torch.render.kernels import prepare_scene_pt
    from minipath_tpu_torch.render.wavefront import make_pt_tracer, render_frame_pt
    from minipath_tpu_torch.scene.bvh.build import from_numpy
    from minipath_tpu_torch.scene.materials import Environment

    arrays, table, stack = common.build_scene(device)
    scene = prepare_scene_pt(from_numpy(arrays._asdict(), device))
    tracer, _ = make_pt_tracer(scene, stack_size=stack, packet_size=PACKET)
    sampler = bench_camera().build_sampler((W, H), device)
    env = Environment.sky(device)
    spp_chunk = max(1, min(8, CHUNK_RAYS // (W * H)))

    def frame(spp, seed, compaction, stratify=True):
        t0 = time.perf_counter()
        img = render_frame_pt(
            tracer, scene, table, sampler, torch.Generator(device=device).manual_seed(seed), width=W, height=H,
            spp=spp, bounces=BOUNCES, env=env, samples_per_packet=min(spp_chunk, spp), compaction=compaction,
            stratify=stratify,
        ).cpu().numpy()
        if not np.isfinite(img).all():
            raise FloatingPointError(f"{spp}-spp frame is not finite")
        return img, time.perf_counter() - t0

    rungs = ladder(TOP)
    common.log("warmup...")
    _, warm_wf = frame(8, 9, True)
    _, warm_mk = frame(8, 9, False)
    common.log(f"  warm: wavefront {warm_wf:.2f}s, megakernel {warm_mk:.2f}s")

    wf, times = {}, {}
    for s in rungs:
        wf[s], times[s] = frame(s, 0, True)
        common.log(f"  wavefront {s:5d} spp: {times[s]:7.2f}s")
    ref = wf[TOP]
    rung_rows = [{"spp": s, "rmse_vs_top": rmse(wf[s], ref), "seconds": round(times[s], 3)} for s in rungs[:-1]]

    floor = rmse(frame(TOP, 1, True)[0], ref)
    mk, mk_s = frame(TOP, 2, False)
    mk_rmse = rmse(mk, ref)
    common.log(f"  noise floor {floor:.5f}; megakernel {TOP} spp: {mk_s:.2f}s, rmse {mk_rmse:.5f}")

    strat_gain = []
    for s in rungs[:2]:
        frame(s, 0, True, stratify=False)  # warm the iid path
        r_iid = np.mean([rmse(frame(s, 20 + i, True, stratify=False)[0], ref) for i in range(STRAT_SEEDS)])
        r_st = np.mean([rmse(frame(s, 20 + i, True)[0], ref) for i in range(STRAT_SEEDS)])
        strat_gain.append({"spp": s, "rmse_iid": round(float(r_iid), 6), "rmse_stratified": round(float(r_st), 6),
                           "mse_reduction": round(float((r_iid / r_st) ** 2), 3)})

    out = {
        "workload": f"atrium PT {W}x{H}, {BOUNCES} bounces, top rung {TOP} spp",
        "device": common.device_name(device),
        "rungs": rung_rows,
        "top_spp": TOP,
        "wavefront_top_s": round(times[TOP], 3),
        "megakernel_top_s": round(mk_s, 3),
        "wavefront_vs_megakernel_speed": round(mk_s / times[TOP], 2),
        "noise_floor_rmse": round(floor, 6),
        "megakernel_rmse_vs_wavefront": round(mk_rmse, 6),
        "estimators_agree": bool(mk_rmse < 2.0 * floor),
        "stratified": True,
        "stratification_gain": strat_gain,
    }
    common.emit(out, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
