"""Where the path tracer's headline frame spends its time, phase by phase,
and how busy its trace keeps the card.

Port of ``tools/profile_pt_headline.py``, at its configuration: the atrium
with its materials (:func:`~minipath_tpu_torch.tools.common.build_scene`),
1920x1080 @ 64 spp in chunks of 2 spp (4.18M paths a chunk), 5 bounces,
compaction, BSDF sampling only. It reports:

1. the warm frame's seconds (host clock, one warm-up and two timed frames);
2. one chunk's milliseconds by CUDA events (``render_frame_pt`` at 2 spp,
   three chunks after the frames), and ``frame - chunks x chunk``, the
   seconds the frame spends between chunks;
3. a ``torch.profiler`` run over one warm chunk, which splits the chunk's
   device time by the phases the bounce loop annotates
   (``render/wavefront.py::_pt_trace``: compaction, trace, the shading, and
   the shadow trace; on the CPU the shading's own phases: environment and
   emission, BSDF scatter, NEE light sample, roulette and the state
   update), in total and bounce by bounce. This replaces the
   reference's eager re-run of the chunk with a jit boundary between
   phases. A kernel counts to the innermost annotated phase whose host code
   launched it; what no phase launched (the camera rays, the final sums) is
   ``unattributed_device_ms``. ``phase_ms`` holds the split; on the CPU it
   is host milliseconds (``phase_clock``), and the rates below are None;
4. the trace's achieved float32 operations a second: K2's own counters over
   the profiled chunk (inner visits and leaf tests, summed over its rays)
   times the op model of ``utils/roofline.py`` (``inner_ops_per_lane``: 8
   child slab tests of 25 operations a ray's inner visit;
   ``leaf_ops_per_lane``: 8 Möller–Trumbore lanes of 48 a ray's leaf test),
   over K2's device time in that chunk.

The keys are those of the JAX-era ``PROFILE_PT.json``. What changed meaning
on the card: ``eager_phase_totals_s`` holds the profiled chunk's device
seconds per annotated phase and ``eager_sum_s`` their sum (no eager re-run);
``eager_vs_fused_ratio`` is that sum over the chunk's CUDA-event time (below
1 by the unattributed work and the idle gaps); ``in_kernel_frac_of_chunk``
is K2's device time over the chunk's; ``trace_vpu_utilization`` is the
achieved rate over ``device_health``'s ``vpu_chain_gops``, the dependent
float32 chain K4 measures on this card (there is no VPU), and
``trace_fp32_peak_share`` the same rate over the card's published float32
peak (67 TFLOP/s). ``per_bounce`` entries hold each phase's milliseconds,
not the reference's ``live_after`` share, which would need a host sync a
bounce. ``--out`` also writes the JSON.

Usage: ``python -m minipath_tpu_torch.tools.profile_pt_headline [--device
cuda] [--out PATH] [W H spp]``
"""

from __future__ import annotations

import sys

import torch

from minipath_tpu_torch.tools import common
from minipath_tpu_torch.utils.profiling import annotated_ms

SIZE = (1920, 1080, 64)
SPP_CHUNK = 2
BOUNCES = 5
PACKET = 2048
TIMED_FRAMES = 2
TIMED_CHUNKS = 3
# The annotated phases of the bounce loop, in loop order. On a card a
# bounce's shading is one kernel inside `pt.shade`; on the CPU the plain
# shading's five phases nest inside it, and the split reports those.
PHASES = (
    "pt.compaction", "pt.trace", "pt.shade", "pt.environment_emission", "pt.bsdf_scatter", "pt.hit_emission",
    "pt.nee_light_sample", "pt.shadow_trace", "pt.roulette_update",
)
# K2 closest-hit's kernel, as the profiler names it.
K2_CLOSEST = "traverse_kernel<true, false>"


def phase_split(events, cuda: bool):
    """Per-phase milliseconds (device time on a card, host time on the CPU)
    of a profiled chunk, in total and per bounce; a bounce starts at its
    compaction, or at a trace that follows no compaction. On the CPU
    ``pt.shade`` is left out: its host time is that of the phases inside
    it."""
    totals = dict.fromkeys(PHASES, 0.0)
    per_bounce = []
    last = None
    names = PHASES if cuda else tuple(n for n in PHASES if n != "pt.shade")
    for name, ms in annotated_ms(events, names, cuda):
        if not per_bounce or name == "pt.compaction" or (name == "pt.trace" and last != "pt.compaction"):
            per_bounce.append(dict.fromkeys(PHASES, 0.0))
        totals[name] += ms
        per_bounce[-1][name] += ms
        last = name
    return totals, per_bounce


def main(argv=None) -> int:
    p = common.parser("Phase split and trace utilization of the path tracer's headline frame.",
                      "W H spp (default 1920 1080 64)")
    args = p.parse_args(argv)
    W, H, SPP = common.sizes(args, p, SIZE)
    device = common.device_or_none(args)
    if device is None:
        return 2

    from torch.profiler import ProfilerActivity, profile

    from minipath_tpu_torch.bench import bench_camera
    from minipath_tpu_torch.render.kernels import prepare_scene_pt
    from minipath_tpu_torch.render.wavefront import make_pt_tracer, render_frame_pt
    from minipath_tpu_torch.scene.bvh.build import from_numpy
    from minipath_tpu_torch.scene.materials import Environment
    from minipath_tpu_torch.utils.calibrate import device_health
    from minipath_tpu_torch.utils.roofline import PEAK_FP32_OPS, ops_per_visit, traversal_ops

    cuda = device.type == "cuda"
    arrays, table, stack = common.build_scene(device)
    scene = prepare_scene_pt(from_numpy(arrays._asdict(), device))
    tracer, _ = make_pt_tracer(scene, stack_size=stack, packet_size=PACKET)
    sampler = bench_camera().build_sampler((W, H), device)
    env = Environment.sky(device)
    n_chunks = -(-SPP // SPP_CHUNK)

    def render(tr, seed, spp, strat_seed=None):
        return render_frame_pt(tr, scene, table, sampler, torch.Generator(device=device).manual_seed(seed), width=W,
                               height=H, spp=spp, bounces=BOUNCES, env=env, samples_per_packet=SPP_CHUNK,
                               compaction=True, strat_seed=strat_seed)

    # 1. The whole frame.
    frame_times, _ = common.frame_seconds(lambda seed: float(render(tracer, seed, SPP)[..., :3].mean()),
                                             TIMED_FRAMES, 100, "frame")
    frame_s = float(frame_times.mean())

    # 2. One chunk, by CUDA events (the pairing seed given: no host sync).
    timer = common.DeviceTimer(device)
    chunk_ms = []
    for i in range(TIMED_CHUNKS):
        timer.start()
        render(tracer, 200 + i, SPP_CHUNK, strat_seed=200 + i)
        chunk_ms.append(timer.stop())
    chunk_s = sum(chunk_ms) / len(chunk_ms) / 1e3
    common.log(f"frame {frame_s:.3f}s, chunk {chunk_s * 1e3:.1f} ms x {n_chunks}")

    # 3. The profiled chunk, through a tracer that keeps K2's counters on
    # the device (one two-element sum a bounce, inside the trace phase).
    counts = []

    def counting(state, origin, direction, inv_direction, live=None):
        kh = tracer(state, origin, direction, inv_direction, live)
        counts.append(torch.stack([kh.inner_visits.sum(), kh.leaf_tests.sum()]))
        return kh

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        render(counting, 300, SPP_CHUNK, strat_seed=300)
        if cuda:
            torch.cuda.synchronize(device)
    events = prof.events()
    totals, per_bounce = phase_split(events, cuda)
    kernels = [e for e in events if str(e.device_type).endswith("CUDA") and e.name not in PHASES]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    # On the CPU there is no kernel: no K2 time, and no rate.
    k2_ms = sum(e.time_range.elapsed_us() for e in kernels if K2_CLOSEST in e.name) / 1e3 if cuda else None
    phase_sum_ms = sum(totals.values())

    # 4. The trace's achieved rate.
    visits, tests = (int(x) for x in torch.stack(counts).sum(dim=0).tolist())
    ops = traversal_ops("traverse_pt", visits, tests)
    gops = ops / (k2_ms / 1e3) / 1e9 if k2_ms else None
    health = device_health(device)
    vpu = health.get("vpu_chain_gops")
    inner_ops, leaf_ops = ops_per_visit("traverse_pt")
    short = {name: name.removeprefix("pt.") for name in PHASES}
    out = {
        "workload": f"atrium PT {W}x{H} @ {SPP} spp, {BOUNCES} bounces, wavefront, {n_chunks} chunks x {SPP_CHUNK} "
                    f"spp ({W * H * SPP_CHUNK / 1e6:.2f}M paths/chunk), packet {PACKET}",
        "device": common.device_name(device),
        "frame_s": round(frame_s, 4),
        "frame_times_s": [round(float(t), 4) for t in frame_times],
        "fused_chunk_s": round(chunk_s, 5),
        "chunks": n_chunks,
        "chunk_boundary_s": round(frame_s - n_chunks * chunk_s, 4),
        "chunk_boundary_frac": round((frame_s - n_chunks * chunk_s) / frame_s, 4),
        "phase_clock": "device" if cuda else "host",
        "phase_ms": {short[k]: round(v, 3) for k, v in totals.items()},
        "unattributed_device_ms": round(device_ms - phase_sum_ms, 3) if cuda else None,
        "profiled_chunk_device_ms": round(device_ms, 3) if cuda else None,
        "eager_phase_totals_s": {short[k]: round(v / 1e3, 5) for k, v in totals.items()},
        "eager_sum_s": round(phase_sum_ms / 1e3, 5),
        "eager_vs_fused_ratio": round(phase_sum_ms / 1e3 / chunk_s, 3),
        "in_kernel_frac_of_chunk": round(k2_ms / 1e3 / chunk_s, 4) if k2_ms else None,
        "k2_closest_ms": round(k2_ms, 3) if cuda else None,
        "per_bounce": [{"bounce": b, **{f"{short[k]}_ms": round(v, 3) for k, v in row.items()}}
                       for b, row in enumerate(per_bounce)],
        "trace_counters": {
            "inner_visits": visits,
            "leaf_packet_tests": tests,
            "inner_ops_per_lane": inner_ops,
            "leaf_ops_per_lane": leaf_ops,
            "total_traversal_gops": round(ops / 1e9, 3),
        },
        "trace_achieved_gops": None if gops is None else round(gops, 1),
        "vpu_chain_gops_probe": vpu,
        "trace_vpu_utilization": round(gops / vpu, 4) if gops and vpu else None,
        "trace_fp32_peak_share": round(gops / (PEAK_FP32_OPS / 1e9), 4) if gops else None,
        "device_health": health,
        "note": "eager_phase_totals_s: the profiled chunk's device seconds per annotated phase of the bounce loop; "
                "trace_vpu_utilization: the trace's float32 ops a second (K2's counters x utils/roofline.py) over "
                "the K4 chain's measured rate; trace_fp32_peak_share: over the card's published float32 peak. "
                "Ops count slab and Moller-Trumbore arithmetic only, not the stack work.",
    }
    common.emit(out, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
