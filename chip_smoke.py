#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``minipath_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Thirty-one phases,
each printing its lines as it finishes; any failure raises and the script
exits non-zero. There is no CPU path: without a CUDA device it fails at once.

1. Device: the card's name and power limit.
2. Build: compiles the five CUDA sources (``csrc/traverse.cu``: K1, K2;
   ``csrc/traverse_q.cu``: K3; ``csrc/chain.cu``: K4, K5; ``csrc/shade.cu``:
   the bounce shading; ``csrc/camera.cu``: the camera rays) with nvcc, all at once, and prints what ptxas says of
   each kernel (registers, stack frame, spills, the blocks an SM holds) and
   the chain kernels' multiplies and min/max in the SASS. Fails where a
   traversal kernel's frame exceeds its stack of 128 entries of 8 bytes, or
   where any kernel spills.
3. Kernel against its plain PyTorch version on the card, on the
   249,284-triangle procedural atrium: 16,384 coherent camera rays from the
   benchmark camera, 16,384 incoherent rays inside the atrium, and the first
   524,288 rays of one dispatch of the main path, made as ``render()`` makes
   them. Prints the agreement and the time of each version at these shapes,
   the kernel's time at the whole dispatch, and beside each time its bound
   and the bytes the launch's threads requested (from its own counters) with
   the rate that makes; phases 6 and 10 do the same. The dispatch slice
   passes its live count as a device tensor, and K1 takes it in each form
   and at its edges (0, negative, above the packets) with no host sync,
   equal bit for bit to the count given as an int.
4. Main path: ``render()`` of the atrium at 1920x1080 @ 64 spp in frame
   mode, once cold and once warm; the warm frame counts kernel launches.
   Then the same frame over two native-built trees of the same mesh: the
   CLI's (leaves of up to 56 triangles, as the Python build's) and the
   bench's (up to 24), which splits the time between this frame and the
   bench's ``f32`` frame into tree and path.
5. CLI: ``python -m minipath_tpu_torch.cli --device cuda`` writes a PNG.

Phases 6-9 drive the path tracer on the path-traced atrium (the same
procedural scene with its benchmark materials, leaves of up to 24
triangles):

6. K2 (the lean trace of ``csrc/traverse.cu``) against its plain version on
   three sets of 524,288 rays taken from a 1920x1080 @ 2 spp wavefront as
   the bounce loop makes it (camera rays traced, scattered and compacted):
   bounce-1 rays closest-hit, the NEE shadow segments of their hits
   any-hit, and 64 packets rooted at the root's child subtrees; then K2 over
   the whole 4.18M-ray bounce-1 wavefront.
7. Main path: ``render_frame_pt`` at 1920x1080 @ 64 spp, 5 bounces, NEE at
   the first vertex, cold and warm (K2's launches per mode, the shading
   kernel's launches, one a bounce of each chunk, host syncs and peak memory
   of the warm frame); then 960x540 @ 8 spp with NEE at every vertex.
8. The same 64x64 Sobol frame on the card and on the CPU (plain versions).
9. CLI: ``--integrator pt --nee`` writes a PNG.

Phases 10-12 drive the 16-bit quantized layout (K3, ``csrc/traverse_q.cu``)
on bench.py's Sponza-scale atrium (``make_atrium(600_000)``, leaves of up to
24 triangles) and on the path-traced atrium of phases 6-9:

10. K3 against its plain version on the card, in its three modes: full
    closest-hit on the first 524,288 rays of a main-path dispatch of the big
    atrium (made as phase 3 makes them), lean closest-hit on phase 6's
    bounce-1 set and any-hit on its NEE shadow set, each beside K1 or K2 on
    the same rays and the f32 layout; then K3 and K1 over the whole
    dispatch, K3 and K2 over the whole bounce-1 wavefront.
11. Parity main path on the quantized layout (bench.py's
    ``bench_big_scene``): ``render_frame`` of the big atrium at 1920x1080 @
    64 spp, 32 samples per packet, cold and warm, and the same frame over
    the f32 layout; the two means agree within 1%.
12. Path tracer on the quantized layout: bench.py's ``bench_pt_big`` (the
    big atrium, grey Lambertian, sky, 960x540 @ 8 spp, 5 bounces); phase
    7's NEE-capped 1080p frame over the path-traced atrium's ``QPTScene``,
    its mean within 1% of phase 7's under the same seed; phase 8's Sobol
    frame on ``QPTScene``, card against CPU.

13. The chain kernels and the benchmark entry point: K4 (``csrc/chain.cu``,
    the device-health probe's chain) against its plain version bit for bit
    at (512, 128) x 1, 7, 64 and 65,536 iterations; K5 in float32 and
    bfloat16 at the tool's (256, 128) x 256 and at a card-filling (16384,
    128) x 4096, bit for bit, with times and bounds; ``device_health`` on the
    card (K4 launches counted), the bf16 tool's ``main`` (K5 launches
    counted); then ``python -m minipath_tpu_torch.bench --device cuda`` in a
    subprocess under a time budget, which must exit 0, print every rung's
    line and end with the JAX bench's keys.

Phases 14-16 drive the post-process and the interactive surface. They run
after phase 9, while the path-traced atrium is on the card:

14. Denoise and AOVs at full width, on phase 7's path-traced atrium:
    ``render_frame_pt`` at 1920x1080 @ 4 spp with its variance;
    ``render_aux`` through ``make_pt_tracer`` (K2) and through
    ``make_full_tracer`` (K1), launches counted, hit masks equal and normals
    within 2e-3, and through ``make_full_tracer`` over the tree's
    ``QuantizedScene`` (K3 in full mode) against K1's by share of pixels; the
    same Sobol path-traced frame over the three tracers, host syncs counted
    (over K1 and K3 no more than over K2: each kernel reads its live count
    from device memory); ``atrous_denoise`` fixed-sigma and
    variance-guided, timed warm; the card's output against the CPU's on a
    256x256 crop; the filtered frame's RMSE against phase 7's 64-spp frame
    below the raw 4-spp frame's, its mean within 5%. Then the CLI with
    ``--denoise --aov``.
15. The GUI's controllers, headless: ``tools.bench_gui``'s ``main`` on the
    atrium at 2048x1536 (preview 1 spp, full 2 spp, two camera moves); a
    ``GuiController`` whose final image equals ``render()``'s in tile mode
    for the same seed bit for bit and its frame-mode image by mean and
    coverage (frame mode draws its jitter in one dispatch of all tiles, tile
    mode in twelve of 64, so those two cannot be equal); an ``abort()`` in
    the middle of a 64-spp render; then the progressive path-traced
    viewport of ``_make_pt_controller`` at 1024x768: 64 passes with the
    guide buffers, one ``display_image()`` with the filter, a camera move.
16. The analytic sphere: ``render()`` of ``Scene(Sphere())`` at 1920x1080 @
    64 spp in frame mode; no kernel launches; mean and coverage against the
    CPU's frame at 256x144.

Phases 17 and 18 drive multi-device rendering and adaptive sampling. They
run after phase 12, while every scene is on the card; a mesh there is the
one card four times (with more cards, also the real devices):

17. Sharded: ``render_frame(mesh=)`` at 1920x1080 @ 64 spp in Sobol
    mode against ``render_frame`` under the same seed, bit for bit over the
    atrium's f32 layout (K1) and, over the big atrium's ``QuantizedScene``
    (K3), by the share of solid pixels that agree (the JAX package's check);
    ``render()`` with ``mesh=`` in tile and in frame mode, ``array_equal``
    with ``render()``; the NEE-capped path-traced frame of phase 7 through
    ``render_frame_pt(mesh=)`` (K2) in chunks of 2 and of 8 samples, its
    channel means within 0.5% of phase 7's and its values within 0.25 of
    phase 7's as often as a second unsharded frame's are, and a Sobol frame
    with no roulette sharded against ``render_frame_pt``, 99% of its pixels
    within 1e-3. Warm seconds sharded and unsharded, and every kernel's
    launches by path.
18. Adaptive: ``render_frame_pt_adaptive`` on the path-traced atrium at
    1920x1080, a 64-spp budget with a 2-spp pilot and chunks of 8, NEE at
    depth 1: its spp map's mean within one chunk of the budget, its image
    mean within 1% of phase 7's uniform frame; rounds, K2 launches, warm
    seconds and host syncs. Then the CLI's ``--integrator pt --adaptive``
    and ``--devices 0`` each write a PNG, and ``--devices`` beyond the cards
    present exits 2.

Phase 19 runs after phase 18; phase 20 after phase 13:

19. The two-level tracer (``render/twolevel.py``: a broad phase over the
    BVH's top-level treelets, then K2 closest-hit with per-packet roots, most
    of them leaves): phase 6's 4.18M-ray bounce-1 wavefront through it at
    (levels, rounds) = (2, 1), (2, 2) and (3, 2) against the flat tracer
    (tri on 99.99% of rays, t within 1e-5, no overflow, rounds + 1 launches,
    no host sync in a warm trace under ``set_sync_debug_mode("error")``),
    with both traces' times; then phase 7's NEE-capped 1080p frame through it,
    cut to 32 spp to hold the script near ten minutes (channel means within
    0.5% of phase 7's, launches, warm seconds), and a
    960x540 @ 8 spp Sobol frame with no roulette against the flat tracer's
    (99.9% of values equal).
20. The path tracer's tools, each ``python -m minipath_tpu_torch.tools.<name>
    --device cuda --out ...`` in a subprocess at its full size:
    ``bench_pt`` (wavefront, megakernel, NEE, NEE at depth 1; the
    megakernel's mean within 0.01 of the wavefront's), ``isolate_qpt`` (K3
    against K2 on the same scene and rays), ``profile_pt_headline`` (the
    headline frame's device time by phase of the bounce loop, the trace's
    float32 rate) and ``convergence_pt`` with its top rung cut to 256 spp
    (``estimators_agree``). Each must exit 0 and print the keys of its
    JAX-era artifact (``BENCH_pt.json``, ``ISOLATE_QPT.json``,
    ``PROFILE_PT.json``, ``CONVERGENCE.json``).

Phase 21 runs after phase 7, while phase 6's ray sets are on the card;
phases 22-24 after phase 20, each tool in a subprocess at its full size:

21. ``shadow_sort``: phase 7's NEE-capped 1080p @ 64 frame under each of
    ``"pos"``, ``"dir"``, ``"light"`` and ``"fromlight"`` (then ``"pos"``
    again), warm seconds and K2's any-hit milliseconds by CUDA events around
    each launch; the same frame in Sobol mode with a fixed pairing seed,
    where ``"dir"`` and ``"light"`` equal ``"pos"`` bit for bit (occlusion
    is decided per segment) and ``"fromlight"``, which traces each segment
    reversed, agrees on 99.5% of pixels within 1e-5 with channel means within
    0.1%; then the portable engine (``make_portable_tracer``,
    ``make_portable_shadow_tracer``) against K2 on phase 6's 524,288 bounce-1
    rays (tri on 99.99%, t within 1e-5 relative plus 1e-6 on 99.99% of the
    same hits) and its shadow set (occlusion equal).
22. ``tools.parity_big``: K3 lean over the quantized layout and K2 over the
    f32 one against the portable engine on the 649,684-triangle atrium,
    by rays, by occlusion and by frames, its gates enforced.
23. ``tools.demo_bigscene`` (1.5M triangles) and ``tools.demo_hugescene``
    (4,999,484 triangles with materials): both layouts' bytes, the parity
    frame at 1920x1080 @ 16 over K1 and K3, the path-traced frame at 960x540
    @ 4 over K2 and K3 lean, the portable engine's rate, their gates; then
    K1, K2 and K3 (full and lean) on the 5M scene, loaded from the tool's
    cache, against their plain versions on 524,288 rays each.
24. ``tools.bench_quality``: the estimator sections of ``QUALITY.json`` over
    K2, its gate holding K2's frame to the portable engine's.

Phase 25 runs after phase 5, phase 26 after phase 24:

25. ``render(backend="portable")``: the atrium of phases 3-4 at 256x144 @ 4
    spp, 64-px tiles, in frame and in tile mode, against ``render()`` for the
    same seed (alpha equal, RGB within one 8-bit level on at most 0.1% of
    the values), both times, no kernel launched by the portable engine; then
    the portable frame over a mesh of the card twice, bit for bit.
26. The sweeps and the tree tools, each ``python -m
    minipath_tpu_torch.tools.<name> --device cuda --out ...`` in a
    subprocess: ``sweep_rr2`` (roulette start and floor, the tail cutoff),
    ``sweep_pt17`` and ``sweep_pt19`` (the NEE depth cap on the atrium and on
    the two rooms), ``sobol_cost``, ``sweep_adaptive``, ``perf_leaf`` (K1
    over five leaf sizes), ``tree_quality`` and ``sweep_sbvh`` (K2 over the
    SBVH and the binned-SAH trees), at the JAX tools' sizes but
    ``sweep_sbvh``, cut to 60,000 triangles (its NumPy SBVH build takes
    minutes at 250k). Each must exit 0 (each enforces its gates: unbiased
    means within 1% of their baseline; two trees agreeing on hit or miss and
    on t) and print the keys of its JAX-era artifact and of its rows.

Phases 27 and 28 run after phase 26:

27. ``render()``'s frame mode at tile sizes off the packet's 16 pixels, on
    the atrium of phases 3-4: at ``tile_size`` 40, 320x320 and 1920x1080 @ 4
    spp, and at 24, 640x360 @ 8 spp, two frame-mode renders with one seed
    (equal bit for bit), their image against their own tiles written back
    at their extents on the host (equal bit for bit), and tile mode once:
    equal bit for bit at 64 tiles (320x320), by mean and coverage past that
    (tile mode draws its jitter in dispatches of 64 tiles). Then the
    1920x1080 @ 64 spp frame at 64-px tiles, warm, beside PERF.md §5's
    figure, and the placement alone on one batch of that frame, against the
    placement before the repair.
28. The port as it is installed: a wheel of this checkout built offline
    (``pip wheel --no-build-isolation``; fails where the interpreter has no
    setuptools), installed with ``--target`` into a temporary directory, its
    package made read-only; in a subprocess that sees only the installation,
    with its working directory, ``HOME`` and ``XDG_CACHE_HOME`` temporary:
    ``traverse.cu``, ``traverse_q.cu``, ``chain.cu`` and the native library
    built (each into the user's cache, each build's seconds printed), a
    small scene cached by the tools' builder (into the user's cache, nothing
    beside the package), K1, K3 (full) and K4 launched once each against
    their plain versions, and the native tree of ``make_atrium(0)``, held to
    the checkout's bit for bit.

Phase 30 runs after phase 11:

30. The ``q16-600k-1080p64`` cell's path: the big atrium built as the CLI
    builds it under ``--layout q16`` (natively, leaves of up to 56
    triangles, ``layout="q16"``), K3 over its first main-path dispatch's
    first 524,288 rays against its plain version, then one ``render()``
    frame in tile mode at 1920x1080 @ 64 spp, 64-px tiles, with a
    finished-tile callback, its launches counted from zero: 16 K3 full
    launches (8 dispatches of two 32-spp passes) and no other traversal.

Phase 29 runs after phase 7:

29. The bounce-shading kernel (``csrc/shade.cu``) against its plain version
    on the main path's state at full width: the first 8-spp chunk of a
    pt-1080p64-nee1 frame (16,711,680 lanes; bounce 0 with NEE, bounces 1-4
    compacted, path roulette from bounce 3), each bounce shaded by
    ``_shade_kernel`` and ``_shade_plain`` from one generator state. Every
    output equal on every lane (the state; the NEE segment on its
    candidates; the generator after), each branch the scene offers taken
    (Lambertian, glossy metal, glass, glass that cannot refract, emitters,
    MIS-weighted emitter hits, NEE candidates; the hall is closed, so no
    lane misses, and no metal is a mirror); the lanes by
    branch, the kernel's time alone and with its uniforms' draws, the plain
    version's, and its bound by the bytes each lane class must move; then
    the same for a frame of eight such chunks.

Phase 32 runs after phase 29:

32. The compaction kernels (``csrc/compact.cu``) against the plain
    compaction on the main path's state at full width: the states that
    enter the compaction at bounces 1-4 of the first 8-spp chunk of a
    pt-1080p64-nee1 frame (16,711,680 lanes), each compacted by
    ``_compact_kernel`` and ``_compact_plain``; every field of the result
    equal on every lane (the permutation among them). ptxas' report; the
    time of the key and permute kernels and their bound by bytes (the
    kernels line's row); the kernel path's time with the bounding box and
    ``torch.sort``, and its bound; the plain path's time; each stage's time
    and bound, and both paths' peak memory; then the sum of the four
    bounces for a frame of eight chunks.

Phase 33 runs after phase 32:

33. The ``pt-tworooms-1080p64`` cell's path on its own tree (the two rooms,
    ``make_tworooms(150_000)``, built natively at leaves of up to 56 as the
    CLI's ``--scene tworooms`` builds them): the first 8-spp chunk of the
    cell's frame (7 bounces, NEE at every vertex, no environment), whose
    bounces 1-6 are shaded by ``_shade_kernel`` and ``_shade_plain`` and
    whose compactions by ``_compact_kernel`` and ``_compact_plain``, every
    lane and field equal (the MIS pdf included); then a whole 64-spp frame
    with its launches counted from zero: 56 K2 closest-hit, 56 any-hit, 56
    shading, 48 key and 48 permute passes, 56 of each of the shadow
    batch's four. ``--tworooms-only`` runs it alone.

Phase 34 runs after phase 33:

34. The NEE shadow batch's kernels (``csrc/shadow.cu``) against the plain
    shadow batch at full width: the batches of bounces 0-6 of the first
    8-spp chunk of a pt-tworooms-1080p64 frame (on the cell's tree) and of
    bounce 0 of a pt-1080p64-nee1 chunk (16,711,680 lanes each), through
    ``_shadow_light_kernel`` and ``_shadow_light_plain``: the key, the live
    packets' rows, the radiance and the counts equal on every lane. ptxas'
    report; each batch's candidates' share, each route's time (CUDA
    events), K2 any-hit's, the sort's share, each pass's time against its
    bound by bytes (``shadow_bytes``); each cell's frame of 8 chunks.

Phase 31 runs after phase 3:

31. The camera-ray kernel (``csrc/camera.cu``) against the plain chain
    (``sample_rays`` and ``rays_to_rays9``) from one generator state: one
    parity dispatch pass as ``render()`` makes it in tile mode (64 tiles x
    32 spp, 8,388,608 lanes) and one pt-1080p64-nee1 chunk (8 spp of the
    frame's 16 x 16 blocks, 16,711,680 lanes), every lane equal and the
    generator left in the same state; ptxas' report, the kernel's time
    alone and with its draws, the plain chain's, the peak memory of each and
    the kernel's share of its byte bound (52 B a lane at 3.35 TB/s); then a
    ``render()`` frame at 1920x1080 @ 64 spp in tile mode with a callback:
    16 camera launches, ``camera.kernel_lanes`` 133,693,440.

``python3 chip_smoke.py --kernels-only`` runs phases 1, 2, 3, 31, 6, 29, 32,
34 and 10 alone: the traversal, camera, shading, compaction and shadow-batch
kernels against their plain versions, with their times, bounds and requested
bytes (about four minutes, most of it the scene builds).

``python3 chip_smoke.py --profile DIR`` also writes a ``torch.profiler``
summary of one warm path-traced frame to DIR, over the f32 layout (after
phase 9) and over the quantized one (after phase 12).

The line before the last is a JSON object describing each kernel (its time,
its plain version's time, its launches on the main path and its bound: the
larger of its operations over the card's peak rate for their type and its
bytes over the HBM rate); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
WIDTH, HEIGHT, SPP, TILE = 1920, 1080, 64, 64
RAYS_PER_SET = 16_384
# Packets of the main path's dispatch checked and timed against the plain
# version: 64 x 8192 = 524,288 rays.
DISPATCH_SLICE = 64
# Tolerances of the kernel against its plain version (same arithmetic order
# and IEEE steps, so all but ties agree exactly; the normal differs by
# rsqrtf against torch.rsqrt).
TRI_MATCH, T_RTOL, NORMAL_ATOL = 0.9999, 1e-5, 1e-4
# The path tracer's cells (bench.py's pt_1080p64_nee_capped and nee).
PT_WIDTH, PT_HEIGHT, PT_SPP, PT_BOUNCES = 1920, 1080, 64, 5
PT_PACKET = 2048
PT_SET_PACKETS = 256  # 256 x 2048 = 524,288 rays per K2 set
UV_ATOL = 1e-5
# Phase 8: the card against the CPU on one Sobol frame.
FRAME_PIXEL_ATOL, FRAME_PIXEL_SHARE, FRAME_MEAN_RTOL = 1e-3, 0.99, 5e-3
# Phases 11-12: a frame over the quantized layout against the f32 one.
LAYOUT_MEAN_RTOL = 0.01
# bench.py's Sponza-scale scene.
BIG_TRIANGLES = 600_000
# Phase 14: the filter on the card against the CPU on a crop (the card's exp
# and pow differ from the CPU's in the last bits, which the power of 128 on
# the normal term scales up and four iterations compound), the two aux
# traces against each other (f16 normals against f32), the filtered frame's
# mean against the raw one's.
DENOISE_SPP, DENOISE_CROP = 4, 256
DENOISE_RTOL, DENOISE_ATOL, DENOISE_SHARE, DENOISE_MAX_ABS = 1e-4, 1e-5, 0.999, 1e-3
AUX_NORMAL_ATOL, DENOISE_MEAN_RTOL = 2e-3, 0.05
# K3's first hits against K1's on the same rays (the quantized vertices move a
# silhouette by a fraction of a pixel): the share of pixels that must agree.
AUX_Q_DEPTH_RTOL, AUX_Q_NORMAL_ATOL, AUX_Q_SHARE = 1e-3, 1e-2, 0.99
# Phase 15: the reference GUI benchmark's size; the viewport's.
GUI_SIZE, GUI_ABORT_SPP, VIEWPORT_SIZE, VIEWPORT_PASSES = (2048, 1536), 64, (1024, 768), 64
# Phases 15 and 16: two renders of one scene whose jitter differs.
STAT_RTOL = 5e-3



def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def bench_camera():
    from minipath_tpu_torch import Camera

    # The atrium benchmark camera: inside the hall, down the colonnade.
    return Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(36e-3)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs, after one
    warm-up run."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def traversal_bound(kernel, rows, r9, hits, **kw):
    """The least time the card could take for one traversal launch, as
    ``(ms, "operations" or "bytes", text)``: the larger of its float32
    operations over the FP32 peak and its bytes over the HBM rate. The
    operations come from the launch's own counters (inner visits x 8 child
    boxes, leaf packets x 8 lanes); the bytes are the rays read once, the
    outputs and counters written once, and each scene row the traversal
    touches read once, found by the plain traversal over ``rows`` (K1's
    layout; K3's decompressed rows keep its indices) with the launch's
    arguments ``kw``."""
    from minipath_tpu_torch.render import kernels
    from minipath_tpu_torch.scene.bvh import links as L
    from minipath_tpu_torch.utils.roofline import COST, PEAK_FP32_OPS, PEAK_HBM_BYTES, traversal_ops

    node_b, packet_b, first_b, hit_b, out_b = COST[kernel][2:]
    touched = {}
    kernels._traverse_reference(rows, r9, touched=touched, **kw)
    B, _, P = r9.shape
    ops = traversal_ops(kernel, hits.inner_visits.sum(), hits.leaf_tests.sum())
    n_nodes, n_packets = int(touched["nodes"].sum()), int(touched["packets"].sum())
    n_hit = int(torch.unique(hits.tri[hits.tri >= 0]).numel())
    # The touched packets that are the first of their leaf.
    leaf_links = rows.node_links[(rows.node_links & L.COUNT_MASK) != 0]
    first = torch.zeros_like(touched["packets"])
    first[(leaf_links >> L.COUNT_BITS).long()] = True
    if rows.root & L.COUNT_MASK:
        first[rows.root >> L.COUNT_BITS] = True
    n_first = int((touched["packets"] & first).sum())
    nbytes = (B * P * (9 * 4 + out_b) + B * 3 * 4 + n_nodes * node_b + n_packets * packet_b + n_first * first_b
              + n_hit * hit_b)
    op_ms, byte_ms = ops / PEAK_FP32_OPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    by = "operations" if op_ms >= byte_ms else "bytes"
    text = (f"bound {max(op_ms, byte_ms):.4f} ms by {by} ({ops / 1e9:.3f} Gop = {op_ms:.4f} ms; "
            f"{nbytes / 1e6:.2f} MB = {byte_ms:.4f} ms: {n_nodes} node rows, {n_packets} packets, {n_hit} hit "
            f"triangles)")
    return max(op_ms, byte_ms), by, text


def requested(kernel, hits, ms) -> str:
    """The bytes the launch's threads asked the caches for, from its own
    counters (``utils/roofline.py::REQUESTED``), and the rate that makes
    over ``ms``."""
    from minipath_tpu_torch.utils.roofline import REQUESTED

    node_b, packet_b = REQUESTED[kernel]
    nbytes = int(hits.inner_visits.sum()) * node_b + int(hits.leaf_tests.sum()) * packet_b
    return f"requested {nbytes / 1e6:.1f} MB = {nbytes / ms / 1e9:.3f} TB/s"


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA GPU")
    import minipath_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("1 device", f"{torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | python {sys.version.split()[0]}")
    return smi


def phase_build():
    """The seven sources at once, one nvcc each."""
    from concurrent.futures import ThreadPoolExecutor

    from minipath_tpu_torch.render import camera_rays, compact, kernels, kernels_q, shade, shadow
    from minipath_tpu_torch.utils import calibrate

    t0 = time.perf_counter()
    loaders = (kernels.load_library, kernels_q.load_library, calibrate.load_library, shade.load_library,
               camera_rays.load_library, compact.load_library, shadow.load_library)
    with ThreadPoolExecutor(len(loaders)) as pool:
        libs = [f.result() for f in [pool.submit(load) for load in loaders]]
    from minipath_tpu_torch.render.kernels import STACK_CAPACITY

    for built in libs:
        regs = [ln.strip() for ln in built.log.splitlines() if "registers" in ln or "spill" in ln]
        log("2 build", f"{built.path.name} nvcc {built.build_seconds:.2f}s | {' | '.join(regs)}")
    for built, name in zip(libs[:2], ("traverse.cu", "traverse_q.cu")):
        # A traversal thread keeps its stack of 8-byte entries in local memory
        # and nothing else: a larger frame means that an array left the
        # registers.
        usage = ptxas_usage(built.log)
        log("2 build", f"{name}: {json.dumps(usage)}")
        if len(usage) != 3:
            raise AssertionError(f"{name}: expected ptxas' report of three kernels, got {usage}")
        for u in usage:
            if u["stack_frame"] > STACK_CAPACITY * 8 or u["spill_stores"] or u["spill_loads"]:
                raise AssertionError(f"{name}: a frame beyond the {STACK_CAPACITY * 8} B stack, or spills: {u}")
    # The bounce-shading kernel keeps a lane's state in registers; its small
    # frame is the slow path of sinf and cosf.
    usage = ptxas_usage(libs[3].log)
    log("2 build", f"shade.cu: {json.dumps(usage)}")
    if len(usage) != 1 or usage[0]["spill_stores"] or usage[0]["spill_loads"]:
        raise AssertionError(f"shade.cu: expected one kernel without spills, got {usage}")
    usage = ptxas_usage(libs[5].log)
    log("2 build", f"compact.cu: {json.dumps(usage)}")
    if len(usage) != 2 or any(u["spill_stores"] or u["spill_loads"] for u in usage):
        raise AssertionError(f"compact.cu: expected two kernels without spills, got {usage}")
    usage = ptxas_usage(libs[6].log)
    log("2 build", f"shadow.cu: {json.dumps(usage)}")
    if len(usage) != 4 or any(u["spill_stores"] or u["spill_loads"] for u in usage):
        raise AssertionError(f"shadow.cu: expected four kernels without spills, got {usage}")
    log("2 build", f"all seven built and loaded in {time.perf_counter() - t0:.2f}s")
    log("2 build", f"chain kernels' SASS: {json.dumps(chain_sass_counts(libs[2].path))}")


def ptxas_usage(build_log: str) -> list:
    """What ``ptxas -v`` says of each kernel in a build's log: registers,
    stack frame and spill bytes, and the blocks of 128 threads that the
    registers let one SM hold (65,536 registers, allocated to a warp in units
    of 256; at most 16 such blocks by threads)."""
    frames = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", build_log)
    used = re.findall(r"Used (\d+) registers", build_log)
    out = []
    for (frame, stores, loads), regs in zip(frames, used):
        per_warp = -(-int(regs) * 32 // 256) * 256
        out.append({"registers": int(regs), "stack_frame": int(frame), "spill_stores": int(stores),
                    "spill_loads": int(loads), "blocks_per_sm": min(16, 65536 // (per_warp * 4))})
    return out


def chain_sass_counts(library: Path) -> dict:
    """Multiplies (``HFMA2`` with a zero addend is one) and min/max of each
    chain kernel in the built library's SASS (``cuobjdump -sass``): the
    loop's body as the compiler unrolled it, its remainder loops and the few
    instructions before them."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = "bf16x2" if "nv_bfloat162" in name else "f32"
            counts[name] = {}
        elif name is not None:
            for op in ("FMUL", "FMNMX", "HMUL2", "HFMA2", "HMNMX2"):
                if re.search(rf"\b{op}\b", line):
                    counts[name][op] = counts[name].get(op, 0) + 1
    return counts


def dispatch_rays9(sampler, device, generator):
    """Camera rays of the main path's first dispatch, made as ``render()``
    makes them: the first batch of centre-out tiles, one pass of 32 spp,
    packets of 16x16 px x 32 samples, sample-major, jittered strata."""
    from minipath_tpu_torch.render import integrator
    from minipath_tpu_torch.render.machinery import (
        MAX_RAYS_PER_DISPATCH, PACKET_SHAPE, SAMPLES_PER_PASS,
    )
    from minipath_tpu_torch.screen_block import ScreenBlock

    tiles = ScreenBlock.with_size((0, 0), (WIDTH, HEIGHT)).tile_ordering(TILE, rng=np.random.default_rng(0))
    k = MAX_RAYS_PER_DISPATCH // (TILE * TILE * SAMPLES_PER_PASS)
    origins = torch.tensor(np.array([t.min for t in tiles[:k]], np.float32), device=device)
    return integrator.tile_batch_rays9(
        sampler, origins, generator, 12345,
        tile_shape=(TILE, TILE), packet_shape=PACKET_SHAPE, spp=SAMPLES_PER_PASS,
    )


def compare(name, got, want):
    """Agreement of the kernel's hits with the plain version's; raises on a
    disagreement beyond the tolerances."""
    same = got.tri == want.tri
    match = same.float().mean().item()
    t_rel = ((got.t - want.t).abs() / want.t.abs().clamp_min(1e-30))[same].max().item()
    t_abs = (got.t - want.t).abs()[same].max().item()
    n_abs = (got.normal - want.normal).abs()[same].max().item()
    mat_ok = torch.equal(got.material[same], want.material[same])
    ovf = (int(got.overflow.sum()), int(want.overflow.sum()))
    counters_ok = all(torch.equal(getattr(got, c), getattr(want, c)) for c in ("inner_visits", "leaf_tests"))
    n = got.t.numel()
    text = (f"{name} {tuple(got.t.shape)} = {n} rays: tri match {match:.6f}, hit rate "
            f"{(got.tri >= 0).float().mean().item():.4f}, max t rel err {t_rel:.3g}, max normal err "
            f"{n_abs:.3g}, materials equal {mat_ok}, overflow kernel/plain {ovf}, counters equal "
            f"{counters_ok}, inner visits/ray {got.inner_visits.sum().item() / n:.1f}, "
            f"leaf tests/ray {got.leaf_tests.sum().item() / n:.1f}")
    if match < TRI_MATCH or t_rel > T_RTOL or n_abs > NORMAL_ATOL or not mat_ok or ovf != (0, 0):
        raise AssertionError(f"kernel disagrees with its plain version on {name} rays: {text}")
    if not counters_ok:
        raise AssertionError(f"counters differ on {name} rays: {text}")
    return text, max(t_abs, n_abs)


K1_FIELDS = ("t", "tri", "normal", "material", "overflow", "inner_visits", "leaf_tests")


def check_live_counts(scene, r9, stack, all_live, device) -> str:
    """K1 on ``r9``, ``B`` packets, with its live count in each form (None,
    an int, a one-element int32 and int64 tensor on the card) and at the
    edges (0, a negative count, one above ``B``): each launch makes no host
    sync (``set_sync_debug_mode("error")``), its outputs equal those of the
    count as an int bit for bit, and the plain version's (``all_live`` where
    every packet is live) bit for bit but the normal, within
    ``NORMAL_ATOL``. Raises on a difference."""
    from minipath_tpu_torch.render import kernels

    B = r9.shape[0]
    half = B // 2

    def on_card(value, dtype):
        return torch.tensor([value], dtype=dtype, device=device)

    counts = {"None": (None, B), "int": (half, half), "int32 tensor": (on_card(half, torch.int32), half),
              "int64 tensor": (on_card(half, torch.int64).reshape(()), half),
              "zero": (on_card(0, torch.int32), 0), "negative": (on_card(-3, torch.int32), -3),
              "above B": (on_card(B + 5, torch.int32), B + 5)}
    plain = {B: all_live}
    for n in (half, 0):
        plain[n] = kernels.trace_packets_reference(scene, r9, stack_size=stack, live_packets=n)
    torch.cuda.synchronize()
    said = []
    for label, (live, count) in counts.items():
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = kernels.trace_packets(scene, r9, stack_size=stack, live_packets=live)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        as_int = kernels.trace_packets(scene, r9, stack_size=stack, live_packets=count)
        want = plain[max(0, min(B, count))]
        differ = [f for f in K1_FIELDS if not torch.equal(getattr(got, f), getattr(as_int, f))]
        exact = [f for f in K1_FIELDS if f != "normal"]
        differ += [f"plain {f}" for f in exact if not torch.equal(getattr(got, f), getattr(want, f))]
        n_err = (got.normal - want.normal).abs().max().item()
        if differ or n_err > NORMAL_ATOL:
            raise AssertionError(f"K1 with live_packets {label} ({count}) differs in {differ}, normal {n_err:.3g}")
        said.append(f"{label} {int((got.tri >= 0).sum())} hits")
    return (f"live count on {B} dispatch-slice packets, each launch without a host sync, equal bit for bit to the "
            f"int path and (normals within {NORMAL_ATOL}) the plain version: {', '.join(said)}")


def phase_kernel(bvh, device):
    from minipath_tpu_torch.camera import sample_rays
    from minipath_tpu_torch.geometry.ray import make_rays
    from minipath_tpu_torch.render import integrator, kernels

    scene = bvh.kernel_scene(device)
    stack = bvh.recommended_stack_size
    gen = torch.Generator(device=device).manual_seed(0)

    # Coherent: the central 128x128 pixels of the benchmark view, packets of
    # 16x16 pixels, one sample each.
    sampler = bench_camera().build_sampler((WIDTH, HEIGHT), device)
    pix = integrator.tile_pixel_packets((WIDTH // 2 - 64, HEIGHT // 2 - 64), (128, 128), (16, 16), device)
    coherent = kernels.rays_to_rays9(sample_rays(sampler, pix, gen))
    # Incoherent: origins inside the atrium's box, directions uniform.
    rng = np.random.default_rng(1)
    lo, hi = np.asarray(bvh.host_arrays.bbox_min), np.asarray(bvh.host_arrays.bbox_max)
    o = rng.uniform(lo + 0.5, hi - 0.5, (64, 256, 3)).astype(np.float32)
    d = rng.normal(size=(64, 256, 3)).astype(np.float32)
    incoherent = kernels.rays_to_rays9(make_rays(torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)))
    assert coherent.shape == incoherent.shape == (64, 9, RAYS_PER_SET // 64)
    # The main path's own dispatch, (4096, 9, 8192), and its first
    # DISPATCH_SLICE packets: enough blocks for several waves on the card,
    # few enough for the plain version.
    dispatch = dispatch_rays9(sampler, device, gen)
    part = dispatch[:DISPATCH_SLICE]

    results = {}
    for name, r9 in (("coherent", coherent), ("incoherent", incoherent), ("dispatch slice", part)):
        # The main path's slice takes its live count as a device tensor, as
        # the bounce loop gives it: every packet live.
        live = torch.tensor([r9.shape[0]], dtype=torch.int32, device=device) if r9 is part else None
        got = kernels.trace_packets(scene, r9, stack_size=stack, live_packets=live)
        torch.cuda.synchronize()
        want = kernels.trace_packets_reference(scene, r9, stack_size=stack)
        text, err = compare(name, got, want)
        ms = cuda_ms(lambda: kernels.trace_packets(scene, r9, stack_size=stack, live_packets=live), 20)
        plain_ms = cuda_ms(lambda: kernels.trace_packets_reference(scene, r9, stack_size=stack), 1)
        bound_ms, bound_by, bound = traversal_bound("traverse", scene, r9, got, stack_size=stack, t_max=math.inf,
                                                    live_packets=None)
        log("3 kernel", f"{text} | kernel {ms:.4f} ms, plain {plain_ms:.2f} ms | {bound} | "
            f"{requested('traverse', got, ms)}")
        results[name] = dict(ms=ms, plain_ms=plain_ms, err=err, bound_ms=bound_ms, bound_by=bound_by)

    log("3 kernel", check_live_counts(scene, part, stack, want, device))

    n = dispatch.shape[0] * dispatch.shape[2]
    ms = cuda_ms(lambda: kernels.trace_packets(scene, dispatch, stack_size=stack), 5)
    got = kernels.trace_packets(scene, dispatch, stack_size=stack)
    log("3 kernel", f"main-path dispatch {tuple(dispatch.shape)} = {n} rays: kernel {ms:.3f} ms "
        f"= {n / ms / 1e3:.1f} Mrays/s, {requested('traverse', got, ms)} (no plain version at this size: its "
        f"stack alone is {n * stack * 12 / 1e9:.0f} GB)")
    return results


def phase_main_path(bvh, device, smi, native_trees=()):
    from minipath_tpu_torch import RenderSettings, Scene, render
    from minipath_tpu_torch.render import kernels

    settings = RenderSettings(TILE, SPP, (WIDTH, HEIGHT))
    camera = bench_camera()

    def frame(bvh=bvh):
        p = render(Scene(bvh), camera, settings, device=device)  # frame mode: no callbacks
        p.wait()
        img = p.image()
        snap = p.progress()
        if snap.finished != snap.total or snap.total != 30 * 17:
            raise AssertionError(f"{snap.finished}/{snap.total} tiles finished")
        if img.shape != (HEIGHT, WIDTH, 4) or img.dtype != np.uint8:
            raise AssertionError(f"image {img.shape} {img.dtype}")
        return p, img

    p_cold, img_cold = frame()
    kernels.trace_packets.launches = 0
    p, img = frame()
    launches = kernels.trace_packets.launches
    coverage = float((img[..., 3] > 0).mean())
    if launches == 0:
        raise AssertionError("the main path launched no traversal kernel")
    if not coverage > 0:
        raise AssertionError("the frame has no hit")
    seconds = p.elapsed()
    rays = WIDTH * HEIGHT * p.spp_effective
    timers = p.timings().summary()
    log("4 main path", f"render() {WIDTH}x{HEIGHT} @ {p.spp_effective} spp on {smi}: warm frame "
        f"{seconds:.3f} s = {rays / seconds / 1e6:.1f} Mrays/s (cold {p_cold.elapsed():.3f} s) | "
        f"kernel launches {launches} | alpha coverage {coverage:.4f}, mean value "
        f"{img[..., 0].mean() / 255:.4f} | warm == cold image: {np.array_equal(img, img_cold)} | "
        f"phases {json.dumps(timers)}")
    # The same mesh built by the native C++ code, as the CLI and the bench build it.
    for label, tree in native_trees:
        frame(tree)
        times = []
        for _ in range(3):
            p_n, img_n = frame(tree)
            times.append(p_n.elapsed())
        stats = tree.statistics()
        log("4 main path", f"render() over {label} ({stats['inner_nodes']} inner nodes, max depth "
            f"{stats['max_depth']}, leaf fill {stats['leaf_fill_triangles']}): warm frames "
            f"{' '.join(f'{t:.4f}' for t in times)} s against {seconds:.4f} s over the Python-built tree | alpha "
            f"coverage {float((img_n[..., 3] > 0).mean()):.4f}, mean value {img_n[..., 0].mean() / 255:.4f} | phases "
            f"{json.dumps(p_n.timings().summary())}")
        if abs(float(img_n[..., 0].mean()) - float(img[..., 0].mean())) > STAT_RTOL * float(img[..., 0].mean()):
            raise AssertionError(f"the frame over {label} is not the Python-built tree's")
    return launches


def phase_cli():
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "atrium.png"
        cmd = [sys.executable, "-m", "minipath_tpu_torch.cli", "--scene", "atrium", "--width", "512",
               "--height", "384", "--spp", "16", "--device", "cuda", "-q", "--no-stats", "-o", str(out)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0 or not out.exists():
            raise AssertionError(f"CLI failed (exit {proc.returncode}):\n{proc.stderr[-4000:]}")
        from PIL import Image

        img = np.asarray(Image.open(out))
        if img.shape != (384, 512, 4) or not (img[..., 3] > 0).any():
            raise AssertionError(f"CLI image {img.shape} has no hit")
        said = [ln for ln in proc.stderr.splitlines() if ln.startswith("rendered")]
        log("5 cli", f"exit 0 in {time.perf_counter() - t0:.1f}s, {out.name} {img.shape} | {' '.join(said)}")


def build_pt_atrium():
    """The path-traced atrium as bench.py builds it: ``make_atrium(250_000)``,
    ``atrium_materials``, leaves of up to 24 triangles."""
    from minipath_tpu_torch.scene.procedural import atrium_materials, make_atrium
    from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh

    t0 = time.perf_counter()
    mesh = make_atrium(250_000)
    ids, dicts = atrium_materials(mesh)
    bvh = TriangleBvh.build(mesh, materials=ids, leaf_max=24)
    stats = bvh.statistics()
    print(f"path-traced atrium: {stats['triangles']} triangles, {stats['inner_nodes']} inner nodes, max depth "
          f"{stats['max_depth']}, stack {bvh.recommended_stack_size}, {int((ids == 4).sum())} emissive triangles, "
          f"built in {time.perf_counter() - t0:.1f}s", flush=True)
    return bvh, dicts


def pt_parts(bvh, dicts, device, quantized=False):
    """``(scene, materials, lights, tracer, shadow_tracer)`` on ``device``,
    over the f32 layout (K2) or the quantized one (K3)."""
    from minipath_tpu_torch.render.wavefront import make_pt_shadow_tracer, make_pt_tracer
    from minipath_tpu_torch.scene.materials import build_light_table, material_table

    scene = bvh.quantized_pt_scene(device) if quantized else bvh.pt_scene(device)
    table = material_table(dicts, device)
    lights = build_light_table(bvh.host_arrays.tri_packets, bvh.host_arrays.tri_material, table)
    tracer, _ = make_pt_tracer(scene, stack_size=bvh.recommended_stack_size, packet_size=PT_PACKET)
    shadow, _ = make_pt_shadow_tracer(scene, stack_size=bvh.recommended_stack_size, packet_size=PT_PACKET)
    return scene, table, lights, tracer, shadow


def bounce1_wavefront(parts, device, gen):
    """The bounce-1 wavefront of one 1920x1080 @ 2 spp chunk of the main
    path's frame, made as ``_pt_trace`` makes it: strata camera rays traced
    with K2, scattered off their hits with ``scatter_full``, compacted.
    Returns ``(rays9, live_packets, live_rays)``."""
    from minipath_tpu_torch.render import wavefront as W
    from minipath_tpu_torch.render.frame import gen_frame_rays9

    scene, table, _, tracer, _ = parts
    samples, seed = 2, 12345
    sampler = bench_camera().build_sampler((PT_WIDTH, PT_HEIGHT), device)
    rays9, _ = gen_frame_rays9(sampler, gen, width=PT_WIDTH, height=PT_HEIGHT, px_block=(16, 16), samples=samples,
                               strat_spp=PT_SPP, strat_offset=0, strat_seed=seed)
    B0, _, P0 = rays9.shape
    N = B0 * P0
    flat = rays9.transpose(1, 2).reshape(N, 9)
    o, d = flat[:, 0:3], flat[:, 3:6]
    kh = tracer(scene, o, d, flat[:, 6:9])
    pixel = torch.arange(N, dtype=torch.int32, device=device)
    bp0, within = P0 // samples, pixel % P0
    strat = (within // bp0, ((pixel // P0) * bp0 + within % bp0) ^ seed, PT_SPP, 0)
    new_dir, _, _, terminate, _, _ = W.scatter_full(table, gen, d, kh.normal, kh.material, strat=strat)
    hit = kh.tri >= 0
    nf = torch.where((d * kh.normal).sum(-1, keepdim=True) < 0, kh.normal, -kh.normal)
    offset = torch.where((new_dir * nf).sum(-1, keepdim=True) >= 0, nf, -nf)
    new_o = o + d * kh.t[:, None] + offset * W._EPS
    h = hit[:, None]
    state = W._PathState(
        origin=torch.where(h, new_o, o), direction=torch.where(h, new_dir, d),
        inv_direction=torch.where(h, 1.0 / new_dir, flat[:, 6:9]),
        throughput=torch.ones_like(o), radiance=torch.zeros_like(o), pixel=pixel, active=hit & ~terminate,
    )
    state = W._compact(state, fine_direction=True)
    live = state.active.sum(dtype=torch.int32)
    r9, live_packets, _ = W._pack_rays9(PT_PACKET, live, state.origin, state.direction, state.inv_direction)
    return r9, live_packets, int(live)


def compare_pt(name, got, want, anyhit=False, kernel="K2"):
    """Agreement of a lean kernel's output (K2's or K3's) with its plain
    version's; raises beyond the tolerances. Any-hit: the occlusion masks
    must be equal."""
    n = got.t.numel()
    ovf = (int(got.overflow.sum()), int(want.overflow.sum()))
    counters_ok = all(torch.equal(getattr(got, c), getattr(want, c)) for c in ("inner_visits", "leaf_tests"))
    stats = (f"overflow kernel/plain {ovf}, counters equal {counters_ok}, inner visits/ray "
             f"{got.inner_visits.sum().item() / n:.1f}, leaf tests/ray {got.leaf_tests.sum().item() / n:.1f}")
    if anyhit:
        occ, wocc = got.tri >= 0, want.tri >= 0
        equal = torch.equal(occ, wocc)
        text = (f"{name} {tuple(got.t.shape)} = {n} rays: occluded masks equal {equal} "
                f"({int((occ != wocc).sum())} differ), occluded {occ.float().mean().item():.4f}, {stats}")
        if not equal or ovf != (0, 0) or not counters_ok:
            raise AssertionError(f"{kernel} any-hit disagrees with its plain version: {text}")
        return text, 0.0
    same = got.tri == want.tri
    match = same.float().mean().item()
    hit = same & (want.tri >= 0)
    t_rel = ((got.t - want.t).abs() / want.t.abs().clamp_min(1e-30))[hit].max().item()
    errs = [(getattr(got, f) - getattr(want, f)).abs()[hit].max().item() for f in ("t", "u", "v")]
    text = (f"{name} {tuple(got.t.shape)} = {n} rays: tri match {match:.6f}, hit rate "
            f"{(got.tri >= 0).float().mean().item():.4f}, max t rel err {t_rel:.3g}, max u/v err "
            f"{max(errs[1:]):.3g}, {stats}")
    if match < TRI_MATCH or t_rel > T_RTOL or max(errs[1:]) > UV_ATOL or ovf != (0, 0) or not counters_ok:
        raise AssertionError(f"{kernel} disagrees with its plain version: {text}")
    return text, max(errs)


def phase_k2(bvh, parts, device):
    from minipath_tpu_torch.render import kernels
    from minipath_tpu_torch.render import wavefront as W
    from minipath_tpu_torch.scene.bvh import links as L
    from minipath_tpu_torch.scene.materials import LAMBERTIAN, METAL, material_rows, sample_lights

    scene, table, lights, _, _ = parts
    ss = bvh.recommended_stack_size
    gen = torch.Generator(device=device).manual_seed(1)
    r9, live_packets, live_rays = bounce1_wavefront(parts, device, gen)
    n_live_pk = int(live_packets)
    if n_live_pk < PT_SET_PACKETS:
        raise AssertionError(f"bounce-1 wavefront has only {n_live_pk} live packets")
    # Set 1: 256 live packets spread evenly over the sorted wavefront.
    pick = torch.arange(PT_SET_PACKETS, device=device) * n_live_pk // PT_SET_PACKETS
    bounce = r9[pick].contiguous()
    out = {}

    def check(key, label, args, kw, anyhit=False):
        got = kernels.trace_packets_pt(scene, args, stack_size=ss, anyhit=anyhit, **kw)
        torch.cuda.synchronize()
        want = kernels.trace_packets_pt_reference(scene, args, stack_size=ss, anyhit=anyhit, **kw)
        text, err = compare_pt(label, got, want, anyhit)
        ms = cuda_ms(lambda: kernels.trace_packets_pt(scene, args, stack_size=ss, anyhit=anyhit, **kw), 20)
        plain_ms = cuda_ms(lambda: kernels.trace_packets_pt_reference(scene, args, stack_size=ss, anyhit=anyhit,
                                                                      **kw), 1)
        bound_ms, bound_by, bound = traversal_bound(
            "traverse_pt", scene, args, got, stack_size=ss, anyhit=anyhit,
            **{"t_max": math.inf, "live_packets": None, **kw},
        )
        log("6 k2", f"{text} | kernel {ms:.4f} ms, plain {plain_ms:.2f} ms | {bound} | "
            f"{requested('traverse_pt', got, ms)}")
        out[key] = dict(ms=ms, plain_ms=plain_ms, err=err, bound_ms=bound_ms, bound_by=bound_by)
        return got

    hits = check("bounce1", "bounce-1 closest-hit", bounce, {})

    # Set 2: the NEE shadow segments of those hits, sorted and packed as the
    # bounce loop does ("pos" sort, candidates as a live prefix).
    flat = bounce.transpose(1, 2).reshape(-1, 9)
    o, d = flat[:, 0:3], flat[:, 3:6]
    tri = hits.tri.reshape(-1)
    normal, material, _ = W.shade_from_flat(scene.shade_flat, tri, hits.u.reshape(-1), hits.v.reshape(-1))
    nf = torch.where((d * normal).sum(-1, keepdim=True) < 0, normal, -normal)
    kind, fuzz, _, _ = material_rows(table, material)
    cand = ((kind == LAMBERTIAN) | ((kind == METAL) & (fuzz >= W.GLOSSY_MIN_FUZZ))) & (tri >= 0)
    sh_o = o + d * hits.t.reshape(-1)[:, None] + nf * W._EPS
    y, wi, pdf, _, cos_y, _ = sample_lights(lights, gen, sh_o)
    cand = cand & ((wi * nf).sum(-1) > 0) & (cos_y > 1e-6) & (pdf > 0)
    o_s, s_s, n_cand, _ = W._shadow_batch(cand, sh_o, y - wi * W._EPS - sh_o, wi)
    inv = torch.where(s_s == 0.0, torch.full_like(s_s, torch.inf), 1.0 / s_s)
    shadow9, live_s, _ = W._pack_rays9(PT_PACKET, n_cand, o_s, s_s, inv)
    log("6 k2", f"NEE shadow set: {int(n_cand)} candidate segments of {tri.numel()} hits "
        f"({int(live_s)} live packets)")
    check("shadow", "NEE shadow any-hit", shadow9, dict(t_max=W._SHADOW_T_MAX, live_packets=live_s), anyhit=True)

    # Set 3: 64 packets, each rooted at one of the root's child subtrees.
    child_links = bvh.host_arrays.node_child_links[int(bvh.host_arrays.root) >> L.COUNT_BITS]
    children = [int(c) for c in child_links if c != L.NULL_LINK]
    n_roots = min(64, PT_SET_PACKETS)
    roots = torch.tensor([children[i % len(children)] for i in range(n_roots)], dtype=torch.int32, device=device)
    check("roots", "per-packet roots", bounce[:n_roots].contiguous(), dict(roots=roots))

    ms = cuda_ms(lambda: kernels.trace_packets_pt(scene, r9, stack_size=ss, live_packets=live_packets), 5)
    got = kernels.trace_packets_pt(scene, r9, stack_size=ss, live_packets=live_packets)
    log("6 k2", f"whole bounce-1 wavefront {tuple(r9.shape)}, {live_rays} live rays in {n_live_pk} packets: "
        f"kernel {ms:.3f} ms = {live_rays / ms / 1e3:.1f} Mrays/s, {requested('traverse_pt', got, ms)}")
    # Phase 10 traces the same sets with K3.
    sets = dict(bounce=bounce, shadow=(shadow9, live_s), wavefront=(r9, live_packets, live_rays))
    return out, sets


@functools.lru_cache(maxsize=None)
def frame_inputs(device, width, height):
    """The bench camera's sampler and the sky, made once per size: set-up,
    whose host-to-device copies stay out of a warm frame."""
    from minipath_tpu_torch.scene.materials import Environment

    return bench_camera().build_sampler((width, height), device), Environment.sky(device)


def render_pt(parts, device, width, height, spp, nee_max_depth, samples_per_packet, seed, lit=True, **kw):
    """One path-traced frame of the bench camera; returns ``(host image,
    seconds)``: host clock from the call to the image on the host. Raises
    on a non-finite image, and on a black one where the scene is ``lit``.
    ``kw`` goes to ``render_frame_pt``."""
    from minipath_tpu_torch.render.wavefront import render_frame_pt

    scene, table, lights, tracer, shadow = parts
    sampler, env = frame_inputs(device, width, height)
    gen = torch.Generator(device=device).manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render_frame_pt(
        tracer, scene, table, sampler, gen, width=width, height=height, spp=spp, bounces=PT_BOUNCES,
        env=env, samples_per_packet=samples_per_packet, compaction=True, lights=lights,
        shadow_tracer=shadow, nee_max_depth=nee_max_depth, **kw,
    ).cpu().numpy()
    seconds = time.perf_counter() - t0
    if img.shape != (height, width, 4) or not np.isfinite(img).all():
        raise AssertionError(f"path-traced image {img.shape} is not finite")
    if lit and not img[..., :3].mean() > 0:
        raise AssertionError("path-traced image is black")
    return img, seconds


def phase_pt_main_path(parts, device, smi):
    import warnings

    from minipath_tpu_torch.render import compact, kernels, shade

    paths = PT_WIDTH * PT_HEIGHT * PT_SPP
    _, cold = render_pt(parts, device, PT_WIDTH, PT_HEIGHT, PT_SPP, 1, 2, seed=0)
    for mode in kernels.trace_packets_pt.launches:
        kernels.trace_packets_pt.launches[mode] = 0
    shade.launch.launches = 0
    compact.key_pass.launches = compact.permute_pass.launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            img, warm = render_pt(parts, device, PT_WIDTH, PT_HEIGHT, PT_SPP, 1, 2, seed=1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = dict(kernels.trace_packets_pt.launches)
    shade_launches = shade.launch.launches
    compact_launches = {"key": compact.key_pass.launches, "permute": compact.permute_pass.launches}
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    peak = torch.cuda.max_memory_allocated(device)
    if min(launches.values()) == 0:
        raise AssertionError(f"the path-traced frame did not launch K2 in every mode: {launches}")
    # One bounce-shading launch a bounce of every 2-spp chunk.
    if shade_launches != PT_SPP // 2 * PT_BOUNCES:
        raise AssertionError(f"the path-traced frame launched the shading kernel {shade_launches} times, not "
                             f"{PT_SPP // 2 * PT_BOUNCES}")
    # One key and one permute launch a compaction: bounces 1-4 of every chunk.
    if compact_launches != dict.fromkeys(("key", "permute"), PT_SPP // 2 * (PT_BOUNCES - 1)):
        raise AssertionError(f"the path-traced frame's compaction launches: {compact_launches}")
    log("7 pt main path", f"render_frame_pt {PT_WIDTH}x{PT_HEIGHT} @ {PT_SPP} spp, {PT_BOUNCES} bounces, NEE at "
        f"depth 1, samples_per_packet 2 on {smi}: warm frame {warm:.3f} s = {paths / warm / 1e6:.2f} Mpaths/s "
        f"(cold {cold:.3f} s) | K2 launches {launches}, shading launches {shade_launches}, compaction launches "
        f"{compact_launches} | host syncs in the warm frame {syncs} | peak device memory {peak / 1e9:.2f} GB | image mean {img[..., :3].mean():.5f}, all "
        f"finite")

    w2, h2, spp2 = 960, 540, 8
    _, cold2 = render_pt(parts, device, w2, h2, spp2, None, spp2, seed=2)
    for mode in kernels.trace_packets_pt.launches:
        kernels.trace_packets_pt.launches[mode] = 0
    torch.cuda.reset_peak_memory_stats(device)
    img2, sec2 = render_pt(parts, device, w2, h2, spp2, None, spp2, seed=3)
    log("7 pt main path", f"render_frame_pt {w2}x{h2} @ {spp2} spp, {PT_BOUNCES} bounces, NEE at every vertex: "
        f"warm frame {sec2:.3f} s = {w2 * h2 * spp2 / sec2 / 1e6:.2f} Mpaths/s (cold {cold2:.3f} s) | K2 "
        f"launches {dict(kernels.trace_packets_pt.launches)} | peak device memory "
        f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB | image mean {img2[..., :3].mean():.5f}, "
        f"all finite")
    return sum(launches.values()), shade_launches, compact_launches, img, warm


# Phase 29: one chunk of the pt-1080p64-nee1 frame (8 spp of 1920 x 1088, the
# frame in whole 16 x 16 blocks: 16,711,680 lanes), each bounce shaded by the
# kernel and by its plain version.
SHADE_CHUNK = 8


def shade_lanes(state, kh, table, kw, nee_lanes):
    """The lanes of one bounce by the branch the shading takes, as a dict of
    counts; ``kw`` is the bounce's keyword arguments, ``nee_lanes`` the lanes
    that stayed NEE candidates after the shadow roulette."""
    from minipath_tpu_torch.render.wavefront import GLOSSY_MIN_FUZZ
    from minipath_tpu_torch.scene.materials import DIELECTRIC, EMISSIVE, LAMBERTIAN, METAL

    n = state.origin.shape[0]
    live = n if kw["live"] is None else int(kw["live"])
    active = state.active & (torch.arange(n, device=state.origin.device) < live)
    hit = active & (kh.tri >= 0)
    mat = kh.material.long().clamp(min=0)
    kind, param = table.kind.long()[mat], table.param[mat]
    metal, glass = hit & (kind == METAL), hit & (kind == DIELECTRIC)
    # The dielectric lanes that cannot refract (total internal reflection).
    d_dot_n = (state.direction * kh.normal).sum(-1)
    ior = param.clamp(min=1.0001)
    eta = torch.where(d_dot_n < 0, 1.0 / ior, ior)
    sin_t = (1.0 - d_dot_n.abs().clamp(max=1.0) ** 2).clamp(min=0.0).sqrt()
    emitter = hit & (kind == EMISSIVE)
    counts = dict(
        lanes=n, past_live=n - live, inactive=int((~state.active[:live]).sum()),
        miss=int((active & (kh.tri < 0)).sum()),
        lambertian=int((hit & (kind == LAMBERTIAN)).sum()), glossy=int((metal & (param >= GLOSSY_MIN_FUZZ)).sum()),
        mirror=int((metal & (param < GLOSSY_MIN_FUZZ)).sum()), dielectric=int(glass.sum()),
        cannot_refract=int((glass & (eta * sin_t > 1.0)).sum()), emitter=int(emitter.sum()),
        emitter_mis=int((emitter & (state.prev_pdf > 0)).sum()) if state.prev_pdf is not None else 0,
        nee_candidates=int(nee_lanes.sum()) if nee_lanes is not None else 0,
    )
    return counts


def shade_bytes(c, kw, nee):
    """The least bytes one bounce's shading moves through HBM, from the lane
    counts ``c`` of :func:`shade_lanes`: what each lane's work must read and
    write, with the material and light rows (kilobytes, resident in L2) left
    out, and no sector's unused bytes counted.

    Every lane reads its state (origin, direction, inverse, throughput,
    radiance: 60 B) and writes its next state (61 B, 65 with the MIS pdf; 53
    B more of NEE segment on a NEE bounce: mask, origin, segment, direction,
    light, contribution). A lane inside the live count reads its flag (1 B);
    an active lane its triangle (4 B); a hit its distance, normal and
    material (20 B), its pixel slot with strata (4 B) and its MIS pdf with
    NEE (4 B). The uniforms, where drawn (not in Sobol mode): a Lambertian or
    glossy lane 8 B, a dielectric 4 B, a mirror or an emitter none; on a NEE
    bounce a Lambertian or glossy lane 12 B for the light sample, a surviving
    candidate 4 B for the shadow roulette; on a roulette bounce every hit but
    an emitter's 4 B."""
    strata, n = kw["strata"], c["lanes"]
    live = n - c["past_live"]
    active = live - c["inactive"]
    hits = c["lambertian"] + c["glossy"] + c["mirror"] + c["dielectric"] + c["emitter"]
    nbytes = n * (60 + 61 + 4 * nee + 53 * kw["nee_here"]) + live + 4 * active
    nbytes += hits * (20 + 4 * (strata is not None) + 4 * nee)
    if strata is None or strata.spp > 0:
        nbytes += 8 * (c["lambertian"] + c["glossy"]) + 4 * c["dielectric"]
        if kw["nee_here"]:
            nbytes += 12 * (c["lambertian"] + c["glossy"])
    if kw["nee_here"] and kw["shadow_rr"]:
        nbytes += 4 * c["nee_candidates"]
    if kw["bounce"] >= kw["rr_start"]:
        nbytes += 4 * (hits - c["emitter"])
    return nbytes


def exact_differences(got, want, mask=None):
    """The lanes (of ``mask``, or all) where ``got`` and ``want`` differ in
    any element; NaN equals NaN."""
    same = (got == want) | (torch.isnan(got) & torch.isnan(want)) if got.is_floating_point() else got == want
    if same.dim() > 1:
        same = same.all(dim=-1)
    if mask is not None:
        same = same | ~mask
    return int((~same).sum())


def generator_at(state):
    """A generator on the card, set to ``state``."""
    g = torch.Generator(device="cuda")
    g.set_state(state)
    return g


def shade_both(state, kh, table, env, lights, g_state, kw):
    """One bounce shaded by ``_shade_kernel`` and by ``_shade_plain``, each
    from the generator state ``g_state``. Returns the lanes that differ, by
    output (the state, the NEE segment on its candidates, the generator
    after), the plain version's NEE query, the kernel launch's fields and
    the two generators."""
    from minipath_tpu_torch.render import shade
    from minipath_tpu_torch.render import wavefront as W

    launch, fields = shade.launch, {}

    def recording(dev, **f):
        fields.update(f)
        return launch(dev, **f)

    g_kernel, g_plain = generator_at(g_state), generator_at(g_state)
    W.launch_shade = recording
    try:
        got, got_q = W._shade_kernel(state, kh, table, env, lights, g_kernel, **kw)
    finally:
        W.launch_shade = launch
    want, want_q = W._shade_plain(state, kh, table, env, lights, g_plain, **kw)
    diffs = {name: exact_differences(getattr(got, name), getattr(want, name))
             for name in ("origin", "direction", "inv_direction", "throughput", "radiance", "active", "prev_pdf")
             if getattr(want, name) is not None}
    if (got_q is None) != (want_q is None):
        raise AssertionError(f"bounce {kw['bounce']}: NEE query kernel {got_q is not None}, plain "
                             f"{want_q is not None}")
    if want_q is not None:
        diffs["cand"] = exact_differences(got_q.cand, want_q.cand)
        for name in ("origin", "segment", "wi", "light", "contrib"):
            diffs[f"nee.{name}"] = exact_differences(getattr(got_q, name), getattr(want_q, name), want_q.cand)
    diffs["generator"] = int(not torch.equal(g_kernel.get_state(), g_plain.get_state()))
    return diffs, want_q, fields, g_kernel, g_plain


def compact_differences(got, want):
    """The lanes where two compacted states differ, by field (the MIS pdf
    included), and whether one of them lacks the MIS pdf."""
    from minipath_tpu_torch.render.wavefront import _PathState

    diffs = {name: exact_differences(getattr(got, name), getattr(want, name))
             for name in _PathState._fields if getattr(want, name) is not None}
    diffs["prev_pdf is None"] = int((got.prev_pdf is None) != (want.prev_pdf is None))
    return diffs


def phase_shade(parts, device, smi):
    """Phase 29: the bounce-shading kernel (``csrc/shade.cu``) against its
    plain version on the main path's state at full width. One
    pt-1080p64-nee1 frame (1920x1080 @ 64 spp in 8-spp chunks, 5 bounces,
    NEE at the first vertex, compaction, both roulettes) keeps its first
    chunk's five bounces: their states, hits, keyword arguments and
    generator states. Each bounce is then shaded by ``_shade_kernel`` and
    ``_shade_plain`` from one generator state, and every output must agree
    exactly on every lane (the state, the NEE segment on its candidates, the
    generator's state after). Prints each bounce's lanes by branch, the
    kernel's time alone and with its draws, the plain version's, and its
    bound by bytes (:func:`shade_bytes`). Returns the kernels line's
    results, by bounce."""
    from minipath_tpu_torch.render import shade
    from minipath_tpu_torch.render import wavefront as W
    from minipath_tpu_torch.utils.roofline import PEAK_HBM_BYTES

    _, table, _, _, _ = parts
    env = frame_inputs(device, PT_WIDTH, PT_HEIGHT)[1]
    captured = []
    originals = {name: getattr(W, name) for name in ("_shade_kernel", "_shade_plain")}

    def capturing(fn):
        def wrapped(state, kh, materials, env_, lights, generator, **kw):
            if len(captured) < PT_BOUNCES:
                captured.append((state, kh, lights, generator.get_state(), kw))
            return fn(state, kh, materials, env_, lights, generator, **kw)

        return wrapped

    for name, fn in originals.items():
        setattr(W, name, capturing(fn))
    try:
        render_pt(parts, device, PT_WIDTH, PT_HEIGHT, PT_SPP, 1, SHADE_CHUNK, seed=29)
    finally:
        for name, fn in originals.items():
            setattr(W, name, fn)
    if [kw["bounce"] for *_, kw in captured] != list(range(PT_BOUNCES)):
        raise AssertionError(f"captured bounces {[kw['bounce'] for *_, kw in captured]}")

    launch = shade.launch
    out, chunk = {}, dict(ms=0.0, draws_ms=0.0, plain_ms=0.0, bound_ms=0.0, nbytes=0)
    for state, kh, lights, g_state, kw in captured:
        b = kw["bounce"]
        diffs, want_q, fields, g_kernel, g_plain = shade_both(state, kh, table, env, lights, g_state, kw)
        counts = shade_lanes(state, kh, table, kw, None if want_q is None else want_q.cand)
        nbytes = shade_bytes(counts, kw, state.prev_pdf is not None)
        bound_ms = nbytes / PEAK_HBM_BYTES * 1e3
        ms = cuda_ms(lambda: launch(device, **fields), 10)
        draws_ms = cuda_ms(lambda: W._shade_kernel(state, kh, table, env, lights, g_kernel, **kw), 5)
        plain_ms = cuda_ms(lambda: W._shade_plain(state, kh, table, env, lights, g_plain, **kw), 1)
        text = (f"bounce {b} ({'NEE, ' if kw['nee_here'] else ''}{'roulette, ' if b >= kw['rr_start'] else ''}"
                f"{'compacted' if b else 'camera rays'}): {json.dumps(counts)} | lanes that differ {json.dumps(diffs)}"
                f" | kernel {ms:.4f} ms, with its draws {draws_ms:.4f} ms, plain {plain_ms:.2f} ms | bound "
                f"{bound_ms:.4f} ms by bytes ({nbytes / 1e9:.4f} GB): the kernel at {100 * bound_ms / ms:.1f}%")
        if any(diffs.values()):
            raise AssertionError(f"the shading kernel disagrees with its plain version on {smi}: {text}")
        log("29 shade", text)
        out[f"bounce {b}"] = dict(ms=ms, plain_ms=plain_ms, err=0.0, bound_ms=bound_ms, bound_by="bytes",
                                  draws_ms=draws_ms, gb=nbytes / 1e9, lanes=counts)
        for key, value in (("ms", ms), ("draws_ms", draws_ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                           ("nbytes", nbytes)):
            chunk[key] += value
        del want_q, fields
    del captured
    # Every branch the main path's scene offers (the hall is closed: no
    # misses; its metal is glossy: no mirrors).
    missing = [k for k in ("lambertian", "glossy", "dielectric", "cannot_refract", "emitter", "emitter_mis",
                           "nee_candidates") if not any(r["lanes"][k] for r in out.values())]
    if missing:
        raise AssertionError(f"branches the main path's chunk never took: {missing}")
    chunks = PT_SPP // SHADE_CHUNK
    log("29 shade", f"a frame of {chunks} such chunks: kernel {chunks * chunk['ms']:.2f} ms (with its draws "
        f"{chunks * chunk['draws_ms']:.2f}), plain {chunks * chunk['plain_ms']:.1f} ms; bound "
        f"{chunks * chunk['bound_ms']:.2f} ms by bytes ({chunks * chunk['nbytes'] / 1e9:.2f} GB): the kernel at "
        f"{100 * chunk['bound_ms'] / chunk['ms']:.1f}% | {smi}")
    out["frame"] = dict(ms=chunks * chunk["ms"], draws_ms=chunks * chunk["draws_ms"],
                        plain_ms=chunks * chunk["plain_ms"], bound_ms=chunks * chunk["bound_ms"], err=0.0,
                        bound_by="bytes", gb=chunks * chunk["nbytes"] / 1e9)
    return out


# Phase 32: the compaction at bounces 1-4 of the first chunk of the
# pt-1080p64-nee1 frame. The least bytes of each stage's work, a lane (the
# key pass's staged records are the design's, and not counted): the bounding
# box reads its origin (12 B); the key reads origin, direction and flag and
# writes the key (25 + 4 B); the permute pass reads the index (8 B), gathers
# origin, direction, throughput, radiance, pixel slot and MIS pdf (56 B, 52 B
# without NEE) and writes them with the inverse direction and the live flag
# (69 B, 65 B without NEE). torch.sort's are the bytes of the passes it makes
# over an int32 key with int64 indices: it writes the indices it starts from
# (8 B), reads the keys for its histograms (4 B) and reads and writes key and
# index in each of four 8-bit passes (4 x 24 B), though the key has 20 bits.
COMPACT_STAGE_BYTES = {"bounding box": 12, "key": 29, "sort": 8 + 4 + 4 * 24, "permute": 8 + 52 + 65}
COMPACT_NEE_BYTES = 4 + 4  # the MIS pdf gathered and written
# The hand-written passes; the bounding box (amin, amax) and the sort are
# PyTorch's.
COMPACT_KERNEL_STAGES = ("key", "permute")


def compact_bytes(lanes, nee):
    """The least bytes of each stage of one compaction of ``lanes`` lanes
    (:data:`COMPACT_STAGE_BYTES`), by stage."""
    out = {stage: lanes * b for stage, b in COMPACT_STAGE_BYTES.items()}
    out["permute"] += lanes * COMPACT_NEE_BYTES * nee
    return out


def phase_compact(parts, device, smi):
    """Phase 32: the compaction kernels (``csrc/compact.cu``) against the
    plain compaction on the main path's state at full width. One
    pt-1080p64-nee1 frame keeps the states that enter its first chunk's
    compactions at bounces 1-4; each is compacted by ``_compact_kernel`` and
    ``_compact_plain``, and every field of the two results must agree on
    every lane. Prints ptxas' report; for each bounce the time of the two
    hand-written passes and their bound by bytes (the kernels line's row),
    the whole kernel path's time (with the bounding box and ``torch.sort``)
    and its bound, the plain path's time, each stage's time and bound, and
    each path's peak memory above its input; then the sum of the four
    bounces times the frame's chunks. Returns the kernels line's results, by
    bounce and for the frame."""
    from minipath_tpu_torch.render import compact
    from minipath_tpu_torch.render import wavefront as W
    from minipath_tpu_torch.utils.roofline import PEAK_HBM_BYTES

    usage = ptxas_usage(compact.load_library().log)
    log("32 compact", f"compact.cu: {json.dumps(usage)}")
    captured, real = [], W._compact

    def capturing(state, fine_direction=True):
        if len(captured) < PT_BOUNCES - 1:
            captured.append((state, fine_direction))
        return real(state, fine_direction=fine_direction)

    W._compact = capturing
    try:
        render_pt(parts, device, PT_WIDTH, PT_HEIGHT, PT_SPP, 1, SHADE_CHUNK, seed=32)
    finally:
        W._compact = real
    if [fine for _, fine in captured] != [True] + [False] * (PT_BOUNCES - 2):
        raise AssertionError(f"captured compactions {[fine for _, fine in captured]}")

    def peak_above_input(make):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        out = make()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated(device) - base

    passes = {"key": W.key_pass, "permute": W.permute_pass}
    sums = ("ms", "path_ms", "plain_ms", "bound_ms", "path_bound_ms", "nbytes", "path_nbytes")
    out, chunk, chunk_stages = {}, dict.fromkeys(sums, 0.0), dict.fromkeys(COMPACT_STAGE_BYTES, 0.0)
    for bounce, (state, fine) in enumerate(captured, start=1):
        fields = {}

        def recording(stage):
            def launch(dev, **f):
                fields[stage] = f
                return passes[stage](dev, **f)
            return launch

        W.key_pass, W.permute_pass = recording("key"), recording("permute")
        try:
            got, kernel_peak = peak_above_input(lambda: W._compact_kernel(state, fine))
        finally:
            W.key_pass, W.permute_pass = passes["key"], passes["permute"]
        want, plain_peak = peak_above_input(lambda: W._compact_plain(state, fine))
        diffs = compact_differences(got, want)
        lanes, nee = state.origin.shape[0], state.prev_pdf is not None
        live = int(state.active.sum())
        del got, want
        path_ms = cuda_ms(lambda: W._compact_kernel(state, fine), 10)
        plain_ms = cuda_ms(lambda: W._compact_plain(state, fine), 3)
        key = fields["key"]["key"]
        # Relaunched alone, the key pass adds to its live count again; the
        # result was compared above, and the time does not depend on it.
        stage_ms = {
            "bounding box": cuda_ms(lambda: (state.origin.amin(dim=0), state.origin.amax(dim=0)), 10),
            "key": cuda_ms(lambda: passes["key"](device, **fields["key"]), 10),
            "sort": cuda_ms(lambda: torch.sort(key), 10),
            "permute": cuda_ms(lambda: passes["permute"](device, **fields["permute"]), 10),
        }
        nbytes = compact_bytes(lanes, nee)
        bound = {stage: b / PEAK_HBM_BYTES * 1e3 for stage, b in nbytes.items()}
        ms = sum(stage_ms[stage] for stage in COMPACT_KERNEL_STAGES)
        kernel_nbytes = sum(nbytes[stage] for stage in COMPACT_KERNEL_STAGES)
        bound_ms = sum(bound[stage] for stage in COMPACT_KERNEL_STAGES)
        path_bound_ms = sum(bound.values())
        stages = " | ".join(f"{stage} {t:.4f} ms (bound {bound[stage]:.4f} ms, {nbytes[stage] / lanes:.0f} B a "
                            f"lane: {100 * bound[stage] / t:.1f}%)" for stage, t in stage_ms.items())
        text = (f"bounce {bounce} ({'96 direction bins' if fine else 'octants'}, {'NEE' if nee else 'no NEE'}): "
                f"{lanes} lanes, {live} live | lanes that differ {json.dumps(diffs)} | the key and permute "
                f"kernels {ms:.4f} ms, bound {bound_ms:.4f} ms by bytes: {100 * bound_ms / ms:.1f}% | the "
                f"kernels' path {path_ms:.4f} ms, bound {path_bound_ms:.4f} ms ({sum(nbytes.values()) / 1e9:.3f} "
                f"GB): {100 * path_bound_ms / path_ms:.1f}%; the sort {100 * stage_ms['sort'] / path_ms:.1f}% of "
                f"it | plain {plain_ms:.3f} ms | {stages} | peak memory above the input: kernels' path "
                f"{kernel_peak / 1e9:.3f} GB, plain {plain_peak / 1e9:.3f} GB")
        if any(diffs.values()):
            raise AssertionError(f"the compaction kernels disagree with the plain compaction on {smi}: {text}")
        log("32 compact", text)
        out[f"bounce {bounce}"] = dict(ms=ms, plain_ms=plain_ms, err=0.0, bound_ms=bound_ms, bound_by="bytes",
                                       gb=kernel_nbytes / 1e9, path_ms=path_ms, path_bound_ms=path_bound_ms,
                                       path_gb=sum(nbytes.values()) / 1e9, stage_ms=stage_ms, stage_bound_ms=bound,
                                       kernel_peak_gb=kernel_peak / 1e9, plain_peak_gb=plain_peak / 1e9)
        for k, v in (("ms", ms), ("path_ms", path_ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                     ("path_bound_ms", path_bound_ms), ("nbytes", kernel_nbytes),
                     ("path_nbytes", sum(nbytes.values()))):
            chunk[k] += v
        for stage, t in stage_ms.items():
            chunk_stages[stage] += t
        del fields
    del captured
    chunks = PT_SPP // SHADE_CHUNK
    frame = {k: chunks * v for k, v in chunk.items()}
    log("32 compact", f"a frame of {chunks} chunks (bounces 1-4 of each: {chunks * (PT_BOUNCES - 1)} "
        f"compactions): the key and permute kernels {frame['ms']:.2f} ms, bound {frame['bound_ms']:.2f} ms by "
        f"bytes ({frame['nbytes'] / 1e9:.2f} GB): {100 * frame['bound_ms'] / frame['ms']:.1f}% | the kernels' "
        f"path {frame['path_ms']:.2f} ms, bound {frame['path_bound_ms']:.2f} ms ({frame['path_nbytes'] / 1e9:.2f} "
        f"GB): {100 * frame['path_bound_ms'] / frame['path_ms']:.1f}% | plain {frame['plain_ms']:.1f} ms | by "
        f"stage {json.dumps({k: round(chunks * v, 3) for k, v in chunk_stages.items()})} ms | {smi}")
    out["frame"] = dict(ms=frame["ms"], plain_ms=frame["plain_ms"], bound_ms=frame["bound_ms"], err=0.0,
                        bound_by="bytes", gb=frame["nbytes"] / 1e9, path_ms=frame["path_ms"],
                        path_bound_ms=frame["path_bound_ms"], path_gb=frame["path_nbytes"] / 1e9,
                        stage_ms={k: chunks * v for k, v in chunk_stages.items()})
    return out


# Phase 33: the pt-tworooms-1080p64 cell's frame (benchmark/configs/
# tworooms150k-pt.json): the two rooms as the CLI builds them, its camera, 7
# bounces, NEE at every vertex, no environment.
TWOROOMS_TRIANGLES, TWOROOMS_BOUNCES = 150_000, 7


def tworooms_camera():
    from minipath_tpu_torch import Camera

    # In the dark room, facing the doorway (the cell's, sweep_pt19's).
    return Camera().look_at((-10.0, 3.0, 0.0), (0.0, 1.5, 0.0)).f_number(8.0).sensor_width(36e-3)


def tworooms_cell(device, phase):
    """The pt-tworooms-1080p64 cell's program state: the two rooms built
    natively as ``--scene tworooms`` builds them, ``pt_parts`` over them, no
    environment, and ``frame(spp, seed)``, the cell's frame of that many
    samples in 8-spp chunks. Returns ``(parts, env, frame)``."""
    from minipath_tpu_torch.render import wavefront as W
    from minipath_tpu_torch.scene.materials import Environment
    from minipath_tpu_torch.scene.procedural import make_tworooms, tworooms_materials
    from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh

    t0 = time.perf_counter()
    mesh = make_tworooms(TWOROOMS_TRIANGLES)
    ids, dicts = tworooms_materials(mesh)
    bvh = TriangleBvh.build(mesh, materials=ids, use_native=True)
    log(phase, f"{bvh.statistics()['triangles']} triangles, {int((ids == 3).sum())} emissive, stack "
        f"{bvh.recommended_stack_size}, built natively in {time.perf_counter() - t0:.1f}s")
    parts = pt_parts(bvh, dicts, device)
    scene, table, lights, tracer, shadow = parts
    sampler = tworooms_camera().build_sampler((PT_WIDTH, PT_HEIGHT), device)
    env = Environment.none(device)

    def frame(spp, seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        return W.render_frame_pt(
            tracer, scene, table, sampler, gen, width=PT_WIDTH, height=PT_HEIGHT, spp=spp,
            bounces=TWOROOMS_BOUNCES, env=env, samples_per_packet=SHADE_CHUNK, lights=lights, shadow_tracer=shadow,
            nee_max_depth=None,
        )

    return parts, env, frame


def phase_tworooms(device, smi):
    """Phase 33: the pt-tworooms-1080p64 cell's path on the cell's own tree
    (``make_tworooms(150_000)`` with ``tworooms_materials``, built natively
    at leaves of up to 56 triangles, as ``--scene tworooms --integrator pt``
    builds it). The first 8-spp chunk of the cell's frame (16,711,680 lanes)
    keeps its bounces' shading inputs and the states entering its
    compactions; at bounces 1-6 (compacted, NEE on each, roulette from 3)
    ``_shade_kernel`` must agree with ``_shade_plain`` on every lane and
    ``_compact_kernel`` with ``_compact_plain`` on every field, the MIS pdf
    included. Then one whole 64-spp frame with the launches counted from
    zero: K2 closest-hit and any-hit, the shading kernel and the shadow
    batch's four passes 8 x 7 each, the compaction's key and permute passes
    8 x 6 each. Returns the frame's launches by kernel."""
    from minipath_tpu_torch.render import compact, kernels, shade
    from minipath_tpu_torch.render import shadow as shadow_passes
    from minipath_tpu_torch.render import wavefront as W

    (_, table, _, _, _), env, frame = tworooms_cell(device, "33 tworooms")

    shaded, compacted = [], []
    real_shade, real_compact = W._shade_kernel, W._compact

    def capturing_shade(state, kh, materials, env_, lights_, generator, **kw):
        shaded.append((state, kh, lights_, generator.get_state(), kw))
        return real_shade(state, kh, materials, env_, lights_, generator, **kw)

    def capturing_compact(state, fine_direction=True):
        compacted.append((state, fine_direction))
        return real_compact(state, fine_direction=fine_direction)

    W._shade_kernel, W._compact = capturing_shade, capturing_compact
    try:
        frame(SHADE_CHUNK, 33)
    finally:
        W._shade_kernel, W._compact = real_shade, real_compact
    if [kw["bounce"] for *_, kw in shaded] != list(range(TWOROOMS_BOUNCES)) or len(compacted) != TWOROOMS_BOUNCES - 1:
        raise AssertionError(f"captured {len(shaded)} shadings and {len(compacted)} compactions")
    taken = dict.fromkeys(("lambertian", "glossy", "emitter", "emitter_mis", "nee_candidates"), 0)
    for state, kh, lights_, g_state, kw in shaded[1:]:
        b = kw["bounce"]
        if not kw["nee_here"] or kw["live"] is None:
            raise AssertionError(f"bounce {b}: NEE {kw['nee_here']}, live count {kw['live']}")
        diffs, want_q, _, _, _ = shade_both(state, kh, table, env, lights_, g_state, kw)
        counts = shade_lanes(state, kh, table, kw, want_q.cand)
        text = f"bounce {b} shading: {json.dumps(counts)} | lanes that differ {json.dumps(diffs)}"
        if any(diffs.values()):
            raise AssertionError(f"the shading kernel disagrees with its plain version on {smi}: {text}")
        log("33 tworooms", text)
        for k in taken:
            taken[k] += counts[k]
        del want_q
    missing = [k for k, n in taken.items() if not n]
    if missing:
        raise AssertionError(f"branches bounces 1-6 of the chunk never took: {missing}")
    for bounce, (state, fine) in enumerate(compacted, start=1):
        diffs = compact_differences(W._compact_kernel(state, fine), W._compact_plain(state, fine))
        text = (f"bounce {bounce} compaction: {state.origin.shape[0]} lanes, {int(state.active.sum())} live | "
                f"fields that differ {json.dumps(diffs)}")
        if state.prev_pdf is None or any(diffs.values()):
            raise AssertionError(f"the compaction kernels disagree with the plain compaction on {smi}: {text}")
        log("33 tworooms", text)
    del shaded, compacted

    for mode in kernels.trace_packets_pt.launches:
        kernels.trace_packets_pt.launches[mode] = 0
    shade.launch.launches = 0
    compact.key_pass.launches = compact.permute_pass.launches = 0
    for name in SHADOW_PASSES:
        getattr(shadow_passes, f"{name}_pass").launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    img, seconds = timed(lambda: frame(PT_SPP, 34).cpu().numpy())
    chunks = PT_SPP // SHADE_CHUNK
    launches = {"K2 closest": kernels.trace_packets_pt.launches["closest"],
                "K2 anyhit": kernels.trace_packets_pt.launches["anyhit"], "shade": shade.launch.launches,
                "compact key": compact.key_pass.launches, "compact permute": compact.permute_pass.launches,
                **{f"shadow {name}": getattr(shadow_passes, f"{name}_pass").launches for name in SHADOW_PASSES}}
    want = {"K2 closest": chunks * TWOROOMS_BOUNCES, "K2 anyhit": chunks * TWOROOMS_BOUNCES,
            "shade": chunks * TWOROOMS_BOUNCES, "compact key": chunks * (TWOROOMS_BOUNCES - 1),
            "compact permute": chunks * (TWOROOMS_BOUNCES - 1),
            **{f"shadow {name}": chunks * TWOROOMS_BOUNCES for name in SHADOW_PASSES}}
    if launches != want or not np.isfinite(img).all() or not img[..., :3].mean() > 0:
        raise AssertionError(f"the cell's frame: launches {launches}, not {want}; image mean {img[..., :3].mean()}")
    log("33 tworooms", f"a {PT_WIDTH}x{PT_HEIGHT} @ {PT_SPP} spp frame, {TWOROOMS_BOUNCES} bounces, NEE at every "
        f"vertex, no environment: launches {json.dumps(launches)} | {seconds:.3f} s (warm, untimed by the cell's "
        f"rules) | peak device memory {torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB | image mean "
        f"{img[..., :3].mean():.5f}, all finite | {smi}")
    return launches


# Phase 34: the NEE shadow batch's kernels (csrc/shadow.cu) against the plain
# shadow batch on the cells' chunks. The least bytes of each stage's work:
# every lane's box (its flag, 1 B), key (flag and wi read, the key written:
# 17 B) and sort (COMPACT_STAGE_BYTES' count, 108 B); a candidate's origin
# read by the box and by the key (12 B each; a non-candidate's point is 0),
# its pack (its index read, its origin and segment gathered, its 36-B row
# written: 68 B) and resolve (its index and answer: 12 B); a lit candidate's
# contribution and radiance read and its radiance written (36 B).
SHADOW_PASSES = ("box", "key", "pack", "resolve")
SHADOW_LANE_BYTES = {"box": 1, "key": 1 + 12 + 4, "sort": COMPACT_STAGE_BYTES["sort"]}
SHADOW_CAND_BYTES = {"box": 12, "key": 12, "pack": 8 + 24 + 36, "resolve": 8 + 4}
SHADOW_LIT_BYTES = 12 + 12 + 12


def shadow_bytes(lanes, cands, lit):
    """The least bytes of each stage of one shadow batch, by stage."""
    out = dict.fromkeys(("box", "key", "sort", "pack", "resolve"), 0)
    for stage, b in SHADOW_LANE_BYTES.items():
        out[stage] += lanes * b
    for stage, b in SHADOW_CAND_BYTES.items():
        out[stage] += cands * b
    out["resolve"] += lit * SHADOW_LIT_BYTES
    return out


def capture_shadow_batches(frame):
    """``(tracer_state, query, radiance, shadow_tracer)`` of every NEE
    shadow batch ``frame()`` makes, the radiance as the batch met it."""
    from minipath_tpu_torch.render import wavefront as W

    seen, real = [], W._shadow_light

    def capturing(tracer_state, query, radiance, shadow_tracer, shadow_sort):
        seen.append((tracer_state, query, radiance.clone(), shadow_tracer))
        return real(tracer_state, query, radiance, shadow_tracer, shadow_sort)

    W._shadow_light = capturing
    try:
        frame()
    finally:
        W._shadow_light = real
    return seen


def shadow_both(name, batch, device, smi):
    """One shadow batch through both routes: every lane of the key, the live
    packets' rows and the radiance compared, the counts too; then each
    route's time, K2 any-hit's on the same rows, each pass's and the sort's,
    against the bound by bytes. Returns the kernels line's result."""
    from minipath_tpu_torch.render import shadow as shadow_passes
    from minipath_tpu_torch.render import wavefront as W
    from minipath_tpu_torch.utils.roofline import PEAK_HBM_BYTES

    state, query, radiance, shadow = batch
    passes = {p: getattr(shadow_passes, f"{p}_pass") for p in SHADOW_PASSES}
    fields = {}

    def recording(p):
        def launch(dev, **f):
            fields[p] = f
            return passes[p](dev, **f)
        return launch

    for p in SHADOW_PASSES:
        setattr(shadow_passes, f"{p}_pass", recording(p))
    try:
        got = W._shadow_light_kernel(state, query, radiance.clone(), shadow)
    finally:
        for p in SHADOW_PASSES:
            setattr(shadow_passes, f"{p}_pass", passes[p])
    cand, P = query.cand, shadow.packet_size
    o_s, s_s, n_cand, order = W._shadow_batch(cand, query.origin, query.segment, query.wi, query.light, "pos")
    rays, live, _ = W._pack_rays9(P, n_cand, o_s, s_s,
                                  torch.where(s_s == 0.0, torch.full_like(s_s, torch.inf), 1.0 / s_s))
    occluded = torch.empty_like(cand)
    occluded[order] = shadow(state, o_s, s_s, n_cand)
    want = W._shadow_light_plain(state, query, radiance.clone(), shadow, "pos")
    counts, live = fields["box"]["counts"], int(live)
    lanes, cands, blocked = cand.shape[0], int(n_cand), int((cand & occluded).sum())

    def rows(r9):
        return r9[:live].transpose(1, 2).reshape(-1, 9)

    diffs = {
        "key": exact_differences(fields["key"]["key"], W.shadow_sort_key(cand, query.origin, query.wi, query.light)),
        "rows": exact_differences(rows(fields["pack"]["rays"]), rows(rays)),
        "radiance": exact_differences(got, want),
        "counts": int([int(c) for c in counts[:3]] != [cands, live, blocked]),
    }
    del got, want, o_s, s_s, order, rays, occluded
    scratch = radiance.clone()
    route_ms = cuda_ms(lambda: W._shadow_light_kernel(state, query, scratch, shadow), 10)
    plain_ms = cuda_ms(lambda: W._shadow_light_plain(state, query, radiance, shadow, "pos"), 3)
    k2_ms = cuda_ms(lambda: shadow.packed(state, fields["pack"]["rays"], counts[1:2]), 10)
    box_counts = counts.clone()

    def box():
        # A fresh count of finished blocks, or no block would finish last.
        box_counts[3].zero_()
        passes["box"](device, **{**fields["box"], "counts": box_counts})

    stage_ms = {
        "box": cuda_ms(box, 10),
        "key": cuda_ms(lambda: passes["key"](device, **fields["key"]), 10),
        "sort": cuda_ms(lambda: torch.sort(fields["key"]["key"]), 10),
        "pack": cuda_ms(lambda: passes["pack"](device, **fields["pack"]), 10),
        "resolve": cuda_ms(lambda: passes["resolve"](device, **{**fields["resolve"], "radiance": scratch}), 10),
    }
    nbytes = shadow_bytes(lanes, cands, cands - blocked)
    bound = {stage: b / PEAK_HBM_BYTES * 1e3 for stage, b in nbytes.items()}
    ms = sum(stage_ms[p] for p in SHADOW_PASSES)
    bound_ms = sum(bound[p] for p in SHADOW_PASSES)
    batch_ms, plain_batch_ms = route_ms - k2_ms, plain_ms - k2_ms
    path_bound_ms = sum(bound.values())
    stages = " | ".join(f"{stage} {t:.4f} ms (bound {bound[stage]:.4f}: {100 * bound[stage] / t:.1f}%)"
                        for stage, t in stage_ms.items())
    text = (f"{name}: {lanes} lanes, {cands} candidates ({100 * cands / lanes:.2f}%), {cands - blocked} lit, "
            f"{live} live packets | lanes that differ {json.dumps(diffs)} | the kernel route {route_ms:.4f} ms, "
            f"the plain route {plain_ms:.4f} ms, K2 any-hit {k2_ms:.4f} ms of each | the batch without K2: kernels "
            f"{batch_ms:.4f} ms (the sort {100 * stage_ms['sort'] / batch_ms:.1f}% of it), bound {path_bound_ms:.4f} "
            f"ms by bytes ({sum(nbytes.values()) / 1e9:.3f} GB): {100 * path_bound_ms / batch_ms:.1f}%; plain "
            f"{plain_batch_ms:.3f} ms | the four passes {ms:.4f} ms, bound {bound_ms:.4f} ms: "
            f"{100 * bound_ms / ms:.1f}% | {stages}")
    if any(diffs.values()):
        raise AssertionError(f"the shadow batch's kernels disagree with the plain shadow batch on {smi}: {text}")
    log("34 shadow", text)
    return dict(ms=ms, plain_ms=plain_batch_ms, err=0.0, bound_ms=bound_ms, bound_by="bytes", path_ms=batch_ms,
                path_bound_ms=path_bound_ms, route_ms=route_ms, plain_route_ms=plain_ms, k2_ms=k2_ms,
                stage_ms=stage_ms, stage_bound_ms=bound, candidates_pct=100 * cands / lanes)


def phase_shadow(parts, device, smi):
    """Phase 34: the NEE shadow batch's kernels (``csrc/shadow.cu``) against
    the plain shadow batch at full width: the batches of bounces 0-6 of the
    first 8-spp chunk of a pt-tworooms-1080p64 frame (NEE at every vertex,
    on the cell's own tree) and of bounce 0 of a pt-1080p64-nee1 chunk
    (16,711,680 lanes each), each through ``_shadow_light_kernel`` and
    ``_shadow_light_plain``: the key, the live packets' rows, the radiance and
    the counts equal on every lane. ptxas' report; for each batch the
    candidates' share, each route's time, K2 any-hit's, the sort's share,
    each pass's time against its bound by bytes; then each cell's frame (8
    chunks). Returns the kernels line's results, by batch and by frame."""
    from minipath_tpu_torch.render import shadow as shadow_passes

    log("34 shadow", f"shadow.cu: {json.dumps(ptxas_usage(shadow_passes.load_library().log))}")
    chunks = PT_SPP // SHADE_CHUNK
    out, frames = {}, {}
    _, _, frame = tworooms_cell(device, "34 shadow")
    cells = (("pt-tworooms-1080p64", lambda: frame(SHADE_CHUNK, 34)),
             ("pt-1080p64-nee1", lambda: render_pt(parts, device, PT_WIDTH, PT_HEIGHT, SHADE_CHUNK, 1, SHADE_CHUNK,
                                                  seed=34)))
    for cell, make in cells:
        batches = capture_shadow_batches(make)
        results = [shadow_both(f"{cell} bounce {b}", batch, device, smi) for b, batch in enumerate(batches)]
        del batches
        for b, r in enumerate(results):
            out[f"{cell} bounce {b}"] = r
        frames[cell] = {k: chunks * sum(r[k] for r in results)
                        for k in ("ms", "plain_ms", "bound_ms", "path_ms", "path_bound_ms", "route_ms",
                                  "plain_route_ms", "k2_ms")}
        f = frames[cell]
        log("34 shadow", f"{cell}, a frame of {chunks} chunks ({chunks * len(results)} batches): the kernel route "
            f"{f['route_ms']:.2f} ms, the plain route {f['plain_route_ms']:.2f} ms, K2 any-hit {f['k2_ms']:.2f} ms "
            f"of each | the batch without K2 {f['path_ms']:.2f} ms against {f['plain_ms']:.2f} ms, bound "
            f"{f['path_bound_ms']:.2f} ms: {100 * f['path_bound_ms'] / f['path_ms']:.1f}% | the four passes "
            f"{f['ms']:.2f} ms, bound {f['bound_ms']:.2f} ms: {100 * f['bound_ms'] / f['ms']:.1f}% | {smi}")
    out.update({f"{cell} frame": dict(f, err=0.0, bound_by="bytes") for cell, f in frames.items()})
    return out


# Phase 31: the camera-ray kernel against the plain chain on the parity cell's
# dispatch pass (64 tiles x 4,096 px x 32 spp = 8,388,608 lanes) and on the
# path tracer's chunk (8 spp of 1920 x 1088 = 16,711,680 lanes). A lane's
# least bytes: its four uniforms read (16 B) and its nine rows written (36 B).
CAMERA_LANE_BYTES = 16 + 36


def phase_camera(bvh, device, smi):
    """Phase 31: ``csrc/camera.cu`` against the plain chain (``sample_rays``
    and ``rays_to_rays9``) on the card, from one generator state: every lane
    of a parity dispatch pass and of a pt-1080p64-nee1 chunk equal, the
    generator left in the same state. Prints ptxas' report, the kernel's
    time alone, with its draws and origin table (what the main path pays),
    the plain chain's, their peak memory, and the kernel's share of its
    byte bound; then one ``render()`` frame in tile mode with a callback,
    whose camera launches and ``camera.kernel_lanes`` are counted. Returns
    the kernels line's results and that frame's launches."""
    from minipath_tpu_torch import RenderSettings, Scene, render
    from minipath_tpu_torch.render import camera_rays, frame, integrator
    from minipath_tpu_torch.render.kernels import rays_to_rays9
    from minipath_tpu_torch.render.machinery import PACKET_SHAPE, SAMPLES_PER_PASS
    from minipath_tpu_torch.screen_block import ScreenBlock
    from minipath_tpu_torch.utils import profiling
    from minipath_tpu_torch.utils.roofline import PEAK_HBM_BYTES

    usage = ptxas_usage(camera_rays.load_library().log)
    log("31 camera", f"camera.cu: {json.dumps(usage)}")
    if len(usage) != 1 or usage[0]["spill_stores"] or usage[0]["spill_loads"]:
        raise AssertionError(f"camera.cu: expected one kernel without spills, got {usage}")

    sampler = bench_camera().build_sampler((WIDTH, HEIGHT), device)
    tiles = ScreenBlock.with_size((0, 0), (WIDTH, HEIGHT)).tile_ordering(TILE, rng=np.random.default_rng(0))
    origins = torch.tensor(np.array([t.min for t in tiles[:64]], np.float32), device=device)
    shape = dict(tile_shape=(TILE, TILE), packet_shape=PACKET_SHAPE, spp=SAMPLES_PER_PASS)
    chunk = dict(width=PT_WIDTH, height=PT_HEIGHT, px_block=(16, 16), samples=SHADE_CHUNK, strat_spp=PT_SPP,
                 strat_offset=SHADE_CHUNK, strat_seed=-1_234_567_891)

    def plain_chunk(g):
        real = frame.uses_camera_kernel
        frame.uses_camera_kernel = lambda dev: False
        try:
            return frame.gen_frame_rays9(sampler, g, **chunk)[0]
        finally:
            frame.uses_camera_kernel = real

    cases = {
        "parity dispatch pass": (lambda g: integrator.tile_batch_rays9(sampler, origins, g, 12345, **shape),
                                 lambda g: rays_to_rays9(integrator.tile_batch_rays(sampler, origins, g, 12345,
                                                                                    **shape))),
        "pt chunk": (lambda g: frame.gen_frame_rays9(sampler, g, **chunk)[0], plain_chunk),
    }
    out = {}
    for name, (kernel, plain) in cases.items():
        fields, launch = {}, frame.launch_camera

        def recording(dev, **f):
            fields.update(f)
            return launch(dev, **f)

        g_kernel, g_plain = (torch.Generator(device=device).manual_seed(31) for _ in range(2))

        def peak_above_rays(make):
            """``make()`` and its peak device memory beyond what it found
            allocated and the rays it returns."""
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            rays = make()
            torch.cuda.synchronize()
            return rays, torch.cuda.max_memory_allocated(device) - base - rays.numel() * rays.element_size()

        frame.launch_camera = recording
        try:
            got, kernel_peak = peak_above_rays(lambda: kernel(g_kernel))
        finally:
            frame.launch_camera = launch
        want, plain_peak = peak_above_rays(lambda: plain(g_plain))
        B, _, P = got.shape
        differ = exact_differences(got.transpose(1, 2), want.transpose(1, 2)) if got.shape == want.shape else B * P
        generator_differs = not torch.equal(g_kernel.get_state(), g_plain.get_state())
        ms = cuda_ms(lambda: launch(device, **fields), 10)
        paid_ms = cuda_ms(lambda: kernel(g_kernel), 10)
        plain_ms = cuda_ms(lambda: plain(g_plain), 2)
        nbytes = B * P * CAMERA_LANE_BYTES
        bound_ms = nbytes / PEAK_HBM_BYTES * 1e3
        text = (f"{name} {tuple(got.shape)} = {B * P} lanes: lanes that differ {differ}, generator differs "
                f"{generator_differs} | kernel {ms:.4f} ms, with its draws and origin table {paid_ms:.4f} ms, plain "
                f"{plain_ms:.3f} ms | peak memory above the rays kernel {kernel_peak / 1e6:.1f} MB, plain "
                f"{plain_peak / 1e6:.1f} MB | bound {bound_ms:.4f} ms by bytes ({nbytes / 1e9:.4f} GB at "
                f"{CAMERA_LANE_BYTES} B a lane): the kernel at {100 * bound_ms / ms:.1f}%")
        if differ or generator_differs:
            raise AssertionError(f"the camera kernel disagrees with the plain chain on {smi}: {text}")
        log("31 camera", text)
        out[name] = dict(ms=ms, paid_ms=paid_ms, plain_ms=plain_ms, err=0.0, bound_ms=bound_ms, bound_by="bytes",
                         kernel_peak_mb=kernel_peak / 1e6, plain_peak_mb=plain_peak / 1e6)
        del got, want, fields

    tiles_back = []

    def render_frame():
        tiles_back.clear()
        p = render(Scene(bvh), bench_camera(), RenderSettings(TILE, SPP, (WIDTH, HEIGHT)), device=device, seed=1,
                   finished_tile_callback=lambda t, snap: tiles_back.append(t))
        p.wait()
        return p

    render_frame()
    before = camera_rays.launch.launches
    profiling.take()
    profiling.enable()
    try:
        p = render_frame()
        lanes = profiling.take().counters.get("camera.kernel_lanes")
    finally:
        profiling.disable()
    launches = camera_rays.launch.launches - before
    n_tiles = -(-WIDTH // TILE) * -(-HEIGHT // TILE)
    if launches != 2 * -(-n_tiles // 64) or lanes != n_tiles * TILE * TILE * SPP or len(tiles_back) != n_tiles:
        raise AssertionError(f"render() in tile mode: {launches} camera launches, camera.kernel_lanes {lanes}, "
                             f"{len(tiles_back)} tiles called back")
    log("31 camera", f"render() {WIDTH}x{HEIGHT} @ {SPP} spp, tile mode, {n_tiles} tiles: {launches} camera launches, "
        f"camera.kernel_lanes {lanes}, traced frame {p.elapsed():.3f} s | {smi}")
    return out, launches


def phase_card_vs_cpu(bvh, dicts, device, quantized=False, phase="8 card vs cpu"):
    """The same Sobol frame (every dimension a pure function of pixel,
    sample and seed; no roulette fires) on the card and on the CPU."""
    from minipath_tpu_torch.render.wavefront import render_frame_pt
    from minipath_tpu_torch.scene.materials import Environment

    def frame(dev):
        scene, table, lights, tracer, shadow = pt_parts(bvh, dicts, dev, quantized)
        t0 = time.perf_counter()
        img = render_frame_pt(
            tracer, scene, table, bench_camera().build_sampler((64, 64), dev), None, width=64, height=64, spp=4,
            bounces=3, env=Environment.sky(dev), samples_per_packet=4, lights=lights, shadow_tracer=shadow,
            sobol=True, shadow_rr=False, strat_seed=2024,
        ).cpu()
        return img, time.perf_counter() - t0

    got, t_card = frame(device)
    want, t_cpu = frame(torch.device("cpu"))
    close = ((got - want).abs().amax(dim=-1) <= FRAME_PIXEL_ATOL).float().mean().item()
    m_got, m_want = got[..., :3].mean().item(), want[..., :3].mean().item()
    rel = abs(m_got - m_want) / abs(m_want)
    text = (f"64x64 @ 4 spp Sobol, 3 bounces, NEE: pixels within {FRAME_PIXEL_ATOL} {close:.4f}, means card "
            f"{m_got:.6f} / cpu {m_want:.6f} (rel {rel:.2e}), max abs diff {(got - want).abs().max().item():.3g} | "
            f"card {t_card:.2f} s, cpu (plain versions) {t_cpu:.2f} s")
    if not torch.isfinite(got).all() or close < FRAME_PIXEL_SHARE or rel > FRAME_MEAN_RTOL:
        raise AssertionError(f"the card's frame disagrees with the CPU's: {text}")
    log(phase, text)


def phase_pt_cli():
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "atrium_pt.png"
        cmd = [sys.executable, "-m", "minipath_tpu_torch.cli", "--scene", "atrium", "--integrator", "pt", "--nee",
               "--width", "480", "--height", "270", "--spp", "8", "--device", "cuda", "--no-stats", "-o", str(out)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0 or not out.exists():
            raise AssertionError(f"CLI failed (exit {proc.returncode}):\n{proc.stderr[-4000:]}")
        from PIL import Image

        img = np.asarray(Image.open(out))
        if img.shape != (270, 480, 4) or not (img[..., :3] > 0).any():
            raise AssertionError(f"CLI image {img.shape} is empty")
        said = [ln for ln in proc.stderr.splitlines() if ln.startswith("path traced")]
        log("9 pt cli", f"exit 0 in {time.perf_counter() - t0:.1f}s, {out.name} {img.shape}, mean "
            f"{img[..., :3].mean():.1f}/255 | {' '.join(said)}")

def kernel_launch_counts() -> dict:
    """Every traversal wrapper's launch count, flattened."""
    from minipath_tpu_torch.tools.common import kernel_launches

    return kernel_launches()


def phase_denoise(pt_bvh, parts, ref64, device, smi):
    """Phase 14: a 4-spp frame with its variance, the guide buffers through
    both tracers, the filter in both modes (timed, and against the CPU on a
    crop), and what the filter buys against phase 7's 64-spp frame."""
    from minipath_tpu_torch.render.denoise import atrous_denoise, render_aux
    from minipath_tpu_torch.render.wavefront import make_full_tracer, render_frame_pt

    scene, table, lights, tracer, shadow = parts
    sampler, env = frame_inputs(device, PT_WIDTH, PT_HEIGHT)

    def noisy_frame(seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        return render_frame_pt(
            tracer, scene, table, sampler, gen, width=PT_WIDTH, height=PT_HEIGHT, spp=DENOISE_SPP,
            bounces=PT_BOUNCES, env=env, samples_per_packet=2, lights=lights, shadow_tracer=shadow,
            nee_max_depth=1, return_variance=True,
        )

    noisy_frame(10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img4, var = noisy_frame(11)
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t0
    if img4.shape != (PT_HEIGHT, PT_WIDTH, 4) or var.shape != (PT_HEIGHT, PT_WIDTH) or not bool((var >= 0).all()):
        raise AssertionError(f"4-spp frame {tuple(img4.shape)}, variance {tuple(var.shape)}")
    log("14 denoise", f"render_frame_pt {PT_WIDTH}x{PT_HEIGHT} @ {DENOISE_SPP} spp with return_variance on {smi}: "
        f"warm {frame_s:.3f} s, mean {img4[..., :3].mean().item():.5f}, mean variance {var.mean().item():.3e}")

    # The guide buffers, through the lean tracer (K2 and the f16 table) and
    # through the full kernel (K1's f32 normals, and K3 in full mode over the
    # quantized layout of the same tree), on the same rays.
    full_tracer, full_scene = make_full_tracer(pt_bvh.kernel_scene(device), stack_size=pt_bvh.recommended_stack_size,
                                               packet_size=PT_PACKET)
    q_tracer, q_scene = make_full_tracer(pt_bvh.quantized_scene(device), stack_size=pt_bvh.recommended_stack_size,
                                         packet_size=PT_PACKET)

    def aux(tr, st):
        return render_aux(tr, st, sampler, torch.Generator(device=device).manual_seed(12), width=PT_WIDTH,
                          height=PT_HEIGHT)

    before = kernel_launch_counts()
    n_pt, z_pt = aux(tracer, scene)
    n_full, z_full = aux(full_tracer, full_scene)
    n_q, z_q = aux(q_tracer, q_scene)
    torch.cuda.synchronize()
    after = kernel_launch_counts()
    launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    if launched != {"K1": 1, "K2 closest": 1, "K3 full": 1}:
        raise AssertionError(f"the three aux traces should launch K2, K1 and K3 full once each, launched {launched}")
    hit_pt, hit_full = torch.any(n_pt != 0, dim=-1), torch.any(n_full != 0, dim=-1)
    n_err = (n_pt - n_full).abs().max().item()
    z_equal = torch.equal(z_pt, z_full)
    aux_pt_ms = cuda_ms(lambda: aux(tracer, scene), 5)
    aux_full_ms = cuda_ms(lambda: aux(full_tracer, full_scene), 5)
    aux_q_ms = cuda_ms(lambda: aux(q_tracer, q_scene), 5)
    text = (f"render_aux {PT_WIDTH}x{PT_HEIGHT}: through make_pt_tracer {aux_pt_ms:.3f} ms, through make_full_tracer "
            f"{aux_full_ms:.3f} ms | launches {launched} | hit masks equal {torch.equal(hit_pt, hit_full)}, hit share "
            f"{hit_pt.float().mean().item():.4f}, depths equal {z_equal}, max normal difference {n_err:.3g} (f16 "
            f"table against f32)")
    if not torch.equal(hit_pt, hit_full) or not z_equal or n_err > AUX_NORMAL_ATOL:
        raise AssertionError(f"the two aux traces disagree: {text}")
    log("14 denoise", text)
    # The quantized layout moves every vertex by up to half a 16-bit step of
    # its leaf's box, so K3's first hits are K1's up to that: the same hit
    # mask on at least 99% of pixels and, on at least 99% of those both hit,
    # the depth within rtol 1e-3 and the normal within 1e-2.
    hit_q = torch.any(n_q != 0, dim=-1)
    both = hit_q & hit_full
    mask_share = (hit_q == hit_full).float().mean().item()
    z_share = (((z_q - z_full).abs() <= AUX_Q_DEPTH_RTOL * z_full)[both]).float().mean().item()
    nq_share = (((n_q - n_full).abs().amax(dim=-1) <= AUX_Q_NORMAL_ATOL)[both]).float().mean().item()
    text = (f"render_aux {PT_WIDTH}x{PT_HEIGHT} through make_full_tracer over the QuantizedScene (K3 full): "
            f"{aux_q_ms:.3f} ms | against K1's: hit masks equal on {mask_share:.6f}, depths within rtol "
            f"{AUX_Q_DEPTH_RTOL} on {z_share:.6f}, normals within {AUX_Q_NORMAL_ATOL} on {nq_share:.6f} of the "
            f"commonly hit")
    if min(mask_share, z_share, nq_share) < AUX_Q_SHARE or not bool(torch.isfinite(z_q).all()):
        raise AssertionError(f"K3's aux trace is not K1's: {text}")
    log("14 denoise", text)
    del n_full, z_full, n_q, z_q

    # The bounce loop over the full kernel: the same Sobol paths as over the
    # lean tracer, up to the f16 normals of its table, which move a glossy
    # bounce by 2e-3 and so a few paths to another surface (means within
    # 0.5%, at least 90% of pixels within 2e-2). K1 and K3 read the live
    # count from device memory as K2 does, so neither frame makes more host
    # syncs than the lean tracer's. Over the quantized layout the paths are
    # K1's up to the moved vertices (mean within 0.5% of the lean tracer's).
    import warnings

    def sobol_frame(tr, st):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render_frame_pt(tr, st, table, sampler, None, width=PT_WIDTH, height=PT_HEIGHT, spp=DENOISE_SPP,
                              bounces=3, env=env, samples_per_packet=2, sobol=True, strat_seed=2024).cpu()
        return img, time.perf_counter() - t0

    counted = {}
    for label, tr, st in (("make_pt_tracer", tracer, scene), ("make_full_tracer", full_tracer, full_scene),
                          ("quantized", q_tracer, q_scene)):
        sobol_frame(tr, st)
        before = kernel_launch_counts()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                img, seconds = sobol_frame(tr, st)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        after = kernel_launch_counts()
        counted[label] = dict(img=img, s=seconds, syncs=sum("synchroniz" in str(w.message) for w in caught),
                              launches={k: after[k] - before[k] for k in after if after[k] != before[k]})
    lean, full = counted["make_pt_tracer"], counted["make_full_tracer"]
    m_lean, m_full = lean["img"][..., :3].mean().item(), full["img"][..., :3].mean().item()
    close = ((lean["img"] - full["img"]).abs().amax(dim=-1) <= 2e-2).float().mean().item()
    text = (f"render_frame_pt {PT_WIDTH}x{PT_HEIGHT} @ {DENOISE_SPP} spp Sobol, 3 bounces (no roulette fires), no NEE: over "
            f"make_pt_tracer {lean['s']:.3f} s, {lean['syncs']} host syncs, launches {lean['launches']}; over "
            f"make_full_tracer {full['s']:.3f} s, {full['syncs']} host syncs, launches {full['launches']} | means "
            f"{m_lean:.5f} / {m_full:.5f}, pixels within 2e-2 {close:.4f}")
    if full["launches"].get("K1", 0) == 0 or abs(m_full - m_lean) > STAT_RTOL * m_lean or close < 0.9:
        raise AssertionError(f"the frame over the full kernel is not the lean tracer's: {text}")
    if full["syncs"] > lean["syncs"]:
        raise AssertionError(f"the frame over K1 makes more host syncs than over K2: {text}")
    log("14 denoise", text)
    quant = counted["quantized"]
    m_q = quant["img"][..., :3].mean().item()
    close_q = ((quant["img"] - full["img"]).abs().amax(dim=-1) <= 2e-2).float().mean().item()
    text = (f"the same frame over make_full_tracer on the QuantizedScene: {quant['s']:.3f} s, {quant['syncs']} host "
            f"syncs, launches {quant['launches']} | mean {m_q:.5f} (lean {m_lean:.5f}, K1 {m_full:.5f}), pixels within "
            f"2e-2 of K1's {close_q:.4f}")
    if (quant["launches"].get("K3 full", 0) == 0 or set(quant["launches"]) != {"K3 full"}
            or abs(m_q - m_lean) > STAT_RTOL * m_lean or not bool(torch.isfinite(quant["img"]).all())
            or quant["syncs"] > lean["syncs"]):
        raise AssertionError(f"the frame over K3 in full mode is not the lean tracer's: {text}")
    log("14 denoise", text)
    del counted, lean, full, quant, full_tracer, full_scene, q_tracer, q_scene

    rgb = img4[..., :3].contiguous()
    den_fixed = atrous_denoise(rgb, n_pt, z_pt)
    den_var = atrous_denoise(rgb, n_pt, z_pt, var)
    fixed_ms = cuda_ms(lambda: atrous_denoise(rgb, n_pt, z_pt), 3)
    var_ms = cuda_ms(lambda: atrous_denoise(rgb, n_pt, z_pt, var), 3)
    log("14 denoise", f"atrous_denoise {PT_WIDTH}x{PT_HEIGHT}, 4 iterations, on {smi}: fixed-sigma {fixed_ms:.2f} ms, "
        f"variance-guided {var_ms:.2f} ms (CUDA events, warm, mean of 3)")

    # The card against the CPU on a crop of the same inputs, around the
    # middle of the frame.
    y0, x0 = (PT_HEIGHT - DENOISE_CROP) // 2, (PT_WIDTH - DENOISE_CROP) // 2
    crop = [a[y0:y0 + DENOISE_CROP, x0:x0 + DENOISE_CROP].contiguous() for a in (rgb, n_pt, z_pt, var)]
    for label, with_var in (("fixed-sigma", False), ("variance-guided", True)):
        args = crop if with_var else crop[:3]
        got = atrous_denoise(*args).cpu()
        want = atrous_denoise(*(a.cpu() for a in args))
        err = (got - want).abs()
        close = (err <= DENOISE_ATOL + DENOISE_RTOL * want.abs()).float().mean().item()
        text = (f"{label} on a {DENOISE_CROP}x{DENOISE_CROP} crop, card against CPU: within rtol {DENOISE_RTOL} atol "
                f"{DENOISE_ATOL} {close:.6f}, max abs diff {err.max().item():.3g}")
        if not bool(torch.isfinite(got).all()) or close < DENOISE_SHARE or err.max().item() > DENOISE_MAX_ABS:
            raise AssertionError(f"the card's filter disagrees with the CPU's: {text}")
        log("14 denoise", text)

    # What it buys: the error against phase 7's 64-spp frame.
    ref = torch.from_numpy(ref64[..., :3]).to(device)

    def rmse(a):
        return torch.sqrt(torch.mean((a - ref) ** 2)).item()

    e_raw, e_fixed, e_var = rmse(rgb), rmse(den_fixed), rmse(den_var)
    m_raw, m_var = rgb.mean().item(), den_var.mean().item()
    text = (f"RMSE against phase 7's {PT_SPP}-spp frame: raw {DENOISE_SPP}-spp {e_raw:.5f}, fixed-sigma {e_fixed:.5f}, "
            f"variance-guided {e_var:.5f} | means raw {m_raw:.5f}, variance-guided {m_var:.5f}, fixed-sigma "
            f"{den_fixed.mean().item():.5f}, reference {ref.mean().item():.5f}")
    if not (e_var < e_raw) or abs(m_var - m_raw) > DENOISE_MEAN_RTOL * m_raw or not bool(torch.isfinite(den_var).all()):
        raise AssertionError(f"the filter does not help: {text}")
    log("14 denoise", text)
    return dict(frame_s=frame_s, aux_pt_ms=aux_pt_ms, aux_full_ms=aux_full_ms, aux_q_ms=aux_q_ms, fixed_ms=fixed_ms,
                var_ms=var_ms)


def phase_denoise_cli():
    with tempfile.TemporaryDirectory() as tmp:
        out, prefix = Path(tmp) / "atrium_pt.png", Path(tmp) / "aov"
        cmd = [sys.executable, "-m", "minipath_tpu_torch.cli", "--scene", "atrium", "--integrator", "pt", "--nee",
               "--denoise", "--aov", str(prefix), "--width", "512", "--height", "384", "--spp", "8", "--device",
               "cuda", "--no-stats", "-o", str(out)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
        files = [out, Path(f"{prefix}_normal.png"), Path(f"{prefix}_depth.png")]
        if proc.returncode != 0 or not all(f.exists() for f in files):
            raise AssertionError(f"CLI failed (exit {proc.returncode}):\n{proc.stderr[-4000:]}")
        from PIL import Image

        imgs = [np.asarray(Image.open(f)) for f in files]
        if any(i.shape != (384, 512, 4) for i in imgs) or not all((i[..., :3] > 0).any() for i in imgs):
            raise AssertionError(f"CLI images {[i.shape for i in imgs]}: one is empty")
        said = [ln for ln in proc.stderr.splitlines() if ln.startswith(("path traced", "denoised", "saved"))]
        if not any("variance-guided" in ln for ln in said):
            raise AssertionError(f"the CLI did not take the variance-guided filter: {said}")
        log("14 denoise cli", f"exit 0 in {time.perf_counter() - t0:.1f}s, {[f.name for f in files]} | "
            f"{' | '.join(said)}")


def pump(controller, until, timeout=120.0):
    """Call ``controller.update()`` until ``until()`` holds."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        controller.update()
        if until():
            return
        time.sleep(0.002)
    raise AssertionError(f"the GUI controller did not get there in {timeout:.0f} s")


def phase_gui(native_bvh, pt_bvh, dicts, device, smi):
    """Phase 15: the GUI benchmark, a controller's image against
    ``render()``'s, an abort in mid-render, and the progressive viewport."""
    import contextlib
    import io

    from minipath_tpu_torch import RenderSettings, Scene, render
    from minipath_tpu_torch import gui
    from minipath_tpu_torch.render import kernels
    from minipath_tpu_torch.tools import bench_gui

    w, h = GUI_SIZE
    total = -(-w // TILE) * -(-h // TILE)
    kernels.trace_packets.launches = 0
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        rc = bench_gui.main(["--device", "cuda", "--scene", "atrium", str(w), str(h)])
    if rc != 0:
        raise AssertionError(f"bench_gui exited {rc}")
    result = json.loads(said.getvalue())
    k1_bench = kernels.trace_packets.launches
    log("15 gui", f"bench_gui on {smi}: {json.dumps(result)} | K1 launches {k1_bench}")
    # measure() raises unless every driven render finished its tiles and
    # each preview escalated; here the counts it reports.
    if result["tiles"] != total or k1_bench == 0 or not result["first_feedback_under_1s"]:
        raise AssertionError(f"bench_gui: {result['tiles']} of {total} tiles, K1 launches {k1_bench}")

    # A controller's full image against render()'s for the same seed.
    camera = bench_gui.scene_camera("atrium")
    scene = Scene(native_bvh)
    c = gui.GuiController(scene, camera, (w, h), tile_size=TILE, device=device)
    c.start()
    pump(c, lambda: c.mode == "full" and c.progress.is_finished())
    c.update()
    snap = c.progress.progress()
    if snap.finished != snap.total or snap.total != total or c.in_progress_tiles:
        raise AssertionError(f"the full render finished {snap.finished}/{snap.total} tiles")
    settings = RenderSettings(TILE, c.full_spp, (w, h))
    p_tile = render(scene, camera, settings, lambda t: None, lambda t, s: None, device=device)
    p_tile.wait()
    p_frame = render(scene, camera, settings, device=device)
    p_frame.wait()
    img, img_frame = c.image, p_frame.image()
    equal = np.array_equal(img, p_tile.image())

    def stats(a):
        return float(a[..., 3].mean()) / 255, float(a[..., 0].mean()) / 255

    (cov, mean), (cov_f, mean_f) = stats(img), stats(img_frame)
    text = (f"GuiController {w}x{h}, preview 1 spp -> full {c.full_spp} spp: {snap.finished}/{snap.total} tiles | "
            f"image == render() in tile mode, same seed: {equal} | against render() in frame mode: coverage "
            f"{cov:.5f} / {cov_f:.5f}, mean value {mean:.5f} / {mean_f:.5f}, pixels equal "
            f"{float((img == img_frame).all(-1).mean()):.4f}")
    if not equal or abs(cov - cov_f) > STAT_RTOL * cov_f or abs(mean - mean_f) > STAT_RTOL * mean_f:
        raise AssertionError(f"the controller's image is not render()'s: {text}")
    log("15 gui", text)

    # abort() in the middle of a 64-spp render: the dispatch in flight
    # finishes, no other starts, and no error comes back.
    c.full_spp = GUI_ABORT_SPP
    c.move_camera(0.25, 0.0, 0.0)
    pump(c, lambda: c.mode == "full" and c.progress.progress().finished > 0)
    handle = c.progress
    t0 = time.perf_counter()
    c.cancel_previous_render()
    abort_s = time.perf_counter() - t0
    snap = handle.progress()
    if not handle.is_finished() or not 0 < snap.finished < snap.total or c.progress is not None:
        raise AssertionError(f"abort() left {snap.finished}/{snap.total} tiles, finished {handle.is_finished()}")
    log("15 gui", f"abort() during the {GUI_ABORT_SPP}-spp render: returned in {abort_s:.3f} s with "
        f"{snap.finished}/{snap.total} tiles finished, no error")
    c.shutdown()

    # The progressive path-traced viewport. Its worker thread launches while
    # this one reads the counters, so they are read after shutdown.
    vw, vh = VIEWPORT_SIZE
    for mode in kernels.trace_packets_pt.launches:
        kernels.trace_packets_pt.launches[mode] = 0
    args = argparse.Namespace(width=vw, height=vh, device=str(device))
    pc = gui._make_pt_controller(args, pt_bvh, bench_camera(), dicts)
    t0 = time.perf_counter()
    pc.start()
    pump(pc, lambda: pc.samples() >= 1, timeout=300.0)
    first_s = time.perf_counter() - t0
    t1, n1 = time.perf_counter(), pc.samples()
    pump(pc, lambda: pc.samples() >= VIEWPORT_PASSES, timeout=300.0)
    n2 = pc.samples()
    rate = (n2 - n1) / (time.perf_counter() - t1)
    # Twice: each call that finds new passes filters anew, beside the worker,
    # whose launches share the card and the interpreter with it.
    display_s = []
    for _ in range(2):
        seen = pc.samples()
        pump(pc, lambda: pc.samples() > seen, timeout=300.0)
        t0 = time.perf_counter()
        shown = pc.display_image()
        display_s.append(time.perf_counter() - t0)
    if shown.shape != (vh, vw, 3) or shown.dtype != np.uint8 or not 0 < shown.mean() < 255:
        raise AssertionError(f"display_image() {shown.shape} {shown.dtype} mean {shown.mean()}")
    aux_before = pc._aux[0]
    pc.move_camera(0.25, 0.0, 0.0)
    pump(pc, lambda: pc._gen == 1 and pc._aux[0] is not aux_before and pc.samples() >= 1, timeout=300.0)
    restarted = pc.samples()
    pc.shutdown()
    if pc._thread.is_alive():
        raise AssertionError("the viewport's worker did not stop")
    if restarted >= n2:
        raise AssertionError(f"the camera move did not restart the accumulation: {restarted} passes after {n2}")
    k2 = dict(kernels.trace_packets_pt.launches)
    if k2["closest"] == 0:
        raise AssertionError("the viewport launched no K2")
    log("15 gui", f"ProgressivePtController {vw}x{vh}, 1 spp a pass, 5 bounces, with make_aux on {smi}: first pass "
        f"after {first_s:.3f} s, {n2} passes at {rate:.2f} passes/s, display_image() with the filter, beside "
        f"the worker, {' and '.join(f'{t * 1e3:.1f}' for t in display_s)} ms | a camera move restarted the accumulation ({n2} -> {restarted} passes, new guide "
        f"buffers) | K2 launches {k2}")
    return result, k1_bench, k2["closest"], dict(passes_per_s=rate, display_ms=[t * 1e3 for t in display_s])


def phase_sphere(device, smi):
    """Phase 16: the analytic sphere through ``render()``; no kernel."""
    from minipath_tpu_torch import Camera, RenderSettings, Scene, Sphere, render

    camera = Camera().look_at((0.0, 0.5, 4.0), (0.0, 0.0, 0.0))
    scene = Scene(Sphere())

    def frame(dev, size):
        p = render(scene, camera, RenderSettings(TILE, SPP, size), device=dev)
        p.wait()
        snap = p.progress()
        if snap.finished != snap.total:
            raise AssertionError(f"{snap.finished}/{snap.total} tiles finished")
        return p, p.image()

    frame(device, (WIDTH, HEIGHT))
    before = kernel_launch_counts()
    p, img = frame(device, (WIDTH, HEIGHT))
    if kernel_launch_counts() != before:
        raise AssertionError("the sphere's frame launched a traversal kernel")
    _, img_cpu = frame("cpu", (256, 144))
    (cov, mean), (cov_c, mean_c) = ((float(a[..., 3].mean()) / 255, float(a[..., 0].mean()) / 255) for a in (img, img_cpu))
    text = (f"render() of Scene(Sphere()) {WIDTH}x{HEIGHT} @ {SPP} spp on {smi}: warm frame {p.elapsed():.3f} s = "
            f"{WIDTH * HEIGHT * SPP / p.elapsed() / 1e6:.1f} Mrays/s, no kernel launch | coverage {cov:.5f}, mean value "
            f"{mean:.5f}; the CPU's frame at 256x144: {cov_c:.5f}, {mean_c:.5f} | phases "
            f"{json.dumps(p.timings().summary())}")
    if img.shape != (HEIGHT, WIDTH, 4) or abs(cov - cov_c) > STAT_RTOL * cov_c or abs(mean - mean_c) > STAT_RTOL * mean_c:
        raise AssertionError(f"the sphere's frame on the card is not the CPU's: {text}")
    log("16 sphere", text)
    return p.elapsed()


def build_big_atrium(device):
    """bench.py's Sponza-scale atrium: ``make_atrium(600_000)``, leaves of up
    to 24 triangles, with its quantized layout on ``device``."""
    from minipath_tpu_torch.scene.bvh import links as L
    from minipath_tpu_torch.scene.bvh.quantize import root_frame
    from minipath_tpu_torch.scene.procedural import make_atrium
    from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh

    t0 = time.perf_counter()
    bvh = TriangleBvh.build(make_atrium(BIG_TRIANGLES), leaf_max=24)
    built = time.perf_counter() - t0
    t0 = time.perf_counter()
    q = bvh.quantized_scene(device)
    # K3 takes the root's frame from its node_frame row; the quantizer encoded
    # the root's children against root_frame(stored box). The three must be
    # one box.
    box = q.root_box.cpu().numpy()
    if not np.array_equal(root_frame(box), box):
        raise AssertionError(f"root_frame(root_box) {root_frame(box)} differs from the stored root box {box}")
    frame = q.node_frame[q.root >> L.COUNT_BITS, :6].cpu().numpy()
    if not np.array_equal(frame, box):
        raise AssertionError(f"the root's node_frame row {frame} differs from the stored root box {box}")
    stats = bvh.statistics()
    print(f"big atrium: {stats['triangles']} triangles, {stats['inner_nodes']} inner nodes, max depth "
          f"{stats['max_depth']}, stack {bvh.recommended_stack_size}, built in {built:.1f}s, quantized in "
          f"{time.perf_counter() - t0:.1f}s: {bvh.quantized_scene_bytes() / 1e6:.1f} MB "
          f"({q.node_frame.numel() * 4 / 1e6:.1f} MB of them node_frame) against {bvh.f32_scene_bytes() / 1e6:.1f} MB "
          f"for the f32 layout = {bvh.quantized_scene_bytes() / bvh.f32_scene_bytes():.1%}", flush=True)
    if bvh.quantized_scene_bytes() != sum(t.numel() * t.element_size() for t in (q.node_q, q.tri_q, q.node_frame)):
        raise AssertionError("quantized_scene_bytes() disagrees with the layout's tensors")
    return bvh


def phase_k3(big, pt_bvh, pt_scene, sets, device):
    """K3 against its plain version in its three modes, and beside K1 or K2
    on the same rays over the f32 layout."""
    from minipath_tpu_torch.render import kernels, kernels_q
    from minipath_tpu_torch.render import wavefront as W

    out = {}

    def check(key, label, scene, r9, rival, rival_name, lean=False, anyhit=False, **kw):
        kw = {"stack_size": kw.pop("stack_size"), "t_max": math.inf, "live_packets": None, **kw}

        def run():
            return kernels_q.trace_packets_q(scene, r9, lean=lean, anyhit=anyhit, **kw)

        got = run()
        torch.cuda.synchronize()
        want = kernels_q.trace_packets_q_reference(scene, r9, lean=lean, anyhit=anyhit, **kw)
        if lean:
            text, err = compare_pt(label, got, want, anyhit, kernel="K3")
        else:
            text, err = compare(label, got, want)
        ms = cuda_ms(run, 20)
        rival_ms = cuda_ms(rival, 20)
        plain_ms = cuda_ms(lambda: kernels_q.trace_packets_q_reference(scene, r9, lean=lean, anyhit=anyhit, **kw), 1)
        cost = "traverse_q_lean" if lean else "traverse_q"
        bound_ms, bound_by, bound = traversal_bound(cost, kernels_q.decompressed_kernel_scene(scene), r9, got,
                                                    anyhit=anyhit, **kw)
        log("10 k3", f"{text} | K3 {ms:.4f} ms, plain {plain_ms:.2f} ms, {rival_name} on the same rays "
            f"{rival_ms:.4f} ms (K3/{rival_name} {ms / rival_ms:.3f}) | {bound} | {requested(cost, got, ms)}")
        out[key] = dict(ms=ms, plain_ms=plain_ms, rival_ms=rival_ms, err=err, bound_ms=bound_ms, bound_by=bound_by)

    # Full mode: the big atrium, a main-path dispatch's first 524,288 rays.
    ss = big.recommended_stack_size
    q, f32 = big.quantized_scene(device), big.kernel_scene(device)
    if not isinstance(f32, kernels.KernelScene):
        raise AssertionError("the big atrium's f32 layout should fit the card's budget")
    gen = torch.Generator(device=device).manual_seed(0)
    dispatch = dispatch_rays9(bench_camera().build_sampler((WIDTH, HEIGHT), device), device, gen)
    part = dispatch[:DISPATCH_SLICE]
    check("full", "full closest-hit, big-atrium dispatch slice", q, part,
          lambda: kernels.trace_packets(f32, part, stack_size=ss), "K1", stack_size=ss)
    n = dispatch.shape[0] * dispatch.shape[2]
    ms_q = cuda_ms(lambda: kernels_q.trace_packets_q(q, dispatch, stack_size=ss), 5)
    ms_f = cuda_ms(lambda: kernels.trace_packets(f32, dispatch, stack_size=ss), 5)
    got = kernels_q.trace_packets_q(q, dispatch, stack_size=ss)
    log("10 k3", f"big-atrium main-path dispatch {tuple(dispatch.shape)} = {n} rays: K3 {ms_q:.3f} ms = "
        f"{n / ms_q / 1e3:.1f} Mrays/s ({requested('traverse_q', got, ms_q)}), K1 {ms_f:.3f} ms = "
        f"{n / ms_f / 1e3:.1f} Mrays/s")
    del got
    del dispatch, part

    # Lean modes: phase 6's sets through the path-traced atrium's QPTScene.
    ss = pt_bvh.recommended_stack_size
    qpt = pt_bvh.quantized_pt_scene(device)
    bounce = sets["bounce"]
    check("closest", "lean closest-hit, bounce-1 set", qpt, bounce,
          lambda: kernels.trace_packets_pt(pt_scene, bounce, stack_size=ss), "K2", lean=True, stack_size=ss)
    shadow9, live_s = sets["shadow"]
    check("anyhit", "lean any-hit, NEE shadow set", qpt, shadow9,
          lambda: kernels.trace_packets_pt(pt_scene, shadow9, stack_size=ss, t_max=W._SHADOW_T_MAX,
                                           live_packets=live_s, anyhit=True),
          "K2", lean=True, anyhit=True, stack_size=ss, t_max=W._SHADOW_T_MAX, live_packets=live_s)
    r9, live_packets, live_rays = sets["wavefront"]
    ms_q = cuda_ms(lambda: kernels_q.trace_packets_q(qpt, r9, stack_size=ss, live_packets=live_packets, lean=True), 5)
    ms_f = cuda_ms(lambda: kernels.trace_packets_pt(pt_scene, r9, stack_size=ss, live_packets=live_packets), 5)
    got = kernels_q.trace_packets_q(qpt, r9, stack_size=ss, live_packets=live_packets, lean=True)
    log("10 k3", f"whole bounce-1 wavefront, {live_rays} live rays: K3 {ms_q:.3f} ms = {live_rays / ms_q / 1e3:.1f} "
        f"Mrays/s ({requested('traverse_q_lean', got, ms_q)}), K2 {ms_f:.3f} ms = {live_rays / ms_f / 1e3:.1f} "
        f"Mrays/s")
    return out


def reset_q_launches():
    from minipath_tpu_torch.render import kernels_q

    for mode in kernels_q.trace_packets_q.launches:
        kernels_q.trace_packets_q.launches[mode] = 0


def phase_q_main_path(big, device, smi):
    """bench.py's bench_big_scene on the port: the parity frame of the big
    atrium through ``render_frame`` over the quantized layout, against the
    same frame (same seed, so the same camera rays) over the f32 one."""
    from minipath_tpu_torch.render import kernels_q
    from minipath_tpu_torch.render.frame import render_frame

    sampler, _ = frame_inputs(device, WIDTH, HEIGHT)
    ss = big.recommended_stack_size

    def frame(scene, seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render_frame(scene, sampler, gen, width=WIDTH, height=HEIGHT, spp=SPP, stack_size=ss,
                           samples_per_packet=32).cpu().numpy()
        seconds = time.perf_counter() - t0
        if img.shape != (HEIGHT, WIDTH, 4) or not np.isfinite(img).all() or not (img[..., 3] > 0).any():
            raise AssertionError(f"parity frame {img.shape} is not finite or has no hit")
        return img, seconds

    q, f32 = big.quantized_scene(device), big.kernel_scene(device)
    _, cold = frame(q, 0)
    reset_q_launches()
    img_q, warm = frame(q, 1)
    launches = dict(kernels_q.trace_packets_q.launches)
    _, cold_f = frame(f32, 0)
    img_f, warm_f = frame(f32, 1)
    if launches["full"] == 0:
        raise AssertionError("the quantized parity frame launched no K3")
    m_q, m_f = float(img_q[..., 0].mean()), float(img_f[..., 0].mean())
    shift = (m_q - m_f) / m_f
    rays = WIDTH * HEIGHT * SPP
    text = (f"render_frame {WIDTH}x{HEIGHT} @ {SPP} spp, 32 samples per packet, on {smi}: quantized warm "
            f"{warm:.3f} s = {rays / warm / 1e6:.1f} Mrays/s (cold {cold:.3f} s), K3 launches {launches} | f32 warm "
            f"{warm_f:.3f} s = {rays / warm_f / 1e6:.1f} Mrays/s (cold {cold_f:.3f} s) | mean value quantized "
            f"{m_q:.6f} / f32 {m_f:.6f} (shift {shift:+.3e}), alpha coverage {float(img_q[..., 3].mean()):.4f} / "
            f"{float(img_f[..., 3].mean()):.4f}, pixels within 1e-2 {float((np.abs(img_q - img_f).max(-1) <= 1e-2).mean()):.4f}")
    if abs(shift) > LAYOUT_MEAN_RTOL:
        raise AssertionError(f"the quantized frame's mean is off the f32 frame's: {text}")
    log("11 q main path", text)
    return launches


def phase_q16_cell(device, smi) -> dict:
    """The ``q16-600k-1080p64`` cell's path on its own tree: K3 over the
    first dispatch's slice against ``trace_packets_q_reference``, then one
    warm ``render()`` frame in tile mode with a callback; returns that
    frame's traversal launches."""
    from minipath_tpu_torch import RenderSettings, Scene, render
    from minipath_tpu_torch.render import kernels_q
    from minipath_tpu_torch.scene.procedural import make_atrium
    from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh

    t0 = time.perf_counter()
    bvh = TriangleBvh.build(make_atrium(BIG_TRIANGLES), use_native=True, leaf_max=56, layout="q16")
    built = time.perf_counter() - t0
    q, ss = bvh.kernel_scene(device), bvh.recommended_stack_size
    if not isinstance(q, kernels_q.QuantizedScene):
        raise AssertionError(f"layout 'q16': kernel_scene is a {type(q).__name__}")
    gen = torch.Generator(device=device).manual_seed(0)
    part = dispatch_rays9(bench_camera().build_sampler((WIDTH, HEIGHT), device), device, gen)[:DISPATCH_SLICE]
    got = kernels_q.trace_packets_q(q, part, stack_size=ss)
    torch.cuda.synchronize()
    text, _ = compare("full closest-hit, the cell's tree, dispatch slice", got, kernels_q.trace_packets_q_reference(
        q, part, stack_size=ss))
    del got, part

    tiles = []
    settings = RenderSettings(TILE, SPP, (WIDTH, HEIGHT))

    def frame():
        tiles.clear()
        p = render(Scene(bvh), bench_camera(), settings, finished_tile_callback=lambda t, snap: tiles.append(t),
                   device=device, seed=1)
        p.wait()
        return p, p.image()

    frame()
    reset_launches()
    p, img = frame()
    launches = {k: v for k, v in kernel_launch_counts().items() if v}
    if launches != {"K3 full": 16}:
        raise AssertionError(f"the cell's render() frame launched {launches}, not 16 K3 full launches and no other")
    n_tiles = -(-WIDTH // TILE) * -(-HEIGHT // TILE)
    if len(tiles) != n_tiles or img.shape != (HEIGHT, WIDTH, 4) or not (img[..., 3] > 0).any():
        raise AssertionError(f"{len(tiles)} tiles called back, image {img.shape} with no hit or short")
    stats = bvh.statistics()
    log("30 q16 cell", f"the cell's tree ({stats['triangles']} triangles, {stats['inner_nodes']} inner nodes, max "
        f"depth {stats['max_depth']}, stack {ss}, built in {built:.1f}s, {bvh.quantized_scene_bytes() / 1e6:.2f} MB "
        f"quantized) | {text} | render() {WIDTH}x{HEIGHT} @ {p.spp_effective} spp, tile mode, {len(tiles)} tiles "
        f"called back, on {smi}: warm frame {p.elapsed():.3f} s | launches {launches}")
    return launches


def phase_q_pt(big, pt_bvh, dicts, device, smi, f32_mean):
    """The path tracer over the quantized layout: bench.py's bench_pt_big,
    then phase 7's NEE-capped frame over the path-traced atrium's QPTScene,
    then phase 8's Sobol frame on the card and the CPU."""
    from minipath_tpu_torch.render import kernels_q
    from minipath_tpu_torch.render.wavefront import make_pt_tracer
    from minipath_tpu_torch.scene.materials import lambertian, material_table

    table = material_table([lambertian((0.73, 0.73, 0.73))], device)

    def big_parts(scene):
        tracer, _ = make_pt_tracer(scene, stack_size=big.recommended_stack_size, packet_size=PT_PACKET)
        return scene, table, None, tracer, None

    # The hall is a closed shell and this workload has no emitter, so no
    # path reaches the sky and the frame is black on either layout: it
    # measures traversal and the bounce loop, and its check is the f32
    # frame under the same seed.
    parts = big_parts(big.quantized_pt_scene(device))
    w, h, spp = 960, 540, 8
    _, cold = render_pt(parts, device, w, h, spp, None, spp, seed=60, lit=False)
    reset_q_launches()
    img, warm = render_pt(parts, device, w, h, spp, None, spp, seed=61, lit=False)
    launches = dict(kernels_q.trace_packets_q.launches)
    img_f, warm_f = render_pt(big_parts(big.pt_scene(device)), device, w, h, spp, None, spp, seed=61, lit=False)
    if launches["closest"] == 0:
        raise AssertionError("the big path-traced frame launched no K3")
    m_q, m_f = float(img[..., :3].mean()), float(img_f[..., :3].mean())
    text = (f"bench_pt_big: render_frame_pt of the big atrium, grey Lambertian, sky, {w}x{h} @ {spp} spp, "
            f"{PT_BOUNCES} bounces on {smi}: warm {warm:.3f} s = {w * h * spp / warm / 1e6:.2f} Mpaths/s (cold "
            f"{cold:.3f} s) | K3 launches {launches} | f32 layout, same seed: {warm_f:.3f} s | image mean "
            f"{m_q:.6f} / f32 {m_f:.6f}, all finite")
    if abs(m_q - m_f) > LAYOUT_MEAN_RTOL * abs(m_f) + 1e-6:
        raise AssertionError(f"the quantized frame's mean is off the f32 frame's: {text}")
    log("12 q pt", text)

    parts = pt_parts(pt_bvh, dicts, device, quantized=True)
    reset_q_launches()
    img, warm = render_pt(parts, device, PT_WIDTH, PT_HEIGHT, PT_SPP, 1, 2, seed=1)
    nee_launches = dict(kernels_q.trace_packets_q.launches)
    if nee_launches["closest"] == 0 or nee_launches["anyhit"] == 0:
        raise AssertionError(f"the NEE frame did not launch K3 in both lean modes: {nee_launches}")
    m_q = float(img[..., :3].mean())
    shift = (m_q - f32_mean) / f32_mean
    text = (f"render_frame_pt {PT_WIDTH}x{PT_HEIGHT} @ {PT_SPP} spp, {PT_BOUNCES} bounces, NEE at depth 1 over "
            f"the path-traced atrium's QPTScene: warm {warm:.3f} s = {PT_WIDTH * PT_HEIGHT * PT_SPP / warm / 1e6:.2f} "
            f"Mpaths/s | K3 launches {nee_launches} | image mean {m_q:.5f} against phase 7's {f32_mean:.5f} under "
            f"the same seed (shift {shift:+.3e})")
    if abs(shift) > LAYOUT_MEAN_RTOL:
        raise AssertionError(f"the quantized path-traced frame's mean is off the f32 frame's: {text}")
    log("12 q pt", text)
    phase_card_vs_cpu(pt_bvh, dicts, device, quantized=True, phase="12 q pt")
    return {m: launches[m] + nee_launches[m] for m in launches}


# Phases 17-18: the sharded renderers over one card repeated, and the adaptive
# sampler. The sharded path-traced frame against phase 7's (independent
# samples): the JAX package's tolerances (tests/parallel_impl.py).
# Independent samples of the atrium at 64 spp put only about 85% of values
# within 0.25 of each other (the JAX package's 97% was set on a Lambertian
# sphere at 8 spp), so the sharded frame is held to another unsharded
# frame's share, and a seed-matched Sobol frame of SOBOL_SPP checks its paths.
MESH_SIZE, SOBOL_SPP = 4, 8
SHARD_MEAN_RTOL, SHARD_PIXEL_ATOL, SHARD_SHARE_SLACK = 5e-3, 0.25, 0.01
# The JAX package's agreement of a sharded parity frame with the unsharded
# one on solid pixels (tests/parallel_impl.py), over the quantized layout.
SOLID_ATOL, SOLID_RTOL, SOLID_SHARE = 0.06, 0.15, 0.99
ADAPTIVE_PILOT, ADAPTIVE_CHUNK, ADAPTIVE_MEAN_RTOL = 2, 8, 0.01
CLI_SCENE = "atrium"


def meshes(device):
    """The meshes phase 17 shards over: one card four times, and the real
    devices where there are more than one."""
    from minipath_tpu_torch.parallel import make_device_mesh

    out = [(f"{MESH_SIZE} x {device}", (device,) * MESH_SIZE)]
    if torch.cuda.device_count() > 1:
        out.append((f"{torch.cuda.device_count()} devices", make_device_mesh()))
    return out


def reset_launches():
    from minipath_tpu_torch.render import kernels

    kernels.trace_packets.launches = 0
    for mode in kernels.trace_packets_pt.launches:
        kernels.trace_packets_pt.launches[mode] = 0
    reset_q_launches()


def timed(fn):
    """``(result, seconds)`` of ``fn()``, host clock from a synchronised
    card to the result on the host."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def phase_sharded(bvh, big, parts, ref64, pt_warm, device, smi):
    """Phase 17: the sharded parity frame against ``render_frame`` (bit for
    bit in Sobol mode; by solid pixels over the quantized layout),
    ``render(mesh=)`` against ``render()`` in both modes, and the sharded
    path-traced frame against phase 7's. Returns the launches by path."""
    from minipath_tpu_torch import RenderSettings, Scene, render
    from minipath_tpu_torch.render.frame import render_frame
    from minipath_tpu_torch.render.wavefront import render_frame_pt

    t_phase = time.perf_counter()
    sampler, _ = frame_inputs(device, WIDTH, HEIGHT)
    by_path = {}
    seed = 20240917

    def parity(label, scene, stack, mesh=None):
        """Cold and warm Sobol frames, unsharded or over ``mesh``."""
        def run():
            return render_frame(scene, sampler, None, width=WIDTH, height=HEIGHT, spp=SPP, stack_size=stack,
                                sobol=True, strat_seed=seed, mesh=mesh).cpu().numpy()
        _, cold = timed(run)
        reset_launches()
        img, warm = timed(run)
        by_path[label] = {k: v for k, v in kernel_launch_counts().items() if v}
        return img, warm, cold

    for name, mesh in meshes(device):
        for layout, tree, scene in (("f32", bvh, bvh.kernel_scene(device)),
                                    ("quantized", big, big.quantized_scene(device))):
            single, t1, _ = parity(f"parity {layout}", scene, tree.recommended_stack_size)
            img, t4, cold = parity(f"sharded parity {layout} over {name}", scene, tree.recommended_stack_size, mesh)
            equal = np.array_equal(img, single)
            solid = (single[..., 3] == 1.0) & (img[..., 3] == 1.0)
            a, b = single[..., 0][solid], img[..., 0][solid]
            agree = float((np.abs(a - b) <= SOLID_ATOL + SOLID_RTOL * np.abs(b)).mean())
            launches = by_path[f"sharded parity {layout} over {name}"]
            text = (f"render_frame(mesh=) over {name}, {layout} layout ({tree.statistics()['triangles']} "
                    f"triangles), {WIDTH}x{HEIGHT} @ {SPP} spp Sobol on {smi}: warm {t4:.3f} s (cold {cold:.3f} s) "
                    f"against render_frame {t1:.3f} s | launches {launches} | bit for bit {equal}, solid pixels "
                    f"{solid.mean():.4f} of the frame, agreeing {agree:.6f}")
            if not launches or (layout == "f32" and not equal) or agree < SOLID_SHARE:
                raise AssertionError(f"the sharded parity frame disagrees with render_frame: {text}")
            log("17 sharded", text)

        settings = RenderSettings(TILE, SPP, (WIDTH, HEIGHT))
        for mode, cb in (("tile", lambda t, s: None), ("frame", None)):
            images, secs = [], []
            for label, kw in (("render()", dict(device=device)), (f"render(mesh={name})", dict(mesh=mesh))):
                for _ in range(2):  # cold, then warm
                    reset_launches()
                    p = render(Scene(bvh), bench_camera(), settings, None, cb, seed=7, **kw)
                    p.wait()
                    by_path[f"{label} {mode} mode"] = {k: v for k, v in kernel_launch_counts().items() if v}
                images.append(p.image())
                secs.append(p.elapsed())
            equal = np.array_equal(*images)
            text = (f"render() in {mode} mode, {WIDTH}x{HEIGHT} @ {SPP} spp: mesh {name} warm {secs[1]:.3f} s against "
                    f"{secs[0]:.3f} s unsharded | launches {by_path[f'render(mesh={name}) {mode} mode']} | "
                    f"array_equal {equal}")
            if not equal or not by_path[f"render(mesh={name}) {mode} mode"]:
                raise AssertionError(f"render(mesh=) differs from render(): {text}")
            log("17 sharded", text)

        scene, table, lights, tracer, shadow = parts
        pt_sampler, env = frame_inputs(device, PT_WIDTH, PT_HEIGHT)
        pt_kw = dict(width=PT_WIDTH, height=PT_HEIGHT, samples_per_packet=2, bounces=PT_BOUNCES, lights=lights,
                     shadow_tracer=shadow, nee_max_depth=1)
        def pt_frame(seed, samples_per_packet):
            gen = torch.Generator(device=device).manual_seed(seed)
            return render_frame_pt(tracer, scene, table, pt_sampler, gen, spp=PT_SPP, env=env, mesh=mesh,
                                   **dict(pt_kw, samples_per_packet=samples_per_packet)).cpu().numpy()

        # The same frame in chunks of 2 samples a shard: each shard's torch
        # ops then cover as many lanes as an unsharded 2-sample chunk's.
        img_wide, t_wide = timed(lambda: pt_frame(70, 2 * len(mesh)))
        reset_launches()
        img, warm = timed(lambda: pt_frame(71, 2))
        launches = by_path[f"sharded pt over {name}"] = {k: v for k, v in kernel_launch_counts().items() if v}
        # A second unsharded frame: how close independent samples come to
        # phase 7's, pixel by pixel.
        other, warm1 = render_pt(parts, device, PT_WIDTH, PT_HEIGHT, PT_SPP, 1, 2, seed=72)
        ref = ref64[..., :3].mean(axis=(0, 1))
        means, means_wide = img[..., :3].mean(axis=(0, 1)), img_wide[..., :3].mean(axis=(0, 1))
        rel = np.maximum(np.abs(means - ref), np.abs(means_wide - ref)) / ref
        within = float((np.abs(img[..., :3] - ref64[..., :3]) < SHARD_PIXEL_ATOL).mean())
        within1 = float((np.abs(other[..., :3] - ref64[..., :3]) < SHARD_PIXEL_ATOL).mean())
        text = (f"render_frame_pt(mesh=) over {name}, {PT_WIDTH}x{PT_HEIGHT} @ {PT_SPP} spp, {PT_BOUNCES} bounces, "
                f"NEE at depth 1: warm {warm:.3f} s in chunks of 2 samples, {t_wide:.3f} s in chunks of "
                f"{2 * len(mesh)}, against render_frame_pt {warm1:.3f} s (phase 7: {pt_warm:.3f} s) | launches "
                f"{launches} | channel means {np.round(means, 5).tolist()} and {np.round(means_wide, 5).tolist()} "
                f"against phase 7's {np.round(ref, 5).tolist()} (largest rel {rel.max():.3e}) | values within "
                f"{SHARD_PIXEL_ATOL} of phase 7's: sharded {within:.4f}, another unsharded frame {within1:.4f}")
        if (not np.isfinite(img).all() or not np.isfinite(img_wide).all() or rel.max() > SHARD_MEAN_RTOL
                or within < within1 - SHARD_SHARE_SLACK or not launches.get("K2 closest")
                or not launches.get("K2 anyhit")):
            raise AssertionError(f"the sharded path-traced frame disagrees with phase 7's: {text}")
        log("17 sharded", text)

        # Seed-matched: Sobol strata, no roulette; the shards trace the
        # unsharded frame's paths.
        sobol_kw = dict(pt_kw, sobol=True, shadow_rr=False, rr_start=PT_BOUNCES)
        a, b = (render_frame_pt(tracer, scene, table, pt_sampler, None, spp=SOBOL_SPP, env=env, strat_seed=seed,
                                mesh=m, **sobol_kw) for m in (mesh, None))
        close = float(((a - b).abs().amax(dim=-1) <= FRAME_PIXEL_ATOL).float().mean())
        rel = abs(a[..., :3].mean().item() - b[..., :3].mean().item()) / b[..., :3].mean().item()
        text = (f"Sobol {PT_WIDTH}x{PT_HEIGHT} @ {SOBOL_SPP} spp, no roulette, sharded over {name} against "
                f"render_frame_pt: bit for bit {torch.equal(a, b)}, pixels within {FRAME_PIXEL_ATOL} {close:.6f}, "
                f"means rel {rel:.2e}")
        if close < FRAME_PIXEL_SHARE or rel > FRAME_MEAN_RTOL:
            raise AssertionError(f"the seed-matched sharded frame disagrees: {text}")
        log("17 sharded", text)
    log("17 sharded", f"phase time {time.perf_counter() - t_phase:.1f} s")
    return by_path


def phase_adaptive(parts, pt_mean, device, smi):
    """Phase 18: ``render_frame_pt_adaptive`` at full width against phase 7's
    uniform frame, then the CLI's ``--adaptive`` and ``--devices``."""
    import warnings

    from minipath_tpu_torch.render import adaptive

    t_phase = time.perf_counter()
    scene, table, lights, tracer, shadow = parts
    sampler, env = frame_inputs(device, PT_WIDTH, PT_HEIGHT)
    rounds = []
    chunk_blocks = adaptive._chunk_blocks

    def counting(*args, **kw):
        rounds.append(args[6])  # live rays
        return chunk_blocks(*args, **kw)

    def frame(seed):
        rounds.clear()
        gen = torch.Generator(device=device).manual_seed(seed)
        img, spp_map = adaptive.render_frame_pt_adaptive(
            tracer, scene, table, sampler, gen, width=PT_WIDTH, height=PT_HEIGHT, spp=PT_SPP, bounces=PT_BOUNCES,
            env=env, pilot_spp=ADAPTIVE_PILOT, samples_per_packet=ADAPTIVE_CHUNK, lights=lights,
            shadow_tracer=shadow, nee_max_depth=1, return_spp_map=True,
        )
        return img.cpu().numpy(), spp_map.cpu().numpy()

    adaptive._chunk_blocks = counting
    try:
        _, cold = timed(lambda: frame(80))
        reset_launches()
        torch.cuda.reset_peak_memory_stats(device)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                (img, spp_map), warm = timed(lambda: frame(81))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    finally:
        adaptive._chunk_blocks = chunk_blocks
    launches = {k: v for k, v in kernel_launch_counts().items() if v}
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    mean = float(img[..., :3].mean())
    shift = (mean - pt_mean) / pt_mean
    n_rays = PT_WIDTH * PT_HEIGHT
    text = (f"render_frame_pt_adaptive {PT_WIDTH}x{PT_HEIGHT}, budget {PT_SPP} spp (pilot {ADAPTIVE_PILOT}, chunks "
            f"of {ADAPTIVE_CHUNK}), {PT_BOUNCES} bounces, NEE at depth 1 on {smi}: warm {warm:.3f} s (cold {cold:.3f} "
            f"s) | {len(rounds) - 1} rounds after the pilot, live rays per round from {max(rounds[1:])} down to "
            f"{min(rounds[1:])} | launches {launches} | host syncs {syncs} | peak device memory "
            f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB | spp map mean {spp_map.mean():.4f}, min "
            f"{spp_map.min():.0f}, max {spp_map.max():.0f} | image mean {mean:.5f} against phase 7's uniform "
            f"{pt_mean:.5f} (shift {shift:+.3e}) | {n_rays * PT_SPP / warm / 1e6:.2f} Mpaths/s")
    if (not np.isfinite(img).all() or abs(spp_map.mean() - PT_SPP) > ADAPTIVE_CHUNK
            or spp_map.min() < ADAPTIVE_PILOT + ADAPTIVE_CHUNK or abs(shift) > ADAPTIVE_MEAN_RTOL
            or not launches.get("K2 closest") or not launches.get("K2 anyhit")):
        raise AssertionError(f"the adaptive frame is off: {text}")
    log("18 adaptive", text)

    # The CLI's --adaptive and --devices, both at once; --devices beyond the
    # cards present must exit 2 before it builds anything.
    with tempfile.TemporaryDirectory() as tmp:
        base = [sys.executable, "-m", "minipath_tpu_torch.cli", "--scene", CLI_SCENE, "--integrator", "pt",
                "--width", "480", "--height", "270", "--no-stats"]
        on = ["--device", device.type]
        runs = {
            "--adaptive": (base + on + ["--adaptive", "--nee", "--spp", "16", "-o", f"{tmp}/adaptive.png"], 0),
            "--devices 0": (base + on + ["--devices", "0", "--spp", "8", "-o", f"{tmp}/devices.png"], 0),
            "--devices N+1": (base + ["--device", "cuda", "--devices", str(torch.cuda.device_count() + 1),
                                      "-o", f"{tmp}/none.png"], 2),
        }
        t0 = time.perf_counter()
        procs = {k: subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for k, (cmd, _) in runs.items()}
        for k, proc in procs.items():
            try:
                _, err = proc.communicate(timeout=600)
            finally:
                proc.kill()
            png = Path(runs[k][0][-1])
            want_rc = runs[k][1]
            if proc.returncode != want_rc or png.exists() != (want_rc == 0):
                raise AssertionError(f"CLI {k} exited {proc.returncode} (want {want_rc}):\n{err[-4000:]}")
            said = [ln for ln in err.splitlines() if ln.startswith(("path traced", "--devices"))]
            log("18 adaptive", f"CLI {k}: exit {proc.returncode} | {' '.join(said)}")
        log("18 adaptive", f"CLI runs {time.perf_counter() - t0:.1f} s; phase time {time.perf_counter() - t_phase:.1f} s")
    return launches


# Phase 19: the two-level tracer. (levels, rounds) of the wavefront's traces;
# the full-width frame's. Exact ties between triangles in two treelets may
# resolve apart, so hits are held by share; the Sobol frame by its values.
TWOLEVEL_CONFIGS, TWOLEVEL_FRAME = ((2, 1), (2, 2), (3, 2)), (2, 2)
# The frame through the two-level tracer traces half of phase 7's samples: at
# 64 it takes 4.7x phase 7's frame, about 16 s on an NVIDIA H100 80GB HBM3 at
# 700 W, and runs twice (cold and warm). So the script stays near ten minutes
# with phases 21-24.
TWOLEVEL_FRAME_SPP = 32
TWOLEVEL_SOBOL, TWOLEVEL_VALUE_SHARE = (960, 540, 8), 0.999


TWOLEVEL_PARTS = ("twolevel.broad_phase", "twolevel.plan", "twolevel.trace", "twolevel.merge", "twolevel.shade")


def profiled_split(fn, names, n_top=4):
    """One ``torch.profiler`` run of ``fn()``: the device milliseconds of the
    kernels launched inside each annotated range named in ``names``, summed
    by name, and the ``n_top`` kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from minipath_tpu_torch.utils.profiling import annotated_ms

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    split = dict.fromkeys(names, 0.0)
    for name, ms in annotated_ms(events, names, device=True):
        split[name] += ms
    by_kernel = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in names:
            by_kernel[e.name[:60]] = by_kernel.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:n_top]
    return {k.split(".")[-1]: round(v, 3) for k, v in split.items()}, [(k, round(v, 3)) for k, v in top]


def phase_twolevel(pt_bvh, parts, ref64, pt_warm, device, smi):
    """Phase 19: ``make_pt_tracer_twolevel`` (K2 with per-packet roots) on
    phase 6's bounce-1 wavefront against the flat tracer, then in place of
    the flat tracer in phase 7's frame. Returns the frame's launches."""
    import warnings

    from minipath_tpu_torch.render import kernels
    from minipath_tpu_torch.render.twolevel import build_treelets, make_pt_tracer_twolevel
    from minipath_tpu_torch.render.wavefront import render_frame_pt
    from minipath_tpu_torch.scene.bvh import links as L

    t_phase = time.perf_counter()
    scene, table, lights, flat_tracer, shadow = parts
    ss = pt_bvh.recommended_stack_size
    r9, _, live_rays = bounce1_wavefront(parts, device, torch.Generator(device=device).manual_seed(1))
    rays = r9.transpose(1, 2).reshape(-1, 9)
    o, d, inv = rays[:, 0:3], rays[:, 3:6], rays[:, 6:9]
    live = torch.full((1,), live_rays, dtype=torch.int32, device=device)
    ref = flat_tracer(scene, o, d, inv, live)
    flat_ms = cuda_ms(lambda: flat_tracer(scene, o, d, inv, live), 5)
    tracers = {}
    for levels, rounds in TWOLEVEL_CONFIGS:
        tl = build_treelets(pt_bvh.host_arrays, levels, device=device)
        n_leaves = int(((tl.links & L.COUNT_MASK) != 0).sum())
        two, _ = make_pt_tracer_twolevel(scene, tl, stack_size=ss, packet_size=PT_PACKET, rounds=rounds)
        tracers[levels, rounds] = two
        two(scene, o, d, inv, live)
        torch.cuda.synchronize()
        before = kernels.trace_packets_pt.launches["closest"]
        torch.cuda.set_sync_debug_mode("error")  # any host sync in the trace raises
        try:
            got = two(scene, o, d, inv, live)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        launches = kernels.trace_packets_pt.launches["closest"] - before
        ms = cuda_ms(lambda: two(scene, o, d, inv, live), 3)
        split, top = profiled_split(lambda: two(scene, o, d, inv, live), TWOLEVEL_PARTS)
        same = (got.tri == ref.tri)[:live_rays]
        match = same.float().mean().item()
        hit = same & (ref.tri[:live_rays] >= 0)
        t_rel = ((got.t[:live_rays] - ref.t[:live_rays]).abs() / ref.t[:live_rays].abs().clamp_min(1e-30))[hit]
        t_rel = t_rel.max().item()
        ovf = int(got.overflow)
        text = (f"levels {levels}, rounds {rounds}: {len(tl.links)} treelets, {n_leaves} of them leaves | "
                f"{live_rays} live rays of {rays.shape[0]}: tri match {match:.6f}, max t rel err {t_rel:.3g}, overflow "
                f"{ovf} | trace {ms:.3f} ms against the flat trace's {flat_ms:.3f} ms ({ms / flat_ms:.2f}x) on {smi} | "
                f"K2 closest-hit launches per trace {launches}, host syncs in a warm trace 0 | inner visits/ray "
                f"{int(got.inner_visits) / live_rays:.2f} (flat {int(ref.inner_visits.sum()) / live_rays:.2f}), leaf "
                f"tests/ray {int(got.leaf_tests) / live_rays:.2f} (flat {int(ref.leaf_tests.sum()) / live_rays:.2f}) | "
                f"profiled device ms by part {split} | top kernels {top}")
        if match < TRI_MATCH or t_rel > T_RTOL or ovf != 0 or launches != rounds + 1:
            raise AssertionError(f"the two-level trace disagrees with the flat one: {text}")
        log("19 two-level", text)

    # (b) Phase 7's frame with the two-level tracer in place of the flat one.
    two = tracers[TWOLEVEL_FRAME]
    two_parts = (scene, table, lights, two, shadow)
    _, cold = render_pt(two_parts, device, PT_WIDTH, PT_HEIGHT, TWOLEVEL_FRAME_SPP, 1, 2, seed=90)
    reset_launches()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            img, warm = render_pt(two_parts, device, PT_WIDTH, PT_HEIGHT, TWOLEVEL_FRAME_SPP, 1, 2, seed=91)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = {k: v for k, v in kernel_launch_counts().items() if v}
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    ref_means, means = ref64[..., :3].mean(axis=(0, 1)), img[..., :3].mean(axis=(0, 1))
    rel = np.abs(means - ref_means) / ref_means
    flat_warm = pt_warm * TWOLEVEL_FRAME_SPP / PT_SPP  # phase 7's frame at this frame's samples
    text = (f"render_frame_pt {PT_WIDTH}x{PT_HEIGHT} @ {TWOLEVEL_FRAME_SPP} spp, {PT_BOUNCES} bounces, NEE at depth 1, "
            f"through the two-level tracer (levels {TWOLEVEL_FRAME[0]}, rounds {TWOLEVEL_FRAME[1]}) on {smi}: warm "
            f"{warm:.3f} s (cold {cold:.3f} s) against {flat_warm:.3f} s, phase 7's {pt_warm:.3f} s for {PT_SPP} spp "
            f"scaled ({warm / flat_warm:.2f}x) | launches {launches} | "
            f"host syncs {syncs} | channel means {np.round(means, 5).tolist()} against phase 7's "
            f"{np.round(ref_means, 5).tolist()} (largest rel {rel.max():.3e})")
    if (not np.isfinite(img).all() or rel.max() > SHARD_MEAN_RTOL
            or launches.get("K2 closest") != TWOLEVEL_FRAME_SPP // 2 * PT_BOUNCES * (TWOLEVEL_FRAME[1] + 1)):
        raise AssertionError(f"the two-level frame disagrees with phase 7's: {text}")
    log("19 two-level", text)

    w, h, spp = TWOLEVEL_SOBOL
    sampler, env = frame_inputs(device, w, h)
    kw = dict(width=w, height=h, spp=spp, bounces=PT_BOUNCES, env=env, samples_per_packet=spp, lights=lights,
              shadow_tracer=shadow, nee_max_depth=1, sobol=True, shadow_rr=False, rr_start=PT_BOUNCES,
              strat_seed=20241017)
    a = render_frame_pt(two, scene, table, sampler, None, **kw)
    b = render_frame_pt(flat_tracer, scene, table, sampler, None, **kw)
    equal = (a == b).float().mean().item()
    text = (f"Sobol {w}x{h} @ {spp} spp, no roulette, two-level against flat: values equal {equal:.6f}, max abs "
            f"diff {(a - b).abs().max().item():.3g}, means {a[..., :3].mean().item():.6f} / "
            f"{b[..., :3].mean().item():.6f}")
    if equal < TWOLEVEL_VALUE_SHARE:
        raise AssertionError(f"the two-level Sobol frame differs from the flat one: {text}")
    log("19 two-level", text)
    log("19 two-level", f"phase time {time.perf_counter() - t_phase:.1f} s")
    return launches


# Phase 20: the path tracer's tools, each in a subprocess at its full size
# (convergence_pt with its top rung cut to 256 spp), and the JAX-era artifact
# whose keys each keeps. The megakernel's frame mean may differ from the
# wavefront's by Monte Carlo noise alone: 960x540 @ 8 spp is 4.1M paths, a
# standard error of the mean near 1e-3 per channel on the atrium.
TOOL_RUNS = (
    ("bench_pt", "BENCH_pt.json", []),
    ("isolate_qpt", "ISOLATE_QPT.json", []),
    ("profile_pt_headline", "PROFILE_PT.json", []),
    ("convergence_pt", "CONVERGENCE.json", ["480", "270", "256"]),
)
BENCH_PT_DELTA, TOOL_TIMEOUT_S = 0.01, 600


class ToolRun:
    """``python -m minipath_tpu_torch.tools.<name> --device cuda --out ...``
    started in a subprocess, its output going to files of a temporary
    directory; :meth:`result` waits for it."""

    def __init__(self, name, args=()):
        self.name = name
        self._tmp = tempfile.TemporaryDirectory()
        tmp = Path(self._tmp.name)
        self.out = tmp / f"{name}.json"
        self._streams = open(tmp / "stdout", "w+"), open(tmp / "stderr", "w+")
        cmd = [sys.executable, "-m", f"minipath_tpu_torch.tools.{name}", "--device", "cuda", "--out", str(self.out),
               *args]
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, cwd=REPO, stdout=self._streams[0], stderr=self._streams[1], text=True)

    def result(self, artifact, timeout=TOOL_TIMEOUT_S):
        """The tool must exit 0, print one JSON line with the keys of
        ``artifact`` (a file of the repository, or a tuple of keys) and write
        the same JSON. Returns ``(JSON, seconds)``."""
        try:
            rc = self.proc.wait(timeout=timeout)
            seconds = time.perf_counter() - self.t0
            stdout, stderr = (f.seek(0) or f.read() for f in self._streams)
            if rc != 0 or not self.out.exists():
                raise AssertionError(f"{self.name} exited {rc}:\n{stdout[-3000:]}\n{stderr[-4000:]}")
            got = json.loads(stdout.splitlines()[-1])
            want = json.loads((REPO / artifact).read_text()) if isinstance(artifact, str) else dict.fromkeys(artifact)
            missing = set(want) - set(got)
            if missing or json.loads(self.out.read_text()) != got:
                raise AssertionError(f"{self.name}: keys of {artifact} missing {sorted(missing)}, or --out differs")
        finally:
            self.close()
        return got, seconds

    def close(self):
        """Kills the tool if it still runs; removes its files."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        for f in self._streams:
            f.close()
        self._tmp.cleanup()


def run_tool(name, artifact, args=(), timeout=TOOL_TIMEOUT_S):
    """:class:`ToolRun` of ``name`` and its result."""
    return ToolRun(name, args).result(artifact, timeout)


def phase_tools(smi):
    """Phase 20: ``python -m minipath_tpu_torch.tools.<name> --device cuda
    --out ...`` for each tool: exit 0, the artifact's keys, the megakernel
    in agreement with the wavefront."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    for name, artifact, size in TOOL_RUNS:
        got, seconds = run_tool(name, artifact, size)
        if name == "bench_pt":
            head = {k: got[k] for k in ("value", "wavefront_mean_s", "megakernel_mean_s", "wavefront_vs_megakernel",
                                        "estimator_mean_delta", "nee_mean_s", "nee_capped_mean_s")}
            bad = got["estimator_mean_delta"] > BENCH_PT_DELTA
        elif name == "convergence_pt":
            head = {k: got[k] for k in ("rungs", "wavefront_top_s", "megakernel_top_s", "noise_floor_rmse",
                                        "megakernel_rmse_vs_wavefront", "estimators_agree",
                                        "stratification_gain")}
            bad = not got["estimators_agree"]
        elif name == "isolate_qpt":
            head = {k: v for k, v in got.items() if k not in ("workload", "device", "device_health")}
            bad = False
        else:
            head = {k: got[k] for k in ("frame_s", "fused_chunk_s", "chunk_boundary_s", "phase_ms",
                                        "unattributed_device_ms", "profiled_chunk_device_ms", "k2_closest_ms",
                                        "per_bounce", "trace_counters", "trace_achieved_gops",
                                        "trace_vpu_utilization", "trace_fp32_peak_share")}
            bad = not got["phase_ms"]["trace"] > 0
        text = f"{name} on {smi}: exit 0 in {seconds:.1f} s, keys of {artifact} present | {json.dumps(head)}"
        if bad:
            raise AssertionError(f"{name} fails its gate: {text}")
        log("20 tools", text)
        log("20 tools", f"{name} device_health {json.dumps(got.get('device_health'))}")
    log("20 tools", f"phase time {time.perf_counter() - t_phase:.1f} s")


# Phase 21: the NEE shadow sort. Sobol frames of the modes that only reorder
# the segments equal the "pos" frame bit for bit; "fromlight" traces each
# segment reversed, whose rounding may flip a grazing one.
SHADOW_SORTS = ("pos", "dir", "light", "fromlight")
SHADOW_SORT_SEED = 20261017
FROMLIGHT_SHARE, FROMLIGHT_ATOL, FROMLIGHT_MEAN_RTOL = 0.995, 1e-5, 1e-3
# The portable engine's t against K2's: T_RTOL plus this, on TRI_MATCH of the
# hits where both found the same triangle. Its torch ops on the card contract
# multiply-adds that K2 (-fmad=false) rounds one by one: a last-bit difference
# of terms of order 1, 2e-5 relative on a hit 2e-3 from a bounce ray's origin,
# and more on a triangle seen edge-on, whose t is ill-conditioned (3.5e-5
# relative at t = 2 on one of phase 6's 524,288 bounce-1 rays on an NVIDIA H100
# 80GB HBM3).
PORTABLE_T_ATOL = 1e-6


def phase_shadow_sort(parts, sets, pt_bvh, device, smi):
    """Phase 21: phase 7's NEE-capped frame under each ``shadow_sort`` mode
    (warm seconds, K2 any-hit ms by CUDA events around each launch); the
    same frame in Sobol mode, every mode against ``"pos"``; then the
    portable tracers against K2 on phase 6's bounce-1 and shadow sets.
    Returns the launches of the timed frames by mode."""
    from minipath_tpu_torch.render import kernels
    from minipath_tpu_torch.render import wavefront as W

    t_phase = time.perf_counter()
    scene, table, lights, tracer, shadow = parts
    events = []
    inner = W.trace_packets_pt

    def timed_k2(*a, anyhit=False, **kw):
        if not anyhit:
            return inner(*a, anyhit=anyhit, **kw)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*a, anyhit=anyhit, **kw)
        end.record()
        events.append((start, end))
        return out

    by_mode, frames = {}, {}
    W.trace_packets_pt = timed_k2
    try:
        for i, mode in enumerate(SHADOW_SORTS + ("pos",)):
            events.clear()
            reset_launches()
            img, warm = render_pt(parts, device, PT_WIDTH, PT_HEIGHT, PT_SPP, 1, 2, seed=21, shadow_sort=mode)
            torch.cuda.synchronize()
            anyhit_ms = sum(a.elapsed_time(b) for a, b in events)
            launches = {k: v for k, v in kernel_launch_counts().items() if v}
            by_mode.setdefault(mode, launches)
            frames.setdefault(mode, img)
            log("21 shadow_sort", f"{mode}{' (again)' if i == len(SHADOW_SORTS) else ''}: render_frame_pt "
                f"{PT_WIDTH}x{PT_HEIGHT} @ {PT_SPP} spp, NEE at depth 1, on {smi}: warm {warm:.3f} s | K2 any-hit "
                f"{anyhit_ms:.3f} ms in {len(events)} launches ({anyhit_ms / max(len(events), 1):.4f} ms each) | "
                f"launches {launches} | mean {img[..., :3].mean():.5f}, values equal to the first pos frame's "
                f"{(img == frames['pos']).mean():.6f}")
            if launches.get("K2 anyhit") != len(events) or not len(events):
                raise AssertionError(f"{mode}: {len(events)} timed any-hit launches against {launches}")
    finally:
        W.trace_packets_pt = inner

    sobol = {mode: render_pt(parts, device, PT_WIDTH, PT_HEIGHT, PT_SPP, 1, 2, seed=22, shadow_sort=mode, sobol=True,
                             strat_seed=SHADOW_SORT_SEED)[0] for mode in SHADOW_SORTS}
    pos = sobol["pos"]
    for mode in SHADOW_SORTS[1:]:
        img = sobol[mode]
        close = (np.abs(img - pos) <= FROMLIGHT_ATOL).all(axis=-1).mean()
        rel = np.abs(img[..., :3].mean(axis=(0, 1)) - pos[..., :3].mean(axis=(0, 1))) / pos[..., :3].mean(axis=(0, 1))
        text = (f"Sobol frame, {mode} against pos: values equal {(img == pos).mean():.6f}, pixels within "
                f"{FROMLIGHT_ATOL} {close:.6f}, channel means' largest rel diff {rel.max():.3e}")
        if mode == "fromlight":
            bad = close < FROMLIGHT_SHARE or rel.max() > FROMLIGHT_MEAN_RTOL
        else:
            bad = not np.array_equal(img, pos)
        if bad:
            raise AssertionError(f"shadow_sort={mode} changes the Sobol frame: {text}")
        log("21 shadow_sort", text)

    # The portable engine against K2: the bounce-1 set and the shadow set.
    ss = pt_bvh.recommended_stack_size
    arrays = pt_bvh.arrays(device)
    portable, _ = W.make_portable_tracer(arrays, stack_size=ss)
    portable_shadow, _ = W.make_portable_shadow_tracer(arrays, stack_size=ss)
    flat = sets["bounce"].transpose(1, 2).reshape(-1, 9)
    o, d, inv = flat[:, 0:3], flat[:, 3:6], flat[:, 6:9]
    got = tracer(scene, o, d, inv)
    (want, seconds) = timed(lambda: portable(arrays, o, d, inv))
    same = got.tri == want.tri
    hit = same & (want.tri >= 0)
    dt = (got.t - want.t).abs()[hit]
    t_rel = (dt / want.t.abs()[hit].clamp_min(1e-30)).max().item()
    t_share = (dt <= PORTABLE_T_ATOL + T_RTOL * want.t.abs()[hit]).float().mean().item()
    shadow9, live_s = sets["shadow"]
    sflat = shadow9.transpose(1, 2).reshape(-1, 9)
    occ = kernels.trace_packets_pt(scene, shadow9, stack_size=ss, t_max=W._SHADOW_T_MAX, live_packets=live_s,
                                   anyhit=True).tri.reshape(-1) >= 0
    occ_want, sh_seconds = timed(lambda: portable_shadow(arrays, sflat[:, 0:3], sflat[:, 3:6]))
    text = (f"portable engine against K2 on phase 6's {flat.shape[0]} bounce-1 rays: tri match "
            f"{same.float().mean().item():.6f}, t within {T_RTOL} rel + {PORTABLE_T_ATOL} on {t_share:.6f} of the "
            f"same hits (max rel err {t_rel:.3g}, max abs {dt.max().item():.3g}), overflow {int(want.overflow.sum())}, "
            f"{seconds:.2f} s | on its {sflat.shape[0]} shadow segments: occlusion equal "
            f"{torch.equal(occ, occ_want)} ({int((occ != occ_want).sum())} differ), occluded "
            f"{occ_want.float().mean().item():.4f}, {sh_seconds:.2f} s")
    if (same.float().mean().item() < TRI_MATCH or t_share < TRI_MATCH or int(want.overflow.sum())
            or not torch.equal(occ, occ_want)):
        raise AssertionError(f"the portable engine disagrees with K2: {text}")
    log("21 shadow_sort", text)
    log("21 shadow_sort", f"phase time {time.perf_counter() - t_phase:.1f} s")
    return by_mode


def phase_parity_big(smi):
    """Phase 22: ``tools.parity_big`` at full size; the tool's gates hold K3
    and K2 to the portable engine. Returns its launches."""
    got, seconds = run_tool("parity_big", "PARITY_BIG.json")
    head = {k: got[k] for k in ("triangle_count", "over_f32_budget", "ray_parity", "anyhit_parity")}
    head["frame_parity"] = {k: v for k, v in got["frame_parity"].items() if k not in ("workload", "timing_note")}
    head["f32"] = {k: v if k != "frame_parity" else {a: b for a, b in v.items() if a not in ("workload", "timing_note")}
                   for k, v in got["f32"].items()}
    if got["gates_failed"]:
        raise AssertionError(f"parity_big fails its gates {got['gates_failed']}: {head}")
    log("22 parity_big", f"on {smi}: exit 0 in {seconds:.1f} s, keys of PARITY_BIG.json present | {json.dumps(head)}")
    return got["kernel_launches"]


# Phase 23: the demos' scenes; the keys of demo_bigscene's JSON line.
HUGE_TRIANGLES, DEMO_LEAF_MAX = 5_000_000, 56
BIGSCENE_KEYS = ("metric", "value", "unit", "f32_layout_fits", "quantized_vmem_mb")


def phase_demos(device, smi):
    """Phase 23: ``tools.demo_bigscene`` and ``tools.demo_hugescene`` at full
    size (their gates: K3 against the portable engine on a small ray set,
    the two layouts' frames, the two path-traced frames); then K1, K2 and K3
    in full and lean mode on the 5M-triangle scene (from the tool's cache)
    against their plain versions on 524,288 rays each. Returns the tools'
    launches and the kernels' results."""
    from minipath_tpu_torch.render import kernels, kernels_q
    from minipath_tpu_torch.render.wavefront import make_pt_shadow_tracer, make_pt_tracer
    from minipath_tpu_torch.scene.materials import build_light_table, table_from_numpy
    from minipath_tpu_torch.tools import common

    t_phase = time.perf_counter()
    launches = {}
    for name, artifact in (("demo_bigscene", BIGSCENE_KEYS), ("demo_hugescene", "BENCH_huge.json")):
        got, seconds = run_tool(name, artifact)
        head = {k: v for k, v in got.items() if k not in ("note", "kernel_launches", "device")}
        if got["gates_failed"]:
            raise AssertionError(f"{name} fails its gates: {head}")
        log("23 demos", f"{name} on {smi}: exit 0 in {seconds:.1f} s | {json.dumps(head)}")
        launches[name] = got["kernel_launches"]

    t0 = time.perf_counter()
    huge = common.atrium(HUGE_TRIANGLES, materials=True, leaf_max=DEMO_LEAF_MAX)
    bvh, ss = huge.bvh, huge.bvh.recommended_stack_size
    if not huge.cached:
        raise AssertionError("demo_hugescene left no cached 5M-triangle atrium")
    log("23 demos", f"{bvh.build_result.triangle_count}-triangle atrium loaded from the cache in "
        f"{time.perf_counter() - t0:.1f} s (built in {huge.build_s:.1f} s), stack {ss}")
    gen = torch.Generator(device=device).manual_seed(0)
    part = dispatch_rays9(bench_camera().build_sampler((WIDTH, HEIGHT), device), device, gen)[:DISPATCH_SLICE]
    part = part.contiguous()
    results = {}

    def check(key, kernel, run, plain, compare_fn):
        got = run()
        torch.cuda.synchronize()
        want = plain()
        text, err = compare_fn(got, want)
        ms, plain_ms = cuda_ms(run, 10), cuda_ms(plain, 1)
        log("23 demos", f"5M scene, {key}: {text} | kernel {ms:.4f} ms, plain {plain_ms:.2f} ms")
        results.setdefault(kernel, {})[key] = dict(ms=ms, plain_ms=plain_ms, err=err)

    k1 = kernels.prepare_scene(bvh.arrays(device))
    check("K1 dispatch slice", "K1", lambda: kernels.trace_packets(k1, part, stack_size=ss),
          lambda: kernels.trace_packets_reference(k1, part, stack_size=ss),
          lambda g, w: compare("5M dispatch slice (K1)", g, w))
    del k1
    q = bvh.quantized_scene(device)
    check("K3 full dispatch slice", "K3", lambda: kernels_q.trace_packets_q(q, part, stack_size=ss),
          lambda: kernels_q.trace_packets_q_reference(q, part, stack_size=ss, t_max=math.inf, live_packets=None),
          lambda g, w: compare("5M dispatch slice (K3 full)", g, w))
    del part
    table = table_from_numpy(huge.material_fields, device)
    lights = build_light_table(bvh.host_arrays.tri_packets, bvh.host_arrays.tri_material, table)
    pt = kernels.prepare_scene_pt(bvh.arrays(device))
    parts = (pt, table, lights, make_pt_tracer(pt, stack_size=ss, packet_size=PT_PACKET)[0],
             make_pt_shadow_tracer(pt, stack_size=ss, packet_size=PT_PACKET)[0])
    r9, live_packets, _ = bounce1_wavefront(parts, device, torch.Generator(device=device).manual_seed(1))
    pick = torch.arange(PT_SET_PACKETS, device=device) * int(live_packets) // PT_SET_PACKETS
    bounce = r9[pick].contiguous()
    del r9
    check("K2 bounce-1 set", "K2", lambda: kernels.trace_packets_pt(pt, bounce, stack_size=ss),
          lambda: kernels.trace_packets_pt_reference(pt, bounce, stack_size=ss),
          lambda g, w: compare_pt("5M bounce-1 set (K2)", g, w))
    qpt = bvh.quantized_pt_scene(device)
    check("K3 lean bounce-1 set", "K3", lambda: kernels_q.trace_packets_q(qpt, bounce, stack_size=ss, lean=True),
          lambda: kernels_q.trace_packets_q_reference(qpt, bounce, stack_size=ss, lean=True, t_max=math.inf,
                                                      live_packets=None),
          lambda g, w: compare_pt("5M bounce-1 set (K3 lean)", g, w, kernel="K3"))
    log("23 demos", f"phase time {time.perf_counter() - t_phase:.1f} s")
    return launches, results


def phase_quality(smi):
    """Phase 24: ``tools.bench_quality`` at full size over K2; its gate holds
    K2's frame to the portable engine's. Returns its launches."""
    got, seconds = run_tool("bench_quality", "QUALITY.json")
    head = {k: v for k, v in got.items() if k not in ("kernel_launches", "device", "workload")}
    if got["gates_failed"]:
        raise AssertionError(f"bench_quality fails its gate: {head}")
    log("24 quality", f"bench_quality on {smi}: exit 0 in {seconds:.1f} s, keys of QUALITY.json present | "
        f"{json.dumps(head)}")
    return got["kernel_launches"]


# Phase 25: render(backend="portable") against render() on the atrium, at a
# size the portable engine (one host sync a traversal step) renders in about
# a second. The two engines share no traversal code and agree on every
# triangle, but torch's CUDA ops contract the multiply-adds that K1
# (-fmad=false) rounds one by one: an RGB value may move by one 8-bit level,
# on at most PORTABLE_RGB_SHARE of the values; alpha must be equal.
PORTABLE_SIZE, PORTABLE_SPP, PORTABLE_SEED = (256, 144), 4, 25
PORTABLE_RGB_SHARE = 1e-3


def image_agreement(got: np.ndarray, want: np.ndarray) -> tuple[str, bool]:
    """Two uint8 RGBA images of one seed from two engines: ``(text, ok)``
    with ok where alpha is equal and RGB differs by at most one level on at
    most :data:`PORTABLE_RGB_SHARE` of the values."""
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    rgb_share = float((diff[..., :3] > 0).mean())
    ok = np.array_equal(got[..., 3], want[..., 3]) and int(diff[..., :3].max()) <= 1 and rgb_share <= PORTABLE_RGB_SHARE
    return (f"alpha equal {np.array_equal(got[..., 3], want[..., 3])}, RGB max diff {int(diff[..., :3].max())} levels "
            f"on {rgb_share:.6f} of the values, alpha coverage {float((want[..., 3] > 0).mean()):.4f}"), ok


def phase_portable(bvh, device, smi):
    """Phase 25: ``render(backend="portable")`` of the atrium against
    ``render()`` for the same seed, in frame and in tile mode, with both
    times and the launches (the portable engine launches no kernel); then
    the portable frame over a mesh of the card twice, bit for bit."""
    from minipath_tpu_torch import RenderSettings, Scene, render

    t_phase = time.perf_counter()
    settings = RenderSettings(TILE, PORTABLE_SPP, PORTABLE_SIZE)

    def run(backend, callback=None, mesh=None):
        reset_launches()
        p = render(Scene(bvh), bench_camera(), settings, finished_tile_callback=callback,
                   device=None if mesh else device, seed=PORTABLE_SEED, backend=backend, mesh=mesh)
        p.wait()
        return p.image(), p.elapsed(), {k: v for k, v in kernel_launch_counts().items() if v}

    images = {}
    for mode, callback in (("frame", None), ("tile", lambda tile, snapshot: None)):
        want, s_kernel, launches_kernel = run("kernel", callback)
        got, s_portable, launches_portable = run("portable", callback)
        images[mode] = got
        text, ok = image_agreement(got, want)
        text = (f"{mode} mode, {PORTABLE_SIZE[0]}x{PORTABLE_SIZE[1]} @ {PORTABLE_SPP} spp, 64-px tiles, on {smi}: "
                f"portable {s_portable:.3f} s (launches {launches_portable}) against kernel {s_kernel:.4f} s "
                f"(launches {launches_kernel}) | {text}")
        if not ok or launches_portable or not launches_kernel.get("K1"):
            raise AssertionError(f"render(backend='portable') disagrees with render(): {text}")
        log("25 portable", text)
    meshed, seconds, _ = run("portable", mesh=(device, device))
    if not np.array_equal(meshed, images["frame"]):
        raise AssertionError("render(backend='portable', mesh=) differs from the meshless portable frame")
    log("25 portable", f"over a mesh of the card twice: equal to the meshless frame bit for bit, {seconds:.3f} s")
    log("25 portable", f"phase time {time.perf_counter() - t_phase:.1f} s")


# Phase 26: the sweeps and the tree tools, each in a subprocess at the JAX
# tool's size, except sweep_sbvh: its NumPy SBVH build takes minutes at 250k
# triangles, so it runs on SBVH_TRIANGLES here. Each: the keys its line must
# have, and where the JAX-era artifact has rows, (file, path to the rows)
# whose keys its rows must have.
SBVH_TRIANGLES = 60_000
# Their time goes to NumPy builds on the host (the Python and SBVH trees):
# they run beside the others, and their device times overlap other tools'.
BESIDE = ("tree_quality", "sweep_sbvh")
SOBOL_COST_KEYS = ("stratified_s_per_frame", "stratified_frame_mean", "sobol_s_per_frame", "sobol_frame_mean",
                   "cost_ratio_sobol_over_stratified", "workload")
SWEEP_TOOLS = (
    ("sweep_rr2", ("nee_capped",), ("SWEEP_RR.json", ("nee_capped", "rows")), []),
    ("sweep_pt17", "SWEEP_NEE_CAP2.json", ("SWEEP_NEE_CAP2.json", ("rows",)), []),
    ("sweep_pt19", "SWEEP_NEE_CAP2.json", ("SWEEP_NEE_CAP2.json", ("rows",)), []),
    ("sobol_cost", SOBOL_COST_KEYS, None, []),
    ("sweep_adaptive", ("reference_spp", "adaptive"), ("QUALITY.json", ("adaptive",)), []),
    ("perf_leaf", ("rays", "rows"), None, []),
    ("tree_quality", ("rows",), None, []),
    ("sweep_sbvh", ("trees", "rows"), None, [str(SBVH_TRIANGLES)]),
)


def dig(obj, path):
    for key in path:
        obj = obj[key]
    return obj


def phase_sweeps(smi):
    """Phase 26: each of :data:`SWEEP_TOOLS` in a subprocess: exit 0 (each
    enforces its own gates), the keys of its artifact and of its rows.
    Returns the tools' kernel launches by tool."""
    t_phase = time.perf_counter()
    launches = {}
    beside = {name: ToolRun(name, args) for name, _, _, args in SWEEP_TOOLS if name in BESIDE}
    try:
        for name, keys, rows, args in SWEEP_TOOLS:
            got, seconds = beside[name].result(keys) if name in beside else run_tool(name, keys, args)
            check_sweep(name, got, rows)
            head = {k: v for k, v in got.items() if k not in ("device", "kernel_launches", "gates_failed")}
            log("26 sweeps", f"{name} {' '.join(args)} on {smi}: exit 0 in {seconds:.1f} s"
                f"{' (beside the others)' if name in beside else ''} | {json.dumps(head)}")
            launches[name] = got.get("kernel_launches", {})
    finally:
        for run in beside.values():
            run.close()
    log("26 sweeps", f"phase time {time.perf_counter() - t_phase:.1f} s")
    return launches


def check_sweep(name, got, rows):
    """A sweep tool's rows have the keys of its artifact's; no gate failed."""
    if rows is not None:
        artifact, path = rows
        missing = set(dig(json.loads((REPO / artifact).read_text()), path)[0]) - set(dig(got, path)[0])
        if missing:
            raise AssertionError(f"{name}: its rows lack {sorted(missing)} of {artifact}'s")
    if got["gates_failed"]:
        raise AssertionError(f"{name} fails its gates: {got['gates_failed']}")


# Phase 13: the chain kernels' checks and shapes. K4 at the device-health
# probe's shape; K5 at the bf16 tool's default and at a card-filling shape.
CHAIN_CHECK_ITERS = (1, 7, 64, 65536)
K5_SHAPES = {"default": ((256, 128), 256), "card-filling": ((16384, 128), 4096)}
# One element and iteration of the chain executes two multiplies and a min and
# a max (``a * 0.5`` is hoisted), and the SASS holds them as FMUL and FMNMX
# (f32) or HMUL2/HFMA2 and HMNMX2 (bf16x2, two elements a lane). Results per
# clock and SM on compute capability 9.0 (the CUDA C++ Programming Guide's
# throughput table): 128 for a float32 multiply, 64 for compare, minimum and
# maximum; 256 for a 16-bit multiply. No rate is listed for HMNMX2: taken as
# twice FMNMX's, two results a lane.
CHAIN_MULS, CHAIN_MINMAX, SMS = 2, 2, 132
CHAIN_RATES = {torch.float32: (128, 64), torch.bfloat16: (256, 128)}  # (multiply, min/max)
BENCH_BUDGET_S, BENCH_TIMEOUT_S = 420, 600
# The last line of the JAX bench (bench.py:587-611), all rungs run.
JAX_BENCH_KEYS = [
    "metric", "value", "unit", "vs_baseline", "pt_wavefront_mpaths_per_s", "pt_nee_mpaths_per_s",
    "pt_nee_capped_mpaths_per_s", "pt_1080p64_wavefront_s", "pt_1080p64_wavefront_mpaths_per_s",
    "pt_1080p64_nee_capped_s", "pt_1080p64_nee_capped_mpaths_per_s", "pt_big_scene_mpaths_per_s",
]


def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def chain_bound(shape, iters, dtype, clock_hz):
    """The least time of one chain call, as ``(ms, "operations" or
    "bytes", text)``: its multiplies and min/max at the card's documented
    rates for them at the maximum SM clock, against its input read once and
    its output written once over the HBM rate."""
    from minipath_tpu_torch.utils.roofline import PEAK_HBM_BYTES

    n = shape[0] * shape[1]
    mul_rate, minmax_rate = CHAIN_RATES[dtype]
    clocks = n * iters * (CHAIN_MULS / mul_rate + CHAIN_MINMAX / minmax_rate) / SMS
    lane_ops = n * iters * (CHAIN_MULS + CHAIN_MINMAX)
    nbytes = 2 * n * (4 if dtype == torch.float32 else 2)
    op_ms, byte_ms = clocks / clock_hz * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    by = "operations" if op_ms >= byte_ms else "bytes"
    text = (f"bound {max(op_ms, byte_ms):.5f} ms by {by} ({lane_ops / 1e9:.3f} G multiplies and min/max = "
            f"{op_ms:.5f} ms; {nbytes / 1e6:.3f} MB = {byte_ms:.5f} ms)")
    return max(op_ms, byte_ms), by, text


def check_chain(label, shape, dtype, iters, device, clock_hz, reps=20):
    """One chain kernel call against its plain version on the same input,
    bit for bit; returns its times and bound."""
    from minipath_tpu_torch.utils import calibrate

    x = calibrate.chain_input(shape, dtype, device)
    got = calibrate.vpu_chain(x, iters)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = calibrate.vpu_chain_reference(x, iters)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    equal = torch.equal(got.view(bits), want.view(bits))
    err = (got.float() - want.float()).abs().max().item()
    ms = cuda_ms(lambda: calibrate.vpu_chain(x, iters), reps)
    bound_ms, bound_by, bound = chain_bound(shape, iters, dtype, clock_hz)
    text = (f"{label} {str(dtype).removeprefix('torch.')} {shape} x {iters}: bit for bit {equal}, max abs err "
            f"{err:.3g}, kernel {ms:.5f} ms, plain {plain_ms:.2f} ms | {bound} | kernel at "
            f"{bound_ms / ms:.1%} of it")
    if not equal or not torch.isfinite(got.float()).all():
        raise AssertionError(f"the chain kernel disagrees with its plain version: {text}")
    log("13 chain", text)
    return dict(ms=ms, plain_ms=plain_ms, err=err, bound_ms=bound_ms, bound_by=bound_by)


def phase_chain(device, smi):
    """K4 and K5 against their plain version, then their main paths:
    ``device_health`` (K4) and the bf16 tool (K5), launches counted."""
    import contextlib
    import io

    from minipath_tpu_torch.tools import microbench_vpu_bf16 as tool
    from minipath_tpu_torch.utils import calibrate

    clock = max_sm_clock_hz()
    log("13 chain", f"max SM clock {clock / 1e9:.3f} GHz on {smi}")
    k4 = {n: check_chain("K4", calibrate.CHAIN_SHAPE, torch.float32, n, device, clock) for n in CHAIN_CHECK_ITERS}
    k5 = {}
    for key, (shape, iters) in K5_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            k5[key, dtype] = check_chain(f"K5 {key}", shape, dtype, iters, device, clock)
    for key in K5_SHAPES:
        f32, bf16 = k5[key, torch.float32]["ms"], k5[key, torch.bfloat16]["ms"]
        log("13 chain", f"K5 {key}: bf16 speedup over f32 {f32 / bf16:.3f}x")

    # The wrappers' host time a launch, beside one Path.resolve() (which the
    # library lookup avoids): what a launch costs where the kernel is short.
    x = calibrate.chain_input((256, 128), torch.float32, device)
    host_us = {}
    for name, fn in (("Path.resolve", calibrate._SOURCE.resolve), ("vpu_chain, 1 iteration",
                                                                    lambda: calibrate.vpu_chain(x, 1))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        host_us[name] = round((time.perf_counter() - t0) / 200 * 1e6, 2)
    log("13 chain", f"host microseconds a call: {json.dumps(host_us)}")

    calibrate.vpu_chain.launches.update(float32=0, bfloat16=0)
    health = calibrate.device_health("cuda")
    k4_launches = calibrate.vpu_chain.launches["float32"]
    missing = [k for k, v in health.items() if v is None]
    if missing or k4_launches == 0:
        raise AssertionError(f"device_health: null {missing}, K4 launches {k4_launches}: {health}")
    log("13 chain", f"device_health on {smi}: {json.dumps(health)} | K4 launches {k4_launches}")

    calibrate.vpu_chain.launches.update(float32=0, bfloat16=0)
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        rc = tool.main(["--device", "cuda"])
    k5_launches = dict(calibrate.vpu_chain.launches)
    if rc != 0 or min(k5_launches.values()) == 0:
        raise AssertionError(f"the bf16 tool exited {rc} with K5 launches {k5_launches}")
    log("13 chain", f"tool main: {' | '.join(said.getvalue().splitlines())} | K5 launches {k5_launches}")
    return k4, k4_launches, k5, k5_launches, health


def phase_bench(smi):
    """``python -m minipath_tpu_torch.bench --device cuda`` under a time
    budget: exit 0, every rung's line, the JAX bench's keys last."""
    from minipath_tpu_torch import bench

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        extra = Path(tmp) / "extra.json"
        cmd = [sys.executable, "-m", "minipath_tpu_torch.bench", "--device", "cuda", "--budget-s",
               str(BENCH_BUDGET_S), "--out", str(extra)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
        for line in lines:
            log("13 bench", json.dumps(line))
        rungs = [ln.get("rung") for ln in lines if "rung" in ln and "error" not in ln]
        want = [name for name, _ in bench.RUNGS]
        if proc.returncode != 0 or rungs != want or not lines or list(lines[-1]) != JAX_BENCH_KEYS:
            raise AssertionError(f"bench exited {proc.returncode}, rungs {rungs}:\n{proc.stderr[-4000:]}")
        artifact = json.loads(extra.read_text())
    log("13 bench", f"exit 0 in {seconds:.1f}s on {smi}, every rung's line, last line keys {list(lines[-1])}, "
        f"artifact keys {list(artifact)}")


# Phase 27: render()'s frame mode at tile sizes off the packet's 16 pixels, as
# (tile_size, (width, height), spp). Tile mode draws its jitter in dispatches
# of 64 tiles and frame mode in dispatches of up to 1024, so the two images are
# equal bit for bit only where a frame has at most 64 tiles (the 320x320 case);
# past that, tile mode's image is held to frame mode's by mean and coverage,
# and frame mode's to its own tiles written back at their extents on the host.
P3_CASES = ((40, (320, 320), 4), (40, (WIDTH, HEIGHT), 4), (24, (640, 360), 8))
P3_SEED, P3_TIMED_FRAMES = 27, 3
# PERF.md §5: the 1920x1080 @ 64 spp frame through render() at 64-px tiles,
# warm seconds before the placement's repair (NVIDIA H100 80GB HBM3, 700 W).
P3_PARENT_FRAME_S = 0.192


def parent_placement(frame, tiles_u8, origins):
    """Frame mode's placement before the repair, kept to be timed beside the
    repaired one: each tile's whole packet-rounded block at its origin."""
    _, th, tw, _ = tiles_u8.shape
    yy = origins[:, 1].long()[:, None, None] + torch.arange(th, device=frame.device)[None, :, None]
    xx = origins[:, 0].long()[:, None, None] + torch.arange(tw, device=frame.device)[None, None, :]
    frame[yy, xx] = tiles_u8


def tiles_on_host(tiles, blocks, width, height):
    """Each tile's block cropped to its own extent and written at its place,
    as tile mode writes a tile back."""
    img = np.zeros((height, width, 4), np.uint8)
    for tile, block in zip(tiles, blocks):
        (x0, y0), (x1, y1) = tile.min, tile.max
        img[y0:y1, x0:x1] = block[: y1 - y0, : x1 - x0]
    return img


def phase_p3(bvh, device, smi):
    """Phase 27: frame mode twice with one seed (equal bit for bit), its
    image against its own tiles placed on the host, tile mode once; the
    64-px frame's warm seconds beside §5's; the repaired placement's time
    beside the parent's on one batch of that frame."""
    from minipath_tpu_torch import RenderSettings, Scene, render
    from minipath_tpu_torch.render import machinery
    from minipath_tpu_torch.screen_block import ScreenBlock

    t_phase = time.perf_counter()
    finalize = machinery._finalize_u8

    def image(settings, callback=None, record=None):
        if record is not None:
            machinery._finalize_u8 = lambda acc, spp: record.append(finalize(acc, spp)) or record[-1]
        try:
            p = render(Scene(bvh), bench_camera(), settings, finished_tile_callback=callback, device=device,
                       seed=P3_SEED)
            p.wait()
        finally:
            machinery._finalize_u8 = finalize
        return p.image(), p.elapsed()

    for tile_size, (w, h), spp in P3_CASES:
        settings = RenderSettings(tile_size, spp, (w, h))
        blocks = []
        first, s_first = image(settings, record=blocks)
        second, s_second = image(settings)
        tiled, s_tiled = image(settings, lambda tile, snapshot: None)
        tiles = ScreenBlock.with_size((0, 0), (w, h)).tile_ordering(tile_size, rng=np.random.default_rng(P3_SEED))
        host = tiles_on_host(tiles, torch.cat(blocks).cpu().numpy(), w, h)
        same, as_host, as_tiled = (np.array_equal(first, x) for x in (second, host, tiled))
        means = [float(x[..., 0].mean()) / 255 for x in (first, tiled)]
        cover = [float((x[..., 3] > 0).mean()) for x in (first, tiled)]
        text = (f"{w}x{h} @ {spp} spp, tile_size {tile_size} ({len(tiles)} tiles, traced at "
                f"{machinery._round_up(tile_size, 16)} px) on {smi}: two frame-mode renders equal {same}, equal to "
                f"their tiles placed on the host {as_host}, to tile mode {as_tiled} | mean value {means[0]:.4f} "
                f"tile mode {means[1]:.4f}, coverage {cover[0]:.4f} / {cover[1]:.4f} | frame {s_first:.3f} "
                f"{s_second:.3f} s, tile mode {s_tiled:.3f} s")
        stat_ok = abs(means[1] - means[0]) <= STAT_RTOL * means[0] and abs(cover[1] - cover[0]) <= STAT_RTOL
        if not (same and as_host and cover[0] > 0 and (as_tiled if len(tiles) <= 64 else stat_ok)):
            raise AssertionError(f"frame mode off the packet size: {text}")
        log("27 p3", text)

    settings = RenderSettings(TILE, SPP, (WIDTH, HEIGHT))
    image(settings)
    warm = [image(settings)[1] for _ in range(P3_TIMED_FRAMES)]
    log("27 p3", f"frame mode at 64-px tiles, {WIDTH}x{HEIGHT} @ {SPP} spp on {smi}: warm "
        f"{' '.join(f'{s:.4f}' for s in warm)} s, against {P3_PARENT_FRAME_S} s before the repair (PERF.md §5)")

    # One batch of that frame, its 256 tiles of 64x64 px: the placement
    # alone, repaired against the parent's, on one frame buffer.
    k = machinery.MAX_RAYS_PER_DISPATCH // (TILE * TILE * machinery.SAMPLES_PER_PASS)
    tiles = ScreenBlock.with_size((0, 0), (WIDTH, HEIGHT)).tile_ordering(TILE, rng=np.random.default_rng(0))[:k]
    blocks = torch.randint(0, 256, (len(tiles), TILE, TILE, 4), dtype=torch.uint8, device=device)
    origins = torch.tensor(np.array([t.min for t in tiles], np.float32), device=device)
    frame = torch.zeros((HEIGHT + 1, WIDTH + 1, 4), dtype=torch.uint8, device=device)
    padded = torch.zeros((HEIGHT + TILE, WIDTH + TILE, 4), dtype=torch.uint8, device=device)
    repaired_ms = cuda_ms(lambda: machinery.place_tiles(frame, blocks, origins, TILE), 50)
    parent_ms = cuda_ms(lambda: parent_placement(padded, blocks, origins), 50)
    if not torch.equal(frame[:HEIGHT, :WIDTH], padded[:HEIGHT, :WIDTH]):
        raise AssertionError("at 64-px tiles the repaired placement differs from the parent's")
    log("27 p3", f"placement of {len(tiles)} tiles of {TILE}x{TILE} px: repaired {repaired_ms:.4f} ms, before the "
        f"repair {parent_ms:.4f} ms; equal images (CUDA events, {smi})")
    log("27 p3", f"phase time {time.perf_counter() - t_phase:.1f} s")


# Phase 28: the port installed from a wheel, its package read-only, in a
# subprocess that sees only the installation (and the interpreter's own
# packages). The rays its traversal kernels are held at, on make_atrium(0):
# the central 128x128 pixels of the benchmark view, one sample each, and as
# many rays inside the scene's box in uniform directions; K4 at the probe's
# (512, 128) for 64 iterations.
INSTALL_TIMEOUT_S, INSTALL_K4_ITERS = 600, 64
# Run by the installation's subprocess: loads this script by its path (so
# that nothing of the checkout lands on sys.path) and calls installed_check.
INSTALLED_LOADER = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
sys.exit(smoke.installed_check(*sys.argv[2:]))
"""


def installed_check(site, out) -> int:
    """Phase 28's subprocess: builds K1-K5's three libraries and the native
    library from the installed package's sources, checks that each lands in
    the user's cache, caches a scene through ``tools/common.py::cached_scene``
    and checks that it lands there too, launches K1, K3 (full) and K4 once
    each against their plain versions, and saves the native tree of
    ``make_atrium(0)`` to ``out/tree.npz``. Prints one JSON line last."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import minipath_tpu_torch
    from minipath_tpu_torch.camera import sample_rays
    from minipath_tpu_torch.geometry.ray import make_rays
    from minipath_tpu_torch.render import integrator, kernels, kernels_q
    from minipath_tpu_torch.scene import procedural
    from minipath_tpu_torch.scene.bvh import native
    from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh
    from minipath_tpu_torch.tools import common
    from minipath_tpu_torch.utils import calibrate, cuda_build

    package = Path(minipath_tpu_torch.__file__).parent
    cache = Path(os.environ["XDG_CACHE_HOME"]) / "minipath_tpu_torch"
    if package != Path(site) / "minipath_tpu_torch" or cuda_build.build_dir() != cache:
        raise AssertionError(f"the package at {package} builds into {cuda_build.build_dir()}")

    def build_native():
        t0 = time.perf_counter()
        native._load()
        return native.library_path(), time.perf_counter() - t0

    loaders = {"traverse.cu": kernels.load_library, "traverse_q.cu": kernels_q.load_library,
               "chain.cu": calibrate.load_library, "minipath_native.cpp": build_native}
    with ThreadPoolExecutor(len(loaders)) as pool:
        futures = {name: pool.submit(load) for name, load in loaders.items()}
        built = {name: f.result() for name, f in futures.items()}
    builds = {name: (r.path, r.build_seconds) if name.endswith(".cu") else r for name, r in built.items()}
    for name, (path, seconds) in builds.items():
        log("28 installed", f"{name}: built in {seconds:.2f} s into {path}")
        if path.parent != cache or not path.exists() or not seconds > 0:
            raise AssertionError(f"{name} was not built into {cache}: {path}")

    # A scene cached by the tools' builder goes to the user's cache, and
    # nothing new lands beside the package.
    site_before = sorted(p.name for p in Path(site).iterdir())
    scene_cache = cache / "bench_cache"
    first, again = (common.cached_scene("atrium", 0, materials=False, leaf_max=24) for _ in range(2))
    cached = sorted(p.name for p in scene_cache.iterdir())
    log("28 installed", f"cached_scene from the installation: {cached} in {scene_cache}; read back {again.cached}")
    if (cuda_build.bench_cache_dir() != scene_cache or first.cached or not again.cached
            or cached != ["atrium_0_plain_leaf24.npz"] or sorted(p.name for p in Path(site).iterdir()) != site_before):
        raise AssertionError(f"the installation cached its scene in {cuda_build.bench_cache_dir()}: {cached}")

    device = torch.device("cuda", 0)
    mesh = procedural.make_atrium(0)
    res = native.build_bvh_native(mesh)
    np.savez(Path(out) / "tree.npz", **res.arrays._asdict())
    bvh = TriangleBvh(res)
    stack = bvh.recommended_stack_size
    sampler = bench_camera().build_sampler((WIDTH, HEIGHT), device)
    pix = integrator.tile_pixel_packets((WIDTH // 2 - 64, HEIGHT // 2 - 64), (128, 128), (16, 16), device)
    coherent = kernels.rays_to_rays9(sample_rays(sampler, pix, torch.Generator(device=device).manual_seed(0)))
    rng = np.random.default_rng(1)
    lo, hi = res.arrays.bbox_min, res.arrays.bbox_max
    o = torch.from_numpy(rng.uniform(lo + 0.5, hi - 0.5, (64, 256, 3)).astype(np.float32)).to(device)
    d = torch.from_numpy(rng.normal(size=(64, 256, 3)).astype(np.float32)).to(device)
    r9 = torch.cat([coherent, kernels.rays_to_rays9(make_rays(o, d))])
    reset_launches()
    scene, q = bvh.kernel_scene(device), bvh.quantized_scene(device)
    k1, _ = compare("K1 from the installation", kernels.trace_packets(scene, r9, stack_size=stack),
                    kernels.trace_packets_reference(scene, r9, stack_size=stack))
    k3, _ = compare("K3 full from the installation", kernels_q.trace_packets_q(q, r9, stack_size=stack),
                    kernels_q.trace_packets_q_reference(q, r9, stack_size=stack))
    x = calibrate.chain_input(calibrate.CHAIN_SHAPE, torch.float32, device)
    calibrate.vpu_chain.launches.update(float32=0, bfloat16=0)
    got, want = calibrate.vpu_chain(x, INSTALL_K4_ITERS), calibrate.vpu_chain_reference(x, INSTALL_K4_ITERS)
    k4 = torch.equal(got.view(torch.int32), want.view(torch.int32))
    launches = {"K1": kernels.trace_packets.launches, "K3": kernels_q.trace_packets_q.launches["full"],
                "K4": calibrate.vpu_chain.launches["float32"]}
    log("28 installed", f"{k1} | {k3} | K4 {tuple(x.shape)} x {INSTALL_K4_ITERS} bit for bit {k4} | launches "
        f"{json.dumps(launches)}")
    if not k4 or min(launches.values()) != 1:
        raise AssertionError(f"K4 equal {k4}, launches {launches}")
    print(json.dumps({"build_seconds": {name: seconds for name, (_, seconds) in builds.items()}}), flush=True)
    return 0


def phase_installed(smi):
    """Phase 28: builds a wheel of this checkout offline, installs it with
    ``--target`` into a temporary directory, makes the package read-only,
    runs :func:`installed_check` there with the working directory, ``HOME``
    and ``XDG_CACHE_HOME`` in temporary directories, and holds its native
    tree to the checkout's."""
    import shutil
    import stat

    from minipath_tpu_torch.scene import procedural
    from minipath_tpu_torch.scene.bvh import native

    t_phase = time.perf_counter()
    try:
        import setuptools  # noqa: F401
    except ImportError:
        raise AssertionError("phase 28 builds the wheel with the interpreter's setuptools "
                             "(pip wheel --no-build-isolation), and this Python has none") from None
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        src, dist, site = tmp / "src", tmp / "dist", tmp / "site"
        src.mkdir()
        shutil.copy(REPO / "pyproject.toml", src)
        for pkg in ("minipath_tpu", "minipath_tpu_torch"):
            shutil.copytree(REPO / pkg, src / pkg, ignore=shutil.ignore_patterns("__pycache__", "_build", "*.pyc"))
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        pip = [sys.executable, "-m", "pip", "-q", "--no-deps", "--no-index", "--no-cache-dir"]
        t0 = time.perf_counter()
        subprocess.run([*pip[:3], "wheel", *pip[3:], "--no-build-isolation", "-w", str(dist), str(src)],
                       check=True, env=env, timeout=300)
        (wheel,) = dist.glob("*.whl")
        subprocess.run([*pip[:3], "install", *pip[3:], "--target", str(site), str(wheel)], check=True, env=env,
                       timeout=300)
        package = site / "minipath_tpu_torch"
        for p in (package, *package.rglob("*")):
            p.chmod(p.stat().st_mode & ~(stat.S_IWUSR | stat.S_IWGRP | stat.S_IWOTH))
        log("28 installed", f"{wheel.name} built and installed in {time.perf_counter() - t0:.1f} s; package "
            f"read-only")
        for d in ("cache", "home", "cwd"):
            (tmp / d).mkdir()
        env.update(PYTHONPATH=str(site), HOME=str(tmp / "home"), XDG_CACHE_HOME=str(tmp / "cache"),
                   PYTHONDONTWRITEBYTECODE="1")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", INSTALLED_LOADER, str(REPO / "chip_smoke.py"), str(site),
                               str(tmp)], cwd=tmp / "cwd", env=env, capture_output=True, text=True,
                              timeout=INSTALL_TIMEOUT_S)
        for line in proc.stdout.splitlines()[:-1]:
            print(line, flush=True)
        if proc.returncode != 0:
            raise AssertionError(f"the installation's check exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-4000:]}")
        builds = json.loads(proc.stdout.splitlines()[-1])["build_seconds"]
        want = native.build_bvh_native(procedural.make_atrium(0)).arrays
        with np.load(tmp / "tree.npz") as got:
            differ = [f for f in want._fields if not np.array_equal(got[f], np.asarray(getattr(want, f)))]
        for p in (package, *package.rglob("*")):
            p.chmod(p.stat().st_mode | stat.S_IWUSR)
    if differ:
        raise AssertionError(f"the installation's native tree differs from the checkout's in {differ}")
    log("28 installed", f"on {smi}: build seconds {json.dumps({k: round(v, 2) for k, v in builds.items()})}; the "
        f"native tree of make_atrium(0) equals the checkout's; subprocess {time.perf_counter() - t0:.1f} s")
    log("28 installed", f"phase time {time.perf_counter() - t_phase:.1f} s")


def profile_pt_frame(parts, device, out_dir: Path, name="pt"):
    """A ``torch.profiler`` trace of one warm path-traced frame; writes the
    per-kernel table and a summary by kind to ``out_dir`` as
    ``profile_<name>.txt`` and ``profile_<name>.json``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, seconds = render_pt(parts, device, PT_WIDTH, PT_HEIGHT, PT_SPP, 1, 2, seed=4)
    kinds = {}
    intervals = []
    for evt in prof.events():
        if getattr(evt, "device_type", None) is None or "CUDA" not in str(evt.device_type):
            continue
        dur = evt.time_range.end - evt.time_range.start
        intervals.append((evt.time_range.start, evt.time_range.end))
        kernel = evt.name
        if "traverse_kernel<true, false>" in kernel:
            kind = "K2 closest-hit"
        elif "traverse_kernel<true, true>" in kernel:
            kind = "K2 any-hit"
        elif "traverse_q_kernel<true, false>" in kernel:
            kind = "K3 closest-hit"
        elif "traverse_q_kernel<true, true>" in kernel:
            kind = "K3 any-hit"
        elif "sort" in kernel.lower() or "radix" in kernel.lower() or "cub::" in kernel:
            kind = "sorts"
        elif "CatArray" in kernel:
            kind = "cat copies"
        elif "index" in kernel.lower() or "gather" in kernel.lower() or "scatter" in kernel.lower():
            kind = "gathers and scatters"
        elif "elementwise" in kernel.lower() or "vectorized" in kernel.lower() or "reduce" in kernel.lower():
            kind = "elementwise and reductions"
        elif "memcpy" in kernel.lower() or "memset" in kernel.lower():
            kind = "copies and fills"
        else:
            kind = "other"
        kinds[kind] = kinds.get(kind, 0.0) + dur
    busy = 0.0
    end = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    span = (max(b for _, b in intervals) - min(a for a, _ in intervals)) if intervals else 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60)
    (out_dir / f"profile_{name}.txt").write_text(table)
    summary = {
        "frame_s": seconds, "device_span_ms": span / 1e3, "device_busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / span if span else None,
        "by_kind_ms": {k: v / 1e3 for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])},
    }
    (out_dir / f"profile_{name}.json").write_text(json.dumps(summary, indent=1))
    log(f"profile {name}", json.dumps(summary))


def main() -> int:
    parser = argparse.ArgumentParser(description="Smoke test of minipath_tpu_torch on one NVIDIA GPU.")
    parser.add_argument("--profile", type=Path, default=None, metavar="DIR",
                        help="also profile one warm path-traced frame on each layout and write the summaries to DIR")
    parser.add_argument("--tworooms-only", action="store_true",
                        help="run phase 33 alone (the pt-tworooms-1080p64 cell's path: the shading and compaction "
                             "kernels against their plain versions, a frame's launches)")
    parser.add_argument("--kernels-only", action="store_true",
                        help="run phases 1, 2, 3, 31, 6, 29, 32, 34 and 10 alone (the traversal, camera, shading, "
                             "compaction and shadow-batch kernels against their plain versions, with their times); "
                             "prints neither the kernels line nor the last line")
    args = parser.parse_args()
    smi = phase_device()
    phase_build()
    if args.tworooms_only:
        phase_tworooms(torch.device("cuda", 0), smi)
        print("tworooms only: phase 33 passed", flush=True)
        return 0
    from minipath_tpu_torch.scene.procedural import make_atrium
    from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh

    device = torch.device("cuda", 0)
    mesh = make_atrium(250_000)

    def native_tree(**kw):
        t0 = time.perf_counter()
        tree = TriangleBvh.build(mesh, use_native=True, **kw)
        print(f"atrium, native build {kw or ''}: {tree.statistics()['inner_nodes']} inner nodes, stack "
              f"{tree.recommended_stack_size}, built in {time.perf_counter() - t0:.1f}s", flush=True)
        return tree

    t0 = time.perf_counter()
    bvh = TriangleBvh.build(mesh)
    stats = bvh.statistics()
    print(f"atrium: {stats['triangles']} triangles, {stats['inner_nodes']} inner nodes, "
          f"max depth {stats['max_depth']}, stack {bvh.recommended_stack_size}, "
          f"built in {time.perf_counter() - t0:.1f}s", flush=True)
    kernel = phase_kernel(bvh, device)
    camera, camera_launches = phase_camera(bvh, device, smi)
    if args.kernels_only:
        del bvh
        pt_bvh, dicts = build_pt_atrium()
        parts = pt_parts(pt_bvh, dicts, device)
        _, sets = phase_k2(pt_bvh, parts, device)
        phase_shade(parts, device, smi)
        phase_compact(parts, device, smi)
        phase_shadow(parts, device, smi)
        phase_k3(build_big_atrium(device), pt_bvh, parts[0], sets, device)
        print("kernels only: phases 1, 2, 3, 31, 6, 29, 32, 34 and 10 passed", flush=True)
        return 0
    # The CLI's tree (and phase 15's), and the bench's.
    cli_tree = native_tree()
    launches = phase_main_path(bvh, device, smi, (("the CLI's native-built tree, leaves <= 56", cli_tree),
                                                  ("the bench's native-built tree, leaves <= 24",
                                                   native_tree(leaf_max=24))))
    phase_cli()
    phase_portable(bvh, device, smi)

    pt_bvh, dicts = build_pt_atrium()
    parts = pt_parts(pt_bvh, dicts, device)
    k2, sets = phase_k2(pt_bvh, parts, device)
    k2_launches, shade_launches, compact_launches, ref64, pt_warm = phase_pt_main_path(parts, device, smi)
    shaded = phase_shade(parts, device, smi)
    compacted = phase_compact(parts, device, smi)
    tworooms_launches = phase_tworooms(device, smi)
    shadowed = phase_shadow(parts, device, smi)
    pt_mean = float(ref64[..., :3].mean())
    shadow_sort_launches = phase_shadow_sort(parts, sets, pt_bvh, device, smi)
    phase_card_vs_cpu(pt_bvh, dicts, device)
    phase_pt_cli()
    if args.profile is not None:
        profile_pt_frame(parts, device, args.profile)

    phase_denoise(pt_bvh, parts, ref64, device, smi)
    phase_denoise_cli()
    phase_gui(cli_tree, pt_bvh, dicts, device, smi)
    del cli_tree, mesh
    phase_sphere(device, smi)

    big = build_big_atrium(device)
    k3 = phase_k3(big, pt_bvh, parts[0], sets, device)
    del sets
    q_launches = phase_q_main_path(big, device, smi)
    q16_cell = phase_q16_cell(device, smi)
    for mode, n in phase_q_pt(big, pt_bvh, dicts, device, smi, pt_mean).items():
        q_launches[mode] += n
    if args.profile is not None:
        profile_pt_frame(pt_parts(pt_bvh, dicts, device, quantized=True), device, args.profile, name="pt_q")
    by_path = phase_sharded(bvh, big, parts, ref64, pt_warm, device, smi)
    by_path["q16-600k-1080p64 render()"] = q16_cell
    by_path["pt-tworooms-1080p64 render_frame_pt()"] = tworooms_launches
    by_path["adaptive pt"] = phase_adaptive(parts, pt_mean, device, smi)
    by_path["two-level pt"] = phase_twolevel(pt_bvh, parts, ref64, pt_warm, device, smi)
    del big, pt_bvh, parts, ref64
    k4, k4_launches, k5, k5_launches, _ = phase_chain(device, smi)
    phase_bench(smi)
    phase_tools(smi)
    for mode, counts in shadow_sort_launches.items():
        by_path[f"shadow_sort {mode}"] = counts
    by_path["parity_big"] = phase_parity_big(smi)
    demo_launches, huge = phase_demos(device, smi)
    by_path.update(demo_launches)
    by_path["bench_quality"] = phase_quality(smi)
    by_path.update(phase_sweeps(smi))
    phase_p3(bvh, device, smi)
    del bvh
    phase_installed(smi)

    def entry(name, source, replaces, launches, results, key, **extra):
        r = results[key]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "max_abs_err": max(x["err"] for x in results.values()), "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            # No PyTorch call traverses a BVH, no single call computes a
            # dependent chain, and none shades a bounce, makes camera rays
            # or compacts a path state.
            "library_ms": None,
            **extra,
        }

    def paths(kernel):
        """Phases 17-19, 21-24, 26 and 30's launches of one kernel, by path (the
        tools' as each subprocess counted them)."""
        out = {path: sum(n for k, n in counts.items() if k.split()[0] == kernel) for path, counts in by_path.items()}
        return {path: n for path, n in out.items() if n}

    chain = "minipath_tpu_torch/csrc/chain.cu"
    print(json.dumps({"kernels": [
        entry("traverse", "minipath_tpu_torch/csrc/traverse.cu", "minipath_tpu/render/pallas_kernels.py:165",
              launches, kernel, "dispatch slice", launches_by_path=paths("K1"), huge_scene=huge["K1"]),
        entry("traverse_pt", "minipath_tpu_torch/csrc/traverse.cu", "minipath_tpu/render/pallas_kernels.py:1375",
              k2_launches, k2, "bounce1", launches_by_path=paths("K2"), huge_scene=huge["K2"]),
        entry("traverse_q", "minipath_tpu_torch/csrc/traverse_q.cu", "minipath_tpu/render/pallas_kernels.py:650",
              sum(q_launches.values()), k3, "full", launches_by_mode=q_launches, launches_by_path=paths("K3"),
              huge_scene=huge["K3"]),
        entry("vpu_chain", chain, "minipath_tpu/utils/calibrate.py:44", k4_launches, k4, CHAIN_CHECK_ITERS[-1]),
        *(entry(f"chain_{short}", chain, "tools/microbench_vpu_bf16.py:24", k5_launches[str(dtype)[6:]],
                {key: r for (key, d), r in k5.items() if d == dtype}, "default",
                card_filling=k5["card-filling", dtype])
          for short, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))),
        # Port only: the JAX package leaves a bounce's shading to XLA.
        entry("bounce_shade", "minipath_tpu_torch/csrc/shade.cu", None, shade_launches, shaded, "bounce 0",
              frame=shaded["frame"], by_bounce={k: v for k, v in shaded.items() if k != "frame"}),
        # Port only: the JAX package leaves ray generation to XLA.
        entry("camera_rays", "minipath_tpu_torch/csrc/camera.cu", None, camera_launches, camera,
              "parity dispatch pass"),
        # Port only: the JAX package leaves the key and the gather to XLA.
        entry("compaction", "minipath_tpu_torch/csrc/compact.cu", None, compact_launches, compacted, "bounce 1",
              frame=compacted["frame"], by_bounce={k: v for k, v in compacted.items() if k != "frame"}),
        # Port only: the JAX package leaves the shadow batch's key, gathers
        # and scatter to XLA.
        entry("shadow_batch", "minipath_tpu_torch/csrc/shadow.cu", None, tworooms_launches["shadow box"], shadowed,
              "pt-tworooms-1080p64 bounce 1", by_batch=shadowed),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
