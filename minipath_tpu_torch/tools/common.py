"""What the path tracer's tools share: the argument conventions, the scene,
the timing and the JSON output.

Every tool runs as ``python -m minipath_tpu_torch.tools.<name> [W H spp]
[--device {cuda,cpu}] [--out PATH]``, prints one JSON line on stdout
(progress goes to stderr) and writes a file only where ``--out`` names one.
``--device cuda`` without a card exits 2 before anything is built.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def parser(description: str, size_help: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda", help="torch device (default cuda)")
    p.add_argument("--out", type=Path, default=None, metavar="PATH", help="also write the JSON to PATH")
    p.add_argument("size", type=int, nargs="*", default=[], metavar="N", help=size_help)
    return p


def sizes(args, p: argparse.ArgumentParser, defaults: tuple) -> tuple:
    """The positional sizes, a prefix of them overriding ``defaults`` (the
    reference tools' ``sys.argv`` convention)."""
    if len(args.size) > len(defaults):
        p.error(f"at most {len(defaults)} sizes")
    return tuple(args.size) + tuple(defaults[len(args.size):])


def device_or_none(args) -> torch.device | None:
    """``args.device`` as a device, or None (after saying why) where it asks
    for a card and there is none: the caller exits 2."""
    if args.device == "cuda" and not torch.cuda.is_available():
        log("--device cuda: no CUDA device is available")
        return None
    return torch.device(args.device)


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)


def emit(out: dict, path: Path | None) -> None:
    """Print ``out`` as one JSON line; also write it to ``path`` if given."""
    text = json.dumps(out)
    if path is not None:
        Path(path).write_text(json.dumps(out, indent=2) + "\n")
        log(f"wrote {path}")
    print(text, flush=True)


def build_scene(device: torch.device):
    """The 250k-triangle atrium with its materials as the path tracer's tools
    trace it: the native builder, leaves of up to 24 triangles (the bench's
    ``build_pt_scene``, cached in ``bench_cache_dir()``). Returns
    ``(host BvhArrays, MaterialTable on device, stack size)``."""
    from minipath_tpu_torch import bench
    from minipath_tpu_torch.scene.materials import table_from_numpy

    arrays, fields, stack = bench.build_pt_scene()
    return arrays, table_from_numpy(fields, device), stack


def frame_seconds(frame, n: int, first_seed: int, label: str):
    """One warm-up ``frame(seed)`` (seed 0), then ``n`` timed ones, each
    ending with its result on the host; returns ``(times, last result)``."""
    t0 = time.perf_counter()
    frame(0)
    log(f"  {label} warmup: {time.perf_counter() - t0:.2f}s")
    times, value = [], None
    for i in range(n):
        t0 = time.perf_counter()
        value = frame(first_seed + i)
        times.append(time.perf_counter() - t0)
    return np.array(times), value


class DeviceTimer:
    """Milliseconds of the work enqueued between ``start()`` and ``stop()``:
    CUDA events on a card, the host clock on the CPU (where the work is done
    when the call returns)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            self._a, self._b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            self._a.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        if self.cuda:
            self._b.record()
            self._b.synchronize()
            return self._a.elapsed_time(self._b)
        return (time.perf_counter() - self._t0) * 1e3


class Built(NamedTuple):
    """A built procedural scene: the ``TriangleBvh``, its material table's
    fields (None without materials), the seconds its mesh and tree took to
    build, and whether it came from the cache."""

    bvh: object
    material_fields: dict | None
    build_s: float
    cached: bool


# Each procedural scene a tool builds: its mesh and its materials
# (``scene/procedural.py``).
SCENES = {"atrium": ("make_atrium", "atrium_materials"), "tworooms": ("make_tworooms", "tworooms_materials")}


def cached_scene(kind: str, n_triangles: int, *, materials: bool, leaf_max: int, builder: str = "native") -> Built:
    """``make_<kind>(n_triangles)`` of :data:`SCENES`, with its materials or
    without, built with leaves of up to ``leaf_max`` triangles by
    ``builder``: ``"native"`` (the C++ builder; the Python one where ``g++``
    is missing), ``"python"`` (the binned-SAH NumPy builder) or ``"sbvh"``
    (the NumPy builder with spatial splits); cached uncompressed in
    ``utils/cuda_build.py::bench_cache_dir()`` (``.bench_cache/torch/`` in a
    checkout, the user's cache in an installation): a second run loads it."""
    from minipath_tpu_torch import bench
    from minipath_tpu_torch.scene import procedural
    from minipath_tpu_torch.scene.bvh import native
    from minipath_tpu_torch.scene.bvh.build import BuildResult, build_bvh
    from minipath_tpu_torch.scene.materials import MaterialTable, material_table
    from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh
    from minipath_tpu_torch.utils import cuda_build

    make_mesh, make_materials = (getattr(procedural, f) for f in SCENES[kind])
    if builder not in ("native", "python", "sbvh"):
        raise ValueError(f"builder {builder!r}")
    tree = "" if builder == "native" else f"_{builder}"
    name = f"{kind}_{n_triangles}_{'mats' if materials else 'plain'}_leaf{leaf_max}{tree}.npz"
    path = cuda_build.bench_cache_dir() / name
    if path.exists():
        data = np.load(path)
        result = BuildResult(arrays=bench._arrays(data), triangle_count=int(data["meta_tris"]),
                             vertex_count=int(data["meta_verts"]), max_depth=int(data["meta_depth"]))
        fields = {f: data[f"mat_{f}"] for f in MaterialTable._fields} if materials else None
        log(f"loaded the cached {result.triangle_count}-triangle {kind} from {path.name}")
        return Built(TriangleBvh(result), fields, float(data["meta_build_s"]), True)
    t0 = time.perf_counter()
    mesh = make_mesh(n_triangles)
    ids, dicts = make_materials(mesh) if materials else (None, None)
    if builder == "native" and native.is_available():
        result = native.build_bvh_native(mesh, materials=ids, leaf_max=leaf_max)
    else:
        result = build_bvh(mesh, materials=ids, leaf_max=leaf_max, spatial_splits=builder == "sbvh")
    build_s = time.perf_counter() - t0
    log(f"built the {result.triangle_count}-triangle {kind} (leaves <= {leaf_max}, {builder} builder) in "
        f"{build_s:.1f}s")
    fields = {f: v.numpy() for f, v in material_table(dicts, "cpu")._asdict().items()} if materials else None
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **result.arrays._asdict(), **{f"mat_{f}": v for f, v in (fields or {}).items()},
             meta_tris=result.triangle_count, meta_verts=result.vertex_count, meta_depth=result.max_depth,
             meta_build_s=build_s)
    os.replace(tmp, path)
    return Built(TriangleBvh(result), fields, build_s, False)


def atrium(n_triangles: int, *, materials: bool, leaf_max: int, builder: str = "native") -> Built:
    """:func:`cached_scene` of ``make_atrium(n_triangles)``. The JAX
    package's tools build it with ``leaf_max`` 24 (``parity_big``,
    ``bench_quality``, the sweeps) and 56 (the two demos)."""
    return cached_scene("atrium", n_triangles, materials=materials, leaf_max=leaf_max, builder=builder)


def pt_tracers(bvh, device: torch.device, engine: str):
    """``(tracer, shadow_tracer, state)`` of ``engine`` over ``bvh`` on
    ``device``: ``"f32"`` (K2 over the f32 layout), ``"quantized"`` (K3 in
    lean mode over the quantized one) or ``"portable"`` (the portable
    engine, packets of 256). The layout is the one named, whatever the
    port's budget rule would pick; the kernels take packets of 2048."""
    from minipath_tpu_torch.render import wavefront as W
    from minipath_tpu_torch.render.kernels import check_material_ids, prepare_scene_pt

    stack, packet_size = bvh.recommended_stack_size, 2048
    if engine == "portable":
        state = bvh.arrays(device)
        make, make_shadow, packet_size = W.make_portable_tracer, W.make_portable_shadow_tracer, 256
    else:
        if engine == "quantized":
            state = bvh.quantized_pt_scene(device)
        else:
            check_material_ids(bvh.arrays(device).tri_material)
            state = prepare_scene_pt(bvh.arrays(device))
        make, make_shadow = W.make_pt_tracer, W.make_pt_shadow_tracer
    tracer, _ = make(state, stack_size=stack, packet_size=packet_size)
    shadow, _ = make_shadow(state, stack_size=stack, packet_size=packet_size)
    return tracer, shadow, state


def kernel_launches() -> dict:
    """Every traversal kernel's launches in this process so far, by kernel
    and mode (``K1``, ``K2 closest``, ``K2 anyhit``, ``K3 full``, ...); the
    plain versions on the CPU count none."""
    from minipath_tpu_torch.render import kernels, kernels_q

    return {"K1": kernels.trace_packets.launches,
            **{f"K2 {m}": n for m, n in kernels.trace_packets_pt.launches.items()},
            **{f"K3 {m}": n for m, n in kernels_q.trace_packets_q.launches.items()}}


# The Monte-Carlo sweeps (sweep_rr2, sweep_pt17, sweep_pt19, sobol_cost,
# sweep_adaptive): an unbiased row's frame mean must lie within MEAN_RTOL of
# its baseline row's, or, where the seeds' frame means spread more, within
# MEAN_SIGMAS standard errors of the difference (a heavy-tailed scene such as
# the two rooms moves a six-seed mean by about 0.5%).
MEAN_RTOL, MEAN_SIGMAS = 0.01, 4.0


class PTWorkload(NamedTuple):
    """A path-tracing scene on a device as the sweeps trace it: its
    ``PTScene``, material table, K2's closest-hit and shadow tracers (packets
    of 2048) and light table."""

    scene: object
    table: object
    tracer: object
    shadow: object
    lights: object


def pt_workload(arrays, table, stack: int, device: torch.device) -> PTWorkload:
    """:class:`PTWorkload` of host BVH ``arrays`` and a material ``table`` on
    ``device``."""
    from minipath_tpu_torch.render.kernels import prepare_scene_pt
    from minipath_tpu_torch.render.wavefront import make_pt_shadow_tracer, make_pt_tracer
    from minipath_tpu_torch.scene.bvh.build import from_numpy
    from minipath_tpu_torch.scene.materials import build_light_table

    scene = prepare_scene_pt(from_numpy(arrays._asdict(), device))
    tracer, _ = make_pt_tracer(scene, stack_size=stack, packet_size=2048)
    shadow, _ = make_pt_shadow_tracer(scene, stack_size=stack, packet_size=2048)
    return PTWorkload(scene, table, tracer, shadow, build_light_table(arrays.tri_packets, arrays.tri_material, table))


def pt_frame(w: PTWorkload, sampler, seed: int, *, width: int, height: int, spp: int, nee: bool, **kw):
    """``render_frame_pt`` of ``w`` as the JAX sweeps render it (every sample
    in one chunk, compaction; NEE where ``nee``) from generator seed
    ``seed``; ``kw`` goes to ``render_frame_pt``. Returns what it returns,
    on the device."""
    from minipath_tpu_torch.render.wavefront import render_frame_pt

    return render_frame_pt(
        w.tracer, w.scene, w.table, sampler, torch.Generator(device=sampler.device).manual_seed(seed), width=width,
        height=height, spp=spp, samples_per_packet=spp, compaction=True, lights=w.lights if nee else None,
        shadow_tracer=w.shadow if nee else None, **kw,
    )


def seed_sweep(frame, seeds: int, first_seed: int, label: str) -> dict:
    """The JAX sweeps' protocol: ``frame(0)`` as the warm-up, whose image
    counts, then ``seeds - 1`` timed frames from seeds ``first_seed``,
    ``first_seed + 1``, ...; ``frame(seed)`` returns the RGB image on the host.
    Returns the frame ``mean`` over every image, its ``mean_stderr`` (the
    spread of the images' means over the root of their count), ``var``, the
    per-pixel variance across the seeds averaged over pixels and channels,
    and ``s_per_frame``, the timed frames' mean seconds (each ends with its
    image on the host)."""
    t0 = time.perf_counter()
    images = [frame(0)]
    log(f"  {label} warmup: {time.perf_counter() - t0:.2f}s")
    times = []
    for i in range(seeds - 1):
        t0 = time.perf_counter()
        images.append(frame(first_seed + i))
        times.append(time.perf_counter() - t0)
    stack = np.stack(images)
    if not np.isfinite(stack).all():
        raise FloatingPointError(f"{label}: a frame is not finite")
    means = stack.reshape(seeds, -1).mean(axis=1, dtype=np.float64)
    return {"s_per_frame": float(np.mean(times)), "mean": float(means.mean()),
            "mean_stderr": float(means.std(ddof=1) / np.sqrt(seeds)) if seeds > 1 else 0.0,
            "var": float(stack.var(axis=0, dtype=np.float64).mean())}


def efficiency(row: dict) -> float:
    """Monte-Carlo efficiency 1 / (variance x seconds) of a :func:`seed_sweep`
    row."""
    return 1.0 / (row["var"] * row["s_per_frame"]) if row["var"] > 0 else float("inf")


def mean_gate(label: str, mean: float, base: float, failed: list, stderr: float = 0.0) -> None:
    """Appends to ``failed`` where ``mean`` lies further from ``base`` than
    :data:`MEAN_RTOL` of it and :data:`MEAN_SIGMAS` times ``stderr``, the
    standard error of their difference."""
    tol = max(MEAN_RTOL * abs(base), MEAN_SIGMAS * stderr)
    if not abs(mean - base) <= tol:
        failed.append(f"{label}: mean {mean:.6g} not within {tol:.3g} of the baseline's {base:.6g} "
                      f"({MEAN_RTOL:.0%}, or {MEAN_SIGMAS:g} standard errors {stderr:.3g})")


def row_gate(label: str, row: dict, base: dict, failed: list) -> None:
    """:func:`mean_gate` of two :func:`seed_sweep` rows."""
    mean_gate(label, row["mean"], base["mean"], failed, float(np.hypot(row["mean_stderr"], base["mean_stderr"])))


def host_rgb(img) -> np.ndarray:
    """A frame's RGB channels as a float32 NumPy array on the host."""
    return img[..., :3].cpu().numpy()


def finish(out: dict, path: Path | None) -> int:
    """:func:`emit` ``out``; returns the exit code: 1 where its
    ``gates_failed`` lists a gate, else 0."""
    emit(out, path)
    if out["gates_failed"]:
        log(f"gates failed: {out['gates_failed']}")
        return 1
    return 0


def caps(text: str) -> list[int | None]:
    """``--caps none,3,2,1``: NEE depth caps, ``none`` for no cap."""
    return [None if c == "none" else int(c) for c in text.split(",")]


def cap_sweep(w: PTWorkload, sampler, env, caps_: list, *, width: int, height: int, spp: int, bounces: int,
              seeds: int, failed: list) -> list[dict]:
    """The NEE depth-cap sweep of ``sweep_pt17`` and ``sweep_pt19``: for each
    cap, :func:`seed_sweep` of the NEE frame light-sampling the first ``cap``
    vertices, its efficiency over the first cap's and its mean's shift from
    the first cap's in percent.

    Every cap is unbiased, but at a fixed bounce budget the caps below it and
    the rest (none, or as many as the bounces) estimate two truncations: a
    cap below the budget leaves the last vertex's direct light out (its
    BSDF-sampled emitter hit is never traced), where NEE at the last vertex
    adds it (1.4% of the atrium's mean at 5 bounces). So the gate holds each
    row's mean to the first row's of its own kind."""
    rows = []
    for cap in caps_:
        def frame(seed):
            return host_rgb(pt_frame(w, sampler, seed, width=width, height=height, spp=spp, nee=True,
                                     bounces=bounces, env=env, nee_max_depth=cap))

        row = {"cap": cap, **seed_sweep(frame, seeds, 40, f"cap={cap}")}
        log(f"cap={cap}: {row['s_per_frame']:.3f}s/frame mean={row['mean']:.5f} var={row['var']:.4e}")
        rows.append(row)
    firsts = {}
    for r in rows:
        r["efficiency_vs_uncapped"] = efficiency(r) / efficiency(rows[0])
        r["mean_shift_pct"] = 100.0 * (r["mean"] - rows[0]["mean"]) / max(rows[0]["mean"], 1e-9)
        kind = r["cap"] is not None and r["cap"] < bounces
        row_gate(f"cap={r['cap']}", r, firsts.setdefault(kind, r), failed)
    return rows


# perf_leaf and sweep_sbvh: two trees of one mesh must agree on hit or miss
# for every ray, and on t within T_RTOL relative on T_SHARE of the hits (the
# triangle ids differ between trees).
T_RTOL, T_SHARE = 1e-5, 0.9999


def tree_agreement(label: str, hit, t, ref_hit, ref_t, failed: list) -> dict:
    """Hit or miss and ``t`` of one tree's trace against another's on the
    same rays (tensors of one shape); appends to ``failed`` past
    :data:`T_RTOL` and :data:`T_SHARE`."""
    both = hit & ref_hit
    rel = (t[both] - ref_t[both]).abs() / ref_t[both].abs().clamp_min(1e-30)
    out = {"hit_mismatch": int((hit != ref_hit).sum()),
           "t_within_share": float((rel <= T_RTOL).float().mean()) if rel.numel() else 1.0,
           "t_max_rel_diff": float(rel.max()) if rel.numel() else 0.0}
    if out["hit_mismatch"] or out["t_within_share"] < T_SHARE:
        failed.append(f"{label}: {out['hit_mismatch']} rays differ in hit or miss, t within {T_RTOL} relative on "
                      f"{out['t_within_share']:.6f} of the hits")
    return out
