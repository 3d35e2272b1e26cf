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
    ``build_pt_scene``, cached under ``.bench_cache/torch/``). Returns
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


class Atrium(NamedTuple):
    """A built atrium: the ``TriangleBvh``, its material table's fields
    (None without materials), the seconds its mesh and tree took to build,
    and whether it came from the cache."""

    bvh: object
    material_fields: dict | None
    build_s: float
    cached: bool


def atrium(n_triangles: int, *, materials: bool, leaf_max: int) -> Atrium:
    """``make_atrium(n_triangles)``, with ``atrium_materials`` or without,
    built by the native builder (the Python one where ``g++`` is missing)
    with leaves of up to ``leaf_max`` triangles, and cached uncompressed
    under ``.bench_cache/torch/`` (``bench.CACHE``): a second run loads it.
    The JAX package's tools build with ``leaf_max`` 24 (``parity_big``,
    ``bench_quality``) and 56 (the two demos)."""
    from minipath_tpu_torch import bench
    from minipath_tpu_torch.scene.bvh import native
    from minipath_tpu_torch.scene.bvh.build import BuildResult, build_bvh
    from minipath_tpu_torch.scene.materials import MaterialTable, material_table
    from minipath_tpu_torch.scene.procedural import atrium_materials, make_atrium
    from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh

    bench.CACHE.mkdir(parents=True, exist_ok=True)
    path = bench.CACHE / f"atrium_{n_triangles}_{'mats' if materials else 'plain'}_leaf{leaf_max}.npz"
    if path.exists():
        data = np.load(path)
        result = BuildResult(arrays=bench._arrays(data), triangle_count=int(data["meta_tris"]),
                             vertex_count=int(data["meta_verts"]), max_depth=int(data["meta_depth"]))
        fields = {f: data[f"mat_{f}"] for f in MaterialTable._fields} if materials else None
        log(f"loaded the cached {result.triangle_count}-triangle atrium from {path.name}")
        return Atrium(TriangleBvh(result), fields, float(data["meta_build_s"]), True)
    t0 = time.perf_counter()
    mesh = make_atrium(n_triangles)
    ids, dicts = atrium_materials(mesh) if materials else (None, None)
    build = native.build_bvh_native if native.is_available() else build_bvh
    result = build(mesh, materials=ids, leaf_max=leaf_max)
    build_s = time.perf_counter() - t0
    log(f"built the {result.triangle_count}-triangle atrium (leaves <= {leaf_max}) in {build_s:.1f}s")
    fields = {f: v.numpy() for f, v in material_table(dicts, "cpu")._asdict().items()} if materials else None
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **result.arrays._asdict(), **{f"mat_{f}": v for f, v in (fields or {}).items()},
             meta_tris=result.triangle_count, meta_verts=result.vertex_count, meta_depth=result.max_depth,
             meta_build_s=build_s)
    os.replace(tmp, path)
    return Atrium(TriangleBvh(result), fields, build_s, False)


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
