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
import sys
import time
from pathlib import Path

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
