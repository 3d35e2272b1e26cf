"""Phase timing.

:class:`PhaseTimers` accumulates named wall-clock phases (built on the same
:class:`~minipath_tpu_torch.utils.stats.Stats` streaming accumulator the BVH
statistics use); the render thread records dispatch/fetch phases. PyTorch
returns before a CUDA device has finished, so a phase given a CUDA
``device`` synchronizes it before reading the clock: the phase then times
the device work it enqueued, not only the enqueue.
"""

from __future__ import annotations

import contextlib
import time

import torch

from minipath_tpu_torch.utils.stats import Stats


class PhaseTimers:
    """Accumulates wall-clock durations per named phase."""

    def __init__(self):
        self._stats: dict[str, Stats] = {}

    @contextlib.contextmanager
    def phase(self, name: str, device=None):
        """Time the enclosed block; with a CUDA ``device``, synchronize it
        at both ends so the phase holds exactly its own device work."""
        sync = device is not None and torch.device(device).type == "cuda"
        if sync:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                torch.cuda.synchronize(device)
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self._stats.setdefault(name, Stats()).add_sample(seconds)

    def stats(self, name: str) -> Stats:
        return self._stats.get(name, Stats())

    def total(self, name: str) -> float:
        return self._stats[name].total if name in self._stats else 0.0

    def summary(self) -> dict:
        return {
            name: {
                "count": s.count,
                "total_s": round(s.total, 6),
                "avg_ms": round(1e3 * s.avg, 3) if s.count else None,
                "max_ms": round(1e3 * s.max, 3) if s.count else None,
            }
            for name, s in sorted(self._stats.items())
        }

    def __str__(self) -> str:
        lines = []
        for name, s in sorted(self._stats.items()):
            lines.append(f"{name}: n={s.count} total={s.total:.3f}s avg={1e3*s.avg:.1f}ms")
        return "\n".join(lines) or "no phases recorded"
