"""Streaming count/min/max/average accumulator.

Counterpart of ``minipath/src/util/stats.rs:4-62``; used by BVH health
statistics.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Stats:
    count: int = 0
    min: float = float("inf")
    max: float = float("-inf")
    total: float = 0.0

    @classmethod
    def new_single(cls, value: float) -> "Stats":
        return cls(count=1, min=value, max=value, total=value)

    def add_sample(self, value: float) -> None:
        self.count += 1
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        self.total += value

    def add_samples(self, values) -> None:
        """Vectorized :meth:`add_sample` over an array of values."""
        import numpy as np

        v = np.asarray(values, np.float64).ravel()
        if not v.size:
            return
        self.count += int(v.size)
        self.min = min(self.min, float(v.min()))
        self.max = max(self.max, float(v.max()))
        self.total += float(v.sum())

    def merge(self, other: "Stats") -> None:
        self.count += other.count
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        self.total += other.total

    @property
    def avg(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def __str__(self) -> str:
        if not self.count:
            return "no samples"
        return (
            f"min={self.min:g} max={self.max:g} avg={self.avg:g} (n={self.count})"
        )
