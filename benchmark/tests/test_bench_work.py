"""K1's work count is the reference's: the program's counters do not enter it."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import roofline, work
from benchmark.reference import atrium, bvh, parity, trace


def test_the_count_ignores_the_kernels_counters(monkeypatch):
    from minipath_tpu_torch.render import kernels

    m = atrium.make_atrium(3000)
    ref = trace.prepare(bvh.build_tree(m.positions, m.triangles), m.positions, m.triangles, "cpu")
    lens = parity.look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5), 8.0, 0.036)
    before = work.k1_work(ref, lens, (64, 48), rays=4096)
    real = kernels.trace_packets

    def zero_counters(*args, **kw):
        h = real(*args, **kw)
        z = torch.zeros_like(h.inner_visits)
        return h._replace(overflow=z, inner_visits=z, leaf_tests=z)

    monkeypatch.setattr(kernels, "trace_packets", zero_counters)
    assert work.k1_work(ref, lens, (64, 48), rays=4096) == before
    inner, leaf = before
    assert inner > 1 and leaf > 1


def test_the_least_time_is_the_larger_of_operations_and_bytes():
    ops_s, bytes_s = roofline.k1_least_seconds(10**8, 20.0, 10.0, 1000, 1000)
    slab_clocks = 12 / 128 + 13 / 64  # a box: subtractions and multiplies, then min/max and the compare
    lane_clocks = 45 / 128 + 5 / 64 + 1 / 16  # a lane: adds and multiplies, compares, the reciprocal
    assert ops_s == pytest.approx(10**8 * (20 * 8 * slab_clocks + 10 * 8 * lane_clocks) / (132 * 1.98e9))
    assert bytes_s == (1000 * 224 + 1000 * 608 + 10**8 * 60) / 3.35e12
    assert ops_s > bytes_s
