"""The metric arithmetic on synthetic inputs."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import run
from benchmark.drivers import render_cli
from benchmark.harness import profile, stats

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def _read(name, **ctx):
    return run.load_module(METRICS / f"{name}.py").read(SimpleNamespace(**ctx))


def _frames(durations, rays=100e6):
    t, out = 0.0, []
    for d in durations:
        out.append({"start": t, "end": t + d, "rays": rays})
        t += d
    return out


def test_a_stalled_frame_lowers_the_rate():
    steady = _frames([0.2] * 10)
    stalled = _frames([0.2] * 9 + [1.2])
    rate = _read("mrays_s", records=steady, window_start=0.0, window_end=steady[-1]["end"])
    assert rate == pytest.approx(10 * 100 / 2.0)
    assert _read("mrays_s", records=stalled, window_start=0.0, window_end=stalled[-1]["end"]) < rate


def test_the_parity_statistics_on_frames_of_known_expectation():
    """Frames drawn around the reference's means read a pixel z2 near 1 and
    no gap; frames off by a few standard errors, or by a byte level over
    every pixel, read far higher."""
    rng = np.random.default_rng(5)
    n, paths, k = 4096, 128, 200
    mean = rng.uniform(0.2, 0.8, (n, 2))
    ref = rng.normal(mean[None], 0.3, (paths, n, 2))
    total, squares = ref.sum(axis=0), (ref * ref).sum(axis=0)
    sound = rng.normal(mean[None], 0.05, (k, n, 2))
    got = render_cli.compare(sound, total, squares, paths)
    assert 0.5 < got["pixel_z2"] < 1.5 and got["mean_gap"] < 2e-3
    off = render_cli.compare(sound + 4 * 0.3 / np.sqrt(paths), total, squares, paths)
    assert off["pixel_z2"] > 10 and off["mean_gap"] > 0.05
    level = render_cli.compare(sound + 1 / 255, total, squares, paths)
    assert level["mean_gap"] > 3 * got["mean_gap"]


def test_idle_is_the_share_outside_the_union_of_device_activity():
    tr = profile.Trace(0.0, 100.0, [("a", 10.0, 20.0), ("b", 20.0, 25.0), ("c", 70.0, 10.0)], [("host_op", 40.0, 30.0)])
    assert tr.busy_s() == pytest.approx(45e-6) and tr.window_s == pytest.approx(100e-6)
    assert stats.idle_pct(tr) == pytest.approx(55.0)
    b = profile.breakdown(tr)
    assert b["device_ops"][0] == ["b", pytest.approx(25e-6)]
    assert b["idle_gaps"] == [["host_op", pytest.approx(25e-6)], ["after host_op", pytest.approx(20e-6)],
                              ["host", pytest.approx(10e-6)]]
    assert stats.idle_pct(profile.Trace(0.0, 100.0, [], [])) is None


def test_device_ms_a_request_reads_only_what_matches():
    tr = profile.Trace(0.0, 1e6, [("void traverse_kernel<false, false>(TraceArgs)", 0.0, 4e3),
                                  ("elementwise", 5e3, 6e3)], [])
    ctx = SimpleNamespace(trace=tr, traced=[{}, {}])
    assert _read("k1_ms", **vars(ctx)) == pytest.approx(2.0)
    assert _read("tile_glue_ms", **vars(ctx)) == pytest.approx(3.0)
    none = SimpleNamespace(trace=profile.Trace(0.0, 1e6, [("elementwise", 0.0, 1.0)], []), traced=[{}])
    assert _read("k1_ms", **vars(none)) is None


def test_work_is_counted_to_the_range_its_launch_fell_in():
    tr = profile.Trace(0.0, 100.0, [("sort", 50.0, 5.0, 12.0), ("gather", 60.0, 7.0, 30.0), ("k", 70.0, 9.0, None)],
                       [], [("pt.compaction", 10.0, 20.0), ("pt.trace", 25.0, 40.0)])
    assert tr.ranged_s("pt.compaction") == pytest.approx(5e-6)
    ctx = SimpleNamespace(trace=tr, traced=[{}])
    assert _read("pt_compaction_ms", **vars(ctx)) == pytest.approx(5e-3)
