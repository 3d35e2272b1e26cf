"""The readers of the program's own spans and counters, on a synthetic
trace and a synthetic program record."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark import run
from benchmark.harness import profile, spans
from minipath_tpu_torch.utils.profiling import Record, Span

METRICS = Path(__file__).resolve().parents[1] / "metrics"
SHIFT_US = 1_234_567.0  # trace time minus program time
K2 = "void traverse_kernel<true, false>(TraceArgs)"


def _span(name, start_us, end_us, thread=1):
    """A span whose program stamps are ``SHIFT_US`` behind the trace's."""
    return Span(name, int((start_us - SHIFT_US) * 1e3), int((end_us - SHIFT_US) * 1e3), thread, 0, None, 0)


def _read(name, trace, rec, traced=1):
    ctx = SimpleNamespace(trace=trace, traced=[{}] * traced, cache={"program_record": rec})
    return run.load_module(METRICS / f"{name}.py").read(ctx)


def _parity():
    """Two dispatches: the caller's spans are ranges of the trace as well;
    the render thread's ray generation and write-back are not."""
    program = [
        _span("render.start", 0.0, 10.0), _span("render.wait", 10.0, 990.0), _span("render.image", 990.0, 1000.0),
        _span("render.ray_gen", 100.0, 200.0, 2), _span("render.ray_gen", 500.0, 600.0, 2),
        _span("render.write_back", 400.0, 480.0, 2), _span("render.write_back", 800.0, 900.0, 2),
    ]
    ranges = [(s.name, s.start_ns / 1e3 + SHIFT_US, s.end_ns / 1e3 + SHIFT_US) for s in program if s.thread == 1]
    device = [
        ("rand", 110.0, 30.0, 105.0), ("cat", 150.0, 40.0, 190.0),  # launched inside ray generation
        ("traverse_kernel<false, false>", 210.0, 150.0, 210.0),  # launched after it
        ("Memcpy DtoH", 360.0, 60.0, 355.0),  # runs into the first write-back: 20 us busy
        ("rand", 520.0, 10.0, 590.0), ("shade", 610.0, 20.0, None),  # a launch without a runtime call
    ]
    return profile.Trace(0.0, 1000.0, device, [], ranges), Record(program, {})


def test_the_anchor_offset_recovers_a_known_shift():
    trace, rec = _parity()
    assert spans.offset_us(trace, rec.spans) == pytest.approx(SHIFT_US)
    ctx = SimpleNamespace(trace=trace, cache={"program_record": rec})
    assert spans.mapped(ctx, "render.write_back") == [pytest.approx((400.0, 480.0)), pytest.approx((800.0, 900.0))]
    unpaired = profile.Trace(0.0, 1000.0, [], [], trace.ranges[:1] * 2)  # counts that differ pair nothing
    assert spans.offset_us(unpaired, rec.spans) is None


def test_work_launched_inside_a_mapped_span_counts_to_it():
    trace, rec = _parity()
    assert _read("tile_raygen_ms", trace, rec) == pytest.approx((30.0 + 40.0 + 10.0) / 1e3)
    assert _read("tile_raygen_ms", trace, rec, traced=2) == pytest.approx((30.0 + 40.0 + 10.0) / 2e3)


def test_idle_inside_the_write_back_is_only_where_no_device_activity_overlaps():
    trace, rec = _parity()
    # The first write-back (400-480) is busy until 420 with the copy; the
    # second (800-900) is idle throughout: 60 + 100 us of a 1000 us window.
    assert _read("writeback_idle_pct", trace, rec) == pytest.approx(16.0)
    assert spans.idle_inside_s(trace, [(-50.0, 5.0)]) == pytest.approx(5e-6)  # clipped to the window


def test_the_path_tracers_counters():
    trace = profile.Trace(0.0, 1e6, [(K2, 0.0, 2e5), ("glue", 2e5, 5e5)], [], [("pt.frame", SHIFT_US, SHIFT_US + 1e6)])
    rec = Record([_span("pt.frame", 0.0, 1e6)], {"pt.lanes": 4_000_000, "pt.live_lanes": 3_000_000,
                                                  "pt.shadow_rays": 1_000_000})
    assert _read("pt_live_pct", trace, rec) == pytest.approx(75.0)
    assert _read("k2_mrays_s", trace, rec) == pytest.approx(4e6 / 0.2 / 1e6)
    no_k2 = profile.Trace(0.0, 1e6, [("glue", 0.0, 5e5)], [], trace.ranges)
    assert _read("k2_mrays_s", no_k2, rec) is None


@pytest.mark.parametrize("name", ["tile_raygen_ms", "writeback_idle_pct", "pt_live_pct", "k2_mrays_s"])
def test_each_reader_reads_nothing_from_an_empty_record(name):
    trace, _ = _parity()
    assert _read(name, trace, None) is None
    assert _read(name, trace, Record([], {})) is None
    untraced = SimpleNamespace(trace=None, traced=[], cache={})
    assert run.load_module(METRICS / f"{name}.py").read(untraced) is None


def test_a_program_without_the_recorder_gives_no_record(monkeypatch):
    from minipath_tpu_torch.utils import profiling

    ctx = SimpleNamespace(trace=profile.Trace(0.0, 1.0, [], []), cache={})
    profiling.take()
    assert spans.record(ctx) is None  # nothing recorded
    monkeypatch.delattr(profiling, "take")
    assert spans.record(SimpleNamespace(trace=ctx.trace, cache={})) is None
