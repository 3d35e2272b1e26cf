"""The two-rooms cell on the CPU: a tiny cell of ``pt_frame_tworooms`` run
whole, sound and broken underneath, and the two readers of the shadow batch
on a traced tiny request.

The tiny cell's frame looks through the doorway from 4 m at 192 spp, so
that one frame, the window's only one, carries the check."""

from __future__ import annotations

import io
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from conftest import DATA, copy_benchmark
from test_bench_run import _pt_altered, _pt_half_batch

from benchmark import run
from benchmark.harness import profile, scene
from minipath_tpu_torch.utils.profiling import Record

ROOT = Path(__file__).resolve().parents[2]
METRICS = ROOT / "benchmark" / "metrics"
SEED = 2**31 + 2323
CELL = "tiny-tworooms"


@pytest.fixture
def tworooms_bench(tmp_path, monkeypatch):
    """The tiny benchmark with its two-rooms configuration and cell, in a
    temporary copy, its caches kept there too; the cell reports every
    metric the real cell reports, so that a traced run reads each of their
    readers against this driver's state."""
    monkeypatch.setattr(scene, "CACHE", tmp_path / "cache")
    bench = json.loads((DATA / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": CELL, "source": "https://github.com/bluecube/minipath",
                             "file": f"benchmark/configs/{CELL}.json", "reduced": ["triangles", "camera"],
                             "why": "tests"})
    bench["workloads"].append({"name": CELL, "config": CELL, "traffic": "pt_frame_tworooms-tiny", "chips": 1,
                               "why": "tests"})
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    for kind in ("end_to_end", "per_layer"):
        have = {m["name"]: m for m in bench[kind]}
        for m in real[kind]:
            if "pt-tworooms-1080p64" not in m.get("workloads", []):
                continue
            if m["name"] in have:
                have[m["name"]]["workloads"].append(CELL)
            else:
                bench[kind].append({**m, "workloads": [CELL]})
    return copy_benchmark(tmp_path, bench)


def _run(bench_path, trace=False):
    out, err = io.StringIO(), io.StringIO()
    rc = run.run(CELL, SEED, 0.3, trace, device=torch.device("cpu"), bench_path=bench_path, out=out, err=err)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


def test_the_tiny_cell_keeps_the_real_cells_limits():
    real = json.loads((ROOT / "benchmark" / "workloads" / "pt-tworooms-1080p64.json").read_text())
    tiny = json.loads((DATA / "workloads" / f"{CELL}.json").read_text())
    assert tiny["checks"] == real["checks"] and tiny["driver"] == real["driver"] == "pt_frame_tworooms"
    assert tiny["bounces"] == real["bounces"] == 7 and tiny["nee_depth"] is real["nee_depth"] is None


@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
def test_a_sound_run_is_correct(tworooms_bench, trace):
    rc, line, err = _run(tworooms_bench, trace)
    assert rc == 0 and line["correct"] is True, err
    assert line["attempted"] == 1 and set(line["checks"]) == {"mean_gap", "block_z2"}
    if trace:
        # Off the card no device time is traced: the device readers find
        # nothing; the counters are the program's.
        got = line["metrics"]
        assert not {"k2_ms", "pt_glue_ms", "pt_compaction_ms", "pt_shade_ms", "idle_pct.pt",
                    "pt_shadow_batch_ms"} & set(got)
        assert 0.0 < got["pt_unoccluded_pct"]["value"] < 100.0 and 0.0 < got["pt_live_pct"]["value"] <= 100.0
    else:
        assert {"setup_s", "mpaths_s"} <= set(line["metrics"])


def _nee_dropped_past_the_first_vertex(monkeypatch):
    """No light sample past the first vertex, with nothing reweighted: the
    emitter hits keep the MIS weight that assumed one."""
    from minipath_tpu_torch.render import wavefront

    real = wavefront._shade_plain

    def dropped(*args, bounce, **kw):
        state, query = real(*args, bounce=bounce, **kw)
        if query is not None and bounce >= 1:
            query = query._replace(cand=torch.zeros_like(query.cand))
        return state, query

    monkeypatch.setattr(wavefront, "_shade_plain", dropped)


@pytest.mark.parametrize("fault", [_nee_dropped_past_the_first_vertex, _pt_altered, _pt_half_batch])
def test_a_broken_timed_path_is_not_correct(tworooms_bench, monkeypatch, fault):
    fault(monkeypatch)
    rc, line, err = _run(tworooms_bench)
    assert rc == 0 and line["correct"] is False, err
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_the_shadow_readers_read_a_traced_request(tworooms_bench):
    """One traced request of the tiny cell: its ``pt.shadow_batch`` ranges
    (two a bounce of each chunk) and the program's counters. Device work
    launched inside the ranges counts to ``pt_shadow_batch_ms``, work
    launched outside them does not."""
    from minipath_tpu_torch.utils import profiling

    bench = json.loads(tworooms_bench.read_text())
    bdir = tworooms_bench.parent / "benchmark"
    params = json.loads((bdir / "workloads" / f"{CELL}.json").read_text())
    params["spp"] = 16  # two chunks
    config = json.loads((tworooms_bench.parent / bench["configs"][-1]["file"]).read_text())
    driver = run.load_module(bdir / "drivers" / "pt_frame_tworooms.py")
    state = driver.setup(config, params, SEED, torch.device("cpu"))
    profiling.take()
    with profile.profiled(tworooms_bench.parent / "trace.json") as got:
        with torch.profiler.record_function(profile.WINDOW):
            traced = [driver.request(state)]
    trace, rec = got[0], profiling.take()
    batches = [(s, e) for n, s, e in trace.ranges if n == "pt.shadow_batch"]
    assert len(batches) == 2 * 7 * 2
    device = [("gather", s, 10.0, (s + e) / 2) for s, e in batches] + [("k2", trace.start_us, 1e3, trace.start_us)]
    ctx = SimpleNamespace(trace=trace._replace(device=device), traced=traced, cache={"program_record": rec})

    def read(name, c=ctx):
        return run.load_module(METRICS / f"{name}.py").read(c)

    assert read("pt_shadow_batch_ms") == pytest.approx(len(batches) * 10.0 / 1e3)
    rays, blocked = rec.counters["pt.shadow_rays"], rec.counters["pt.shadow_occluded"]
    assert 0 < blocked < rays
    assert read("pt_unoccluded_pct") == pytest.approx(100.0 * (rays - blocked) / rays)
    # A program without the span or the counter (the parent of both) reads
    # nothing, and raises nothing.
    parent = SimpleNamespace(trace=trace._replace(device=device, ranges=[r for r in trace.ranges
                                                                         if r[0] != "pt.shadow_batch"]),
                             traced=traced, cache={"program_record": Record(rec.spans, {
                                 k: v for k, v in rec.counters.items() if k != "pt.shadow_occluded"})})
    assert read("pt_shadow_batch_ms", parent) is None and read("pt_unoccluded_pct", parent) is None
