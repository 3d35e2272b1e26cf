"""The path tracer's cell over the 16-bit layout on the CPU: a tiny cell of
``pt_frame_q16`` run whole, sound and broken underneath, and the readers of
K3's lean instances on a traced tiny request."""

from __future__ import annotations

import io
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from conftest import DATA, copy_benchmark
from test_bench_run import _pt_altered, _pt_half_batch, _pt_unchanged

from benchmark import run
from benchmark.harness import profile, scene
from minipath_tpu_torch.utils.profiling import Record

ROOT = Path(__file__).resolve().parents[2]
METRICS = ROOT / "benchmark" / "metrics"
SEED = 2**31 + 1625
CELL, REAL = "tiny-q16-pt", "pt-q16-600k-1080p64-nee1"


@pytest.fixture
def q16_pt_bench(tmp_path, monkeypatch):
    """The tiny benchmark with its q16 path-tracing configuration and cell,
    in a temporary copy, its caches kept there too; the cell reports every
    metric the real cell reports."""
    monkeypatch.setattr(scene, "CACHE", tmp_path / "cache")
    bench = json.loads((DATA / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": CELL, "source": "https://github.com/bluecube/minipath",
                             "file": f"benchmark/configs/{CELL}.json", "reduced": ["triangles"], "why": "tests"})
    bench["workloads"].append({"name": CELL, "config": CELL, "traffic": "pt_frame_q16-tiny", "chips": 1,
                               "why": "tests"})
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    for kind in ("end_to_end", "per_layer"):
        have = {m["name"]: m for m in bench[kind]}
        for m in real[kind]:
            if REAL not in m.get("workloads", []):
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
    real = json.loads((ROOT / "benchmark" / "workloads" / f"{REAL}.json").read_text())
    tiny = json.loads((DATA / "workloads" / f"{CELL}.json").read_text())
    assert tiny["checks"] == real["checks"] and tiny["driver"] == real["driver"] == "pt_frame_q16"
    assert (tiny["bounces"], tiny["nee_depth"]) == (real["bounces"], real["nee_depth"]) == (5, 1)
    pt = json.loads((ROOT / "benchmark" / "workloads" / "pt-1080p64-nee1.json").read_text())
    assert {k: v for k, v in real.items() if k not in ("driver", "checks")} == {
        k: v for k, v in pt.items() if k not in ("driver", "checks")}


@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
def test_a_sound_run_is_correct(q16_pt_bench, trace):
    rc, line, err = _run(q16_pt_bench, trace)
    assert rc == 0 and line["correct"] is True, err
    assert set(line["checks"]) == {"mean_gap", "block_z2", "vertex_ulps", "box_ulps", "box_fit_ulps"}
    got = line["metrics"]
    if trace:
        # Off the card no device time is traced: the device readers find
        # nothing; the counters are the program's.
        assert not {"k3pt_ms", "k3pt_mrays_s", "pt_glue_q_ms", "idle_pct.pt"} & set(got)
        assert 0.0 < got["pt_live_pct"]["value"] <= 100.0 and 0.0 < got["pt_unoccluded_pct"]["value"] < 100.0
    else:
        assert {"setup_s", "mpaths_s"} <= set(got)


def test_a_tree_without_the_quantized_pt_scene_fails_at_once(q16_pt_bench, monkeypatch):
    """Where the tree's lean scene is not the quantized one, set-up raises
    before any frame."""
    from minipath_tpu_torch.scene import triangle_bvh

    monkeypatch.setattr(triangle_bvh.TriangleBvh, "_quantized", lambda self, device, pt: False)
    with pytest.raises(RuntimeError, match="no QPTScene"):
        _run(q16_pt_bench)


@pytest.mark.parametrize("fault", [_pt_unchanged, _pt_half_batch, _pt_altered])
def test_a_broken_timed_path_is_not_correct(q16_pt_bench, monkeypatch, fault):
    fault(monkeypatch)
    rc, line, err = _run(q16_pt_bench)
    assert rc == 0 and line["correct"] is False, err
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_the_k3_readers_read_a_traced_request(q16_pt_bench):
    """One traced request of the tiny cell, with device activity laid in by
    name: K3's lean instances count to ``k3pt_ms`` and its rate, its full
    instance and K2 do not, and ``pt_glue_q_ms`` holds everything but K3.
    A trace with no lean K3 (the f32 layout's) reads nothing, and raises
    nothing."""
    from minipath_tpu_torch.utils import profiling

    bench = json.loads(q16_pt_bench.read_text())
    bdir = q16_pt_bench.parent / "benchmark"
    params = json.loads((bdir / "workloads" / f"{CELL}.json").read_text())
    config = json.loads((q16_pt_bench.parent / bench["configs"][-1]["file"]).read_text())
    driver = run.load_module(bdir / "drivers" / "pt_frame_q16.py")
    state = driver.setup(config, params, SEED, torch.device("cpu"))
    profiling.take()
    with profile.profiled(q16_pt_bench.parent / "trace.json") as got:
        with torch.profiler.record_function(profile.WINDOW):
            traced = [driver.request(state)]
    trace, rec = got[0], profiling.take()
    t0 = trace.start_us
    device = [("void traverse_q_kernel<true, false>(...)", t0, 3000.0, t0),
              ("void traverse_q_kernel<true, true>(...)", t0 + 3000, 500.0, t0),
              ("void traverse_q_kernel<false, false>(...)", t0 + 3500, 250.0, t0),
              ("void traverse_kernel<true, false>(...)", t0 + 3750, 100.0, t0),
              ("void shade_kernel(...)", t0 + 3850, 1000.0, t0)]
    ctx = SimpleNamespace(trace=trace._replace(device=device), traced=traced, cache={"program_record": rec})

    def read(name, c=ctx):
        return run.load_module(METRICS / f"{name}.py").read(c)

    assert read("k3pt_ms") == pytest.approx(3.5)
    assert read("pt_glue_q_ms") == pytest.approx(1.1)
    rays = rec.counters["pt.live_lanes"] + rec.counters["pt.shadow_rays"]
    assert rays > 0 and read("k3pt_mrays_s") == pytest.approx(rays / 3.5e-3 / 1e6)
    f32 = SimpleNamespace(trace=trace._replace(device=device[2:]), traced=traced,
                          cache={"program_record": Record(rec.spans, rec.counters)})
    assert read("k3pt_ms", f32) is None and read("k3pt_mrays_s", f32) is None
