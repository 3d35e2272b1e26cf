"""Every name in BENCHMARK.json resolves to its files, and a cell and a
metric added as new files only are found without an edit."""

from __future__ import annotations

import io
import json
import re
from pathlib import Path

import torch

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_name_resolves_to_its_files():
    bdir = ROOT / BENCH["paths"][0]
    assert BENCH["command"] == ["python3", "benchmark/run.py"] and BENCH["paths"] == ["benchmark"]
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("benchmark/configs/") and cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        params = json.loads((bdir / "workloads" / f"{w['name']}.json").read_text())
        assert (bdir / "drivers" / f"{params['driver']}.py").is_file()
        assert any(c["name"] == w["config"] for c in BENCH["configs"]) and w["chips"] == 1
        names = run.metric_names(BENCH, w["name"], False)
        assert "setup_s" in names and len(names) >= 2 and run.metric_names(BENCH, w["name"], True)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert hasattr(run.load_module(bdir / "metrics" / f"{m['name']}.py"), "read")


def test_the_file_keeps_to_the_contracts_forms():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    every = [*BENCH["configs"], *BENCH["workloads"], *BENCH["end_to_end"], *BENCH["per_layer"]]
    assert all(NAME.match(x["name"]) for x in every) and len({x["name"] for x in every}) == len(every)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"} and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"} and m["moves"] in e2e
        assert set(m.get("workloads", [])) <= cells and UNIT.match(m["unit"])
        for cell in m.get("workloads", []):
            assert m["moves"] in run.metric_names(BENCH, cell, False)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_cell_and_a_metric_added_as_files_are_found(tiny_bench):
    bdir = tiny_bench.parent / "benchmark"
    (bdir / "workloads" / "throwaway.json").write_text(json.dumps({
        "driver": "render_cli", "width": 32, "height": 32, "spp": 2, "tile_size": 16, "check_pixels": 64,
        "check_frames": 1, "reference_paths": 16, "trace_requests": 1, "checks": {"off_share": 0.01}}))
    (bdir / "metrics" / "frames_done.py").write_text("def read(ctx):\n    return len(ctx.records)\n")
    bench = json.loads(tiny_bench.read_text())
    bench["workloads"].append({"name": "throwaway", "config": "tiny-parity", "traffic": "t", "chips": 1, "why": "t"})
    bench["end_to_end"].append({"name": "frames_done", "unit": "frames", "better": "higher", "bound": 0.25,
                                "source": "host_clock", "workloads": ["throwaway"]})
    tiny_bench.write_text(json.dumps(bench))
    out = io.StringIO()
    assert run.run("throwaway", 5, 0.2, False, device=torch.device("cpu"), bench_path=tiny_bench, out=out,
                   err=io.StringIO()) == 0
    line = json.loads(out.getvalue())
    assert line["metrics"]["frames_done"]["value"] == line["attempted"] and line["correct"] is True
