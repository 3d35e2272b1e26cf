"""The sweeps and tree tools (``minipath_tpu_torch/tools/``) on the CPU, made
tiny: the smallest atrium and two-rooms scenes ``make_atrium`` and
``make_tworooms`` make (built once into a temporary cache), 32x16 frames at 2
spp, two seeds. What is checked is each tool's behaviour, not a number: its
JSON line carries the keys of the JAX-era artifact it stands in for (read from
the repository's root and left as it is) and of that artifact's rows,
``--out`` writes the same JSON, nothing else is written at the repository's
root, ``--device cuda`` without a card exits 2, and each gate exits 1 when it
is fed a shifted mean or a wrong tracer. ``tree_cost`` is held to the JAX
tool's function on the same arrays.

At these sizes a frame mean moves by tens of percent between seeds and
configurations (a 32x16 @ 2 spp frame holds 1,024 paths), so the tests run the
mean gates at ``MEAN_RTOL = 0.5`` and add 1.0 to every value of a frame to trip
them (an offset, so that the seeds' spread, which the gates also allow for,
stays as it was); the tools keep their 1% at the sizes they run at.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from minipath_tpu_torch import bench
from minipath_tpu_torch.render import kernels
from minipath_tpu_torch.tools import (
    common,
    perf_leaf,
    sobol_cost,
    sweep_adaptive,
    sweep_pt17,
    sweep_pt19,
    sweep_rr2,
    sweep_sbvh,
    tree_quality,
)

REPO = Path(__file__).resolve().parent.parent
TINY_MEAN_RTOL = 0.5
SHIFT = 1.0


def _artifact(name):
    return json.loads((REPO / name).read_text())


def _rows_have(got_rows, want_rows):
    assert got_rows and set(want_rows[0]) <= set(got_rows[0]), set(want_rows[0]) - set(got_rows[0])


def _sweep_rr2(got):
    want = _artifact("SWEEP_RR.json")["nee_capped"]
    assert set(want) - {"note"} <= set(got["nee_capped"])
    rows = got["nee_capped"]["rows"]
    _rows_have(rows, want["rows"])
    assert [(r["rr_start"], r["rr_floor"], r["min_live_frac"]) for r in rows] == list(sweep_rr2.CONFIGS)
    assert rows[0]["efficiency_vs_baseline"] == 1.0 and rows[0]["mean_shift_pct"] == 0.0
    # The tail cutoff never fires within 5 bounces at these sizes: the frames equal the first row's.
    assert rows[6]["mean"] == rows[7]["mean"] == rows[0]["mean"] and rows[6]["var"] == rows[0]["var"]


def _caps(got):
    want = _artifact("SWEEP_NEE_CAP2.json")
    assert set(want) <= set(got)
    _rows_have(got["rows"], want["rows"])
    assert [r["cap"] for r in got["rows"]] == [None, 3, 2, 1] and got["rows"][0]["efficiency_vs_uncapped"] == 1.0


def _sobol_cost(got):
    assert got["cost_ratio_sobol_over_stratified"] == got["sobol_s_per_frame"] / got["stratified_s_per_frame"]
    assert got["sobol_frame_mean"] > 0 and got["stratified_frame_mean"] > 0


def _sweep_adaptive(got):
    _rows_have(got["adaptive"], _artifact("QUALITY.json")["adaptive"])
    (row,) = got["adaptive"]
    assert row["avg_spp"] == 10 and row["spp_mean"] == pytest.approx(10, abs=2) and row["spp_min"] >= 2
    assert row["rmse_uniform"] > 0 and row["rmse_adaptive"] > 0


def _perf_leaf(got):
    assert [r["leaf_max"] for r in got["rows"]] == list(perf_leaf.LEAVES) and got["rays"] == 32 * 16 * 2
    for r in got["rows"]:
        assert r["hit_mismatch"] == 0 and r["t_within_share"] == 1.0 and r["trace_ms"] > 0 and r["packets"] > 0


def _tree_quality(got):
    native, python = got["rows"]
    assert (native["tree"], python["tree"]) == ("native-24", "python-24")
    assert all(r["box_tests"] > 0 and r["tri_tests"] > 0 and r["total"] == r["box_tests"] + r["tri_tests"]
               for r in got["rows"])


def _sweep_sbvh(got):
    trees = got["trees"]
    assert trees["sbvh"]["references"] > trees["obj"]["references"]  # clipped triangles sit in several leaves
    assert [r["bounce"] for r in got["rows"]] == list(range(sweep_sbvh.BOUNCES + 1))
    for r in got["rows"]:
        assert r["hit_mismatch"] == 0 and r["t_within_share"] == 1.0
        assert r["obj"]["inner_visits"] > 0 and r["sbvh"]["leaf_tests"] > 0


# Each tool, the keys its line must have, its tiny arguments, and what must
# hold among its numbers.
TOOLS = {
    "sweep_rr2": (sweep_rr2, ("device", "nee_capped", "gates_failed"), ["32", "16", "2"], _sweep_rr2),
    "sweep_pt17": (sweep_pt17, ("device", "workload", "rows"), ["32", "16", "2"], _caps),
    "sweep_pt19": (sweep_pt19, ("device", "workload", "rows"), ["32", "16", "2"], _caps),
    "sobol_cost": (sobol_cost, ("stratified_s_per_frame", "stratified_frame_mean", "sobol_s_per_frame",
                                "sobol_frame_mean", "cost_ratio_sobol_over_stratified", "workload"),
                   ["32", "16", "2"], _sobol_cost),
    "sweep_adaptive": (sweep_adaptive, ("reference_spp", "reference_mean", "adaptive"), ["32", "16"],
                       _sweep_adaptive),
    "perf_leaf": (perf_leaf, ("workload", "rays", "rows"), ["2000", "32", "16", "2"], _perf_leaf),
    "tree_quality": (tree_quality, ("workload", "rows"), ["2000"], _tree_quality),
    "sweep_sbvh": (sweep_sbvh, ("workload", "trees", "rows"), ["2000", "32", "16", "2"], _sweep_sbvh),
}


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("sweeps_cache")


@pytest.fixture
def tiny(monkeypatch, cache_dir):
    monkeypatch.setattr(bench, "CACHE", cache_dir)
    monkeypatch.setattr(bench, "ATRIUM_TRIANGLES", 2000)
    monkeypatch.setattr(common, "MEAN_RTOL", TINY_MEAN_RTOL)
    for tool in (sweep_rr2, sweep_pt17, sweep_pt19):
        monkeypatch.setattr(tool, "SEEDS", 2)
    monkeypatch.setattr(sweep_pt19, "TWOROOMS_TRIANGLES", 2000)
    monkeypatch.setattr(sobol_cost, "TIMED_FRAMES", 1)
    monkeypatch.setattr(sobol_cost, "BEST", 1)
    monkeypatch.setattr(sweep_adaptive, "REFERENCE_SPP", 16)
    monkeypatch.setattr(sweep_adaptive, "BUDGETS", (10,))
    monkeypatch.setattr(sweep_adaptive, "FRAMES", 2)
    monkeypatch.setattr(perf_leaf, "TRACE_REPS", 1)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """The plain traversal is thousands of small ops, which gain nothing from
    many threads and lose a lot when several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _root_state():
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns) for p in REPO.iterdir()}


def _run(tool, args):
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        rc = tool.main(["--device", "cpu", *args])
    lines = said.getvalue().splitlines()
    assert len(lines) == 1
    return rc, json.loads(lines[0])


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_keeps_the_artifact_keys(tiny, tmp_path, name):
    tool, keys, size, check = TOOLS[name]
    before = _root_state()
    out_path = tmp_path / f"{name}.json"
    rc, got = _run(tool, ["--out", str(out_path), *size])
    assert rc == 0 and got["gates_failed"] == []
    assert set(keys) <= set(got), set(keys) - set(got)
    assert json.loads(out_path.read_text()) == got
    assert got["device"] == "cpu"
    assert _root_state() == before  # no artifact rewritten, no file added at the root
    check(got)


@pytest.mark.parametrize("name", list(TOOLS))
def test_no_card_exits_2(monkeypatch, capsys, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert TOOLS[name][0].main([]) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "no CUDA device" in captured.err


def test_rr2_modes_keep_their_sections(tiny):
    """``--bsdf-only`` gives the ``wavefront`` section, ``--floors`` the
    floors at ``rr_start`` 3, ``--floors-precise`` the ``floor_precise``
    section with its error bars."""
    art = _artifact("SWEEP_RR.json")
    rc, got = _run(sweep_rr2, ["--bsdf-only", "--floors", "0.05,0.5", "32", "16", "2"])
    assert rc == 0 and set(art["wavefront"]) <= set(got["wavefront"])
    assert [(r["rr_start"], r["rr_floor"]) for r in got["wavefront"]["rows"]] == [(3, 0.05), (3, 0.5)]
    rc, got = _run(sweep_rr2, ["--floors-precise", "0.05,0.25", "32", "16", "2"])
    section = got["floor_precise"]
    assert rc == 0 and set(art["floor_precise"]) - {"decision"} <= set(section)
    _rows_have(section["rows"], art["floor_precise"]["rows"])
    assert set(art["floor_precise"]["rows"][0]["per_seed"][0]) <= set(section["rows"][0]["per_seed"][0])
    assert len(section["rows"][0]["per_seed"]) == sweep_rr2.SEEDS and section["rows"][0]["efficiency_vs_first"] == 1
    with pytest.raises(SystemExit):
        sweep_rr2.main(["--device", "cpu", "--floors-precise", "0.5", "--bsdf-only"])


def _shifted_pt_frame(monkeypatch, when):
    """``common.pt_frame`` with :data:`SHIFT` added to the image where
    ``when(kwargs)`` holds."""
    inner = common.pt_frame

    def shifted(*a, **kw):
        out = inner(*a, **kw)
        return out + SHIFT if when(kw) else out

    monkeypatch.setattr(common, "pt_frame", shifted)


@pytest.mark.parametrize("name, when, args", [
    ("sweep_rr2", lambda kw: kw["rr_start"] == 2 and kw["rr_floor"] == 0.25, ["32", "16", "2"]),
    ("sweep_rr2", lambda kw: kw["rr_floor"] == 0.5, ["--floors-precise", "0.05,0.5", "32", "16", "2"]),
    ("sweep_pt17", lambda kw: kw["nee_max_depth"] == 2, ["32", "16", "2"]),
    ("sweep_pt19", lambda kw: kw["nee_max_depth"] == 1, ["32", "16", "2"]),
    ("sobol_cost", lambda kw: kw["sobol"], ["32", "16", "2"]),
])
def test_mean_gate_fails_on_a_shifted_mean(tiny, monkeypatch, name, when, args):
    if "--floors-precise" in args:
        inner = common.pt_frame

        def shifted(*a, **kw):  # the image, not the variance
            img, var = inner(*a, **kw)
            return (img + SHIFT if when(kw) else img), var

        monkeypatch.setattr(common, "pt_frame", shifted)
    else:
        _shifted_pt_frame(monkeypatch, when)
    rc, got = _run(TOOLS[name][0], args)
    assert rc == 1 and len(got["gates_failed"]) == 1 and "mean" in got["gates_failed"][0]


def test_adaptive_gate_fails_on_a_shifted_mean(tiny, monkeypatch):
    from minipath_tpu_torch.render import adaptive

    inner = adaptive.render_frame_pt_adaptive

    def shifted(*a, **kw):
        img, spp_map = inner(*a, **kw)
        return img + SHIFT, spp_map

    monkeypatch.setattr(adaptive, "render_frame_pt_adaptive", shifted)
    rc, got = _run(sweep_adaptive, ["32", "16"])
    assert rc == 1 and got["gates_failed"] == [got["gates_failed"][0]] and "adaptive" in got["gates_failed"][0]


def test_perf_leaf_gate_fails_on_a_wrong_tracer(tiny, monkeypatch):
    """K1 over every tree after the first returns a miss on one ray."""
    inner, first = kernels.trace_packets, []

    def wrong(scene, rays9, **kw):
        kh = inner(scene, rays9, **kw)
        if not first:
            first.append(scene)
        if scene is not first[0]:
            tri = kh.tri.clone()
            tri.view(-1)[0] = -1
            kh = kh._replace(tri=tri)
        return kh

    wrong.launches = inner.launches
    monkeypatch.setattr(kernels, "trace_packets", wrong)
    rc, got = _run(perf_leaf, ["2000", "32", "16", "2"])
    assert rc == 1 and len(got["gates_failed"]) == len(perf_leaf.LEAVES) - 1
    assert [r["hit_mismatch"] for r in got["rows"]] == [0] + [1] * (len(perf_leaf.LEAVES) - 1)


def test_sweep_sbvh_gate_fails_on_a_wrong_tracer(tiny, monkeypatch):
    """The SBVH tree's tracer (the second one made) returns every t 0.1%
    long."""
    inner, made = common.pt_tracers, []

    def tracers(bvh, device, engine):
        tracer, shadow, state = inner(bvh, device, engine)
        made.append(engine)
        if len(made) == 2:
            def long_t(*a):
                kh = tracer(*a)
                return kh._replace(t=kh.t * 1.001)

            return long_t, shadow, state
        return tracer, shadow, state

    monkeypatch.setattr(common, "pt_tracers", tracers)
    rc, got = _run(sweep_sbvh, ["2000", "32", "16", "2"])
    assert rc == 1 and len(got["gates_failed"]) == sweep_sbvh.BOUNCES + 1
    assert all(r["t_within_share"] < 0.5 for r in got["rows"])


def test_tree_quality_gate_fails_on_a_tree_that_lost_a_triangle(tiny, monkeypatch):
    from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh

    inner = common.atrium

    def atrium(n, **kw):
        built = inner(n, **kw)
        if kw.get("builder") != "python":
            return built
        result = built.bvh.build_result
        return built._replace(bvh=TriangleBvh(dataclasses.replace(result, triangle_count=result.triangle_count + 1)))

    monkeypatch.setattr(common, "atrium", atrium)
    rc, got = _run(tree_quality, ["2000"])
    assert rc == 1 and len(got["gates_failed"]) == 1 and "python-24" in got["gates_failed"][0]


def test_tree_cost_matches_the_jax_tool(tiny):
    """``tree_cost`` against ``tools/tree_quality.py::tree_cost`` (NumPy and
    the JAX package's ``links``) on the same arrays: the JAX tool sums in
    float32, one child at a time, this one in float64 at once."""
    spec = importlib.util.spec_from_file_location("jax_tree_quality", REPO / "tools" / "tree_quality.py")
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    for builder in ("native", "python"):
        arrays = common.atrium(2000, materials=False, leaf_max=24, builder=builder).bvh.host_arrays
        np.testing.assert_allclose(tree_quality.tree_cost(arrays), jax_tool.tree_cost(arrays), rtol=1e-5)
