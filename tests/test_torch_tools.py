"""The path tracer's tools (``minipath_tpu_torch/tools/``) on the CPU, made
tiny: the smallest atrium ``make_atrium`` makes (about 13k triangles, built
once into a temporary cache), frames of a few hundred pixels, one timed
frame, and the device-health probe at toy sizes, as tests/test_torch_bench.py
runs the bench. What is checked is each tool's behaviour, not a number: its
JSON line carries every key of the JAX-era artifact it stands in for (read
from the repository's root and left as it is), ``--out`` writes the same
JSON, nothing is written at the repository's root, and ``--device cuda``
without a card exits 2. Then the bounce loop's annotations: every phase name
appears in a CPU ``torch.profiler`` run of ``_pt_trace``, and
``utils/profiling.py::trace`` writes them into a Chrome trace.
"""

import contextlib
import io
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from minipath_tpu_torch import bench
from minipath_tpu_torch.tools import (
    bench_pt,
    bench_quality,
    convergence_pt,
    demo_bigscene,
    demo_hugescene,
    isolate_qpt,
    parity_big,
    profile_pt_headline,
)
from minipath_tpu_torch.utils import calibrate, cuda_build

REPO = Path(__file__).resolve().parent.parent


def _bench_pt(b):
    assert b["metric"] == "pt_atrium_32x16_2spp_5bounces" and b["nee_capped_depth"] == 1
    assert b["wavefront_vs_megakernel"] == round(b["megakernel_mean_s"] / b["wavefront_mean_s"], 2)
    assert 0 <= b["estimator_mean_delta"] < 1.0 and b["value"] > 0


def _convergence_pt(c):
    assert c["top_spp"] == 8 and c["rungs"] == [] and c["noise_floor_rmse"] > 0
    assert c["estimators_agree"] == (c["megakernel_rmse_vs_wavefront"] < 2 * c["noise_floor_rmse"])
    assert [g["spp"] for g in c["stratification_gain"]] == [8]


def _isolate_qpt(q):
    assert q["trace_rays"] == 2 * 2 * 256  # two 16x16-pixel blocks, 2 samples
    assert q["quantized_lean_inner_visits"] >= q["f32_lean_inner_visits"] > 0
    assert q["visit_ratio_q_over_f32"] >= 1.0 and q["f32_lean_ns_per_visit"] > 0


def _profile_pt_headline(p):
    assert p["chunks"] == 1 and p["phase_clock"] == "host" and p["trace_achieved_gops"] is None
    phases = p["phase_ms"]
    assert phases["trace"] > 0 and phases["compaction"] > 0 and phases["bsdf_scatter"] > 0
    assert phases["nee_light_sample"] == phases["shadow_trace"] == 0.0  # BSDF sampling only
    assert len(p["per_bounce"]) == profile_pt_headline.BOUNCES
    assert p["per_bounce"][0]["compaction_ms"] == 0.0 and p["per_bounce"][1]["compaction_ms"] > 0
    counters = p["trace_counters"]
    assert counters["inner_visits"] > 0 and counters["inner_ops_per_lane"] == 200
    assert counters["leaf_ops_per_lane"] == 384


def _parity_big(p):
    assert p["triangle_count"] > 10_000 and p["over_f32_budget"] is False and p["gates_failed"] == []
    for block in (p, p["f32"]):
        assert block["ray_parity"]["rays"] == block["anyhit_parity"]["segments"] == parity_big.N_RAYS
        assert block["ray_parity"]["hit_agreement"] > parity_big.HIT_AGREEMENT
        assert block["anyhit_parity"]["occlusion_agreement"] > parity_big.OCCLUSION_AGREEMENT
        assert block["frame_parity"]["mean_shift_frac"] < parity_big.MEAN_SHIFT
    assert p["frame_parity"]["mean_xla"] == p["f32"]["frame_parity"]["mean_xla"] > 0


def _bench_quality(q):
    assert q["engine"].startswith("K2") and q["reference_spp"] == 16 and q["reference_cut"]
    assert [r["spp"] for r in q["stratification"]] == [2] and [r["avg_spp"] for r in q["adaptive"]] == [10]
    assert [r["spp"] for r in q["sobol"]["rows"]] == [2] and q["denoise_variance_guided"][0]["rmse_denoised"] > 0
    assert q["adaptive_concentrated_noise"]["rows"][0]["rmse_uniform"] > 0
    assert "mse_ratio_uniform_over_adaptive_p2_px16" in q["adaptive_tworooms_concentrated"]["rows"][0]
    assert q["engine_check"]["other_engine"] == "portable" and q["gates_failed"] == []


def _demo(d):
    assert d["layouts"]["rule_picks"] == "f32" and d["layouts"]["scene_budget_mb"] is None
    assert d["frames"]["f32"]["coverage"] > 0.99 and d["frames"]["quantized"]["coverage"] > 0.99
    assert d["engines"]["rays"] == 32 * 16 * demo_bigscene.SMALL_SAMPLES and d["gates_failed"] == []


def _demo_bigscene(d):
    _demo(d)
    assert d["f32_layout_fits"] is True and d["value"] == d["frames"]["quantized"]["mrays_per_s"]


def _demo_hugescene(d):
    _demo(d)
    assert d["f32_refused"] is False and d["quantized_vmem_refused"] is False and d["emitters"] > 0
    assert d["pt_frame"]["mean_rgb"] > 0 and d["pt_frame_f32"]["mean_rgb"] > 0 and d["hbm_vs_xla"] > 0


# Each tool, the JAX-era artifact whose keys it keeps (or, where the JAX tool
# wrote no file, the keys of its JSON line), its tiny sizes, and what must
# hold among the numbers it derives.
TOOLS = {
    "bench_pt": (bench_pt, "BENCH_pt.json", ["32", "16", "2"], _bench_pt),
    "convergence_pt": (convergence_pt, "CONVERGENCE.json", ["32", "16", "8"], _convergence_pt),
    "isolate_qpt": (isolate_qpt, "ISOLATE_QPT.json", ["32", "16", "2"], _isolate_qpt),
    "profile_pt_headline": (profile_pt_headline, "PROFILE_PT.json", ["32", "16", "2"], _profile_pt_headline),
    "parity_big": (parity_big, "PARITY_BIG.json", ["2000", "32", "16", "1"], _parity_big),
    "bench_quality": (bench_quality, "QUALITY.json", ["32", "16", "16"], _bench_quality),
    "demo_bigscene": (demo_bigscene, ("metric", "value", "unit", "f32_layout_fits", "quantized_vmem_mb"),
                      ["2000", "32", "16", "2"], _demo_bigscene),
    "demo_hugescene": (demo_hugescene, "BENCH_huge.json", ["2000", "32", "16", "2"], _demo_hugescene),
}


# bench_quality's sections made tiny: the smallest atrium and two-rooms
# scenes, 32x16 frames, one seed and one budget a section.
QUALITY_TINY = dict(
    ATRIUM_TRIANGLES=2000, SEEDS=1, STRAT_SPP=(2,), ADAPTIVE_BUDGETS=(10,), DENOISE_SPP=(2,), SOBOL_SPP=(2,),
    SPHERE_SIZE=(32, 16), SPHERE_BUDGETS=(10,), TWOROOMS_TRIANGLES=2000, TWOROOMS_SIZE=(32, 16),
    TWOROOMS_BUDGETS=(12,), TWOROOMS_VARIANTS=(("p2_px16", 2, 8, 16),), ENGINE_CHECK_SPP=1,
)


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("tools_cache")


@pytest.fixture
def tiny(monkeypatch, cache_dir):
    monkeypatch.setattr(cuda_build, "bench_cache_dir", lambda: cache_dir)
    monkeypatch.setattr(bench, "ATRIUM_TRIANGLES", 2000)
    monkeypatch.setattr(bench_pt, "TIMED_FRAMES", 1)
    monkeypatch.setattr(isolate_qpt, "TIMED_FRAMES", 1)
    monkeypatch.setattr(isolate_qpt, "TRACE_REPS", 1)
    monkeypatch.setattr(convergence_pt, "STRAT_SEEDS", 1)
    monkeypatch.setattr(profile_pt_headline, "TIMED_FRAMES", 1)
    monkeypatch.setattr(profile_pt_headline, "TIMED_CHUNKS", 1)
    monkeypatch.setattr(demo_bigscene, "TIMED_FRAMES", 1)
    for name, value in QUALITY_TINY.items():
        monkeypatch.setattr(bench_quality, name, value)
    monkeypatch.setattr(calibrate, "MATMUL_N", 64)
    monkeypatch.setattr(calibrate, "CHAIN_SHAPE", (8, 128))
    monkeypatch.setattr(calibrate, "CHAIN_ITERS", 16)
    monkeypatch.setattr(calibrate, "FETCH_BYTES", 1 << 16)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """The plain traversal is thousands of small ops, which gain nothing from
    many threads and lose a lot when several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ignored_dirs(root):
    """The names of the directories at ``root`` that its ``.gitignore``
    lists (``.jax_cache/``, ``.hypothesis/``, ``.bench_cache/``, ...): caches
    that other test processes fill while a tool runs."""
    path = root / ".gitignore"
    lines = [ln.strip() for ln in path.read_text().splitlines()] if path.exists() else []
    return {ln.strip("/") for ln in lines if ln.endswith("/") and not ln.startswith("#") and "/" not in ln.strip("/")}


def root_state(root=REPO):
    """What a tool must leave at the repository's root as it found it: the
    size and mtime of each regular file, and the names of the entries but
    the directories that ``.gitignore`` lists. A directory's mtime is not
    compared: other test processes write into ``.jax_cache/``,
    ``minipath_tpu_torch/_build/`` and ``native/build/`` while a tool runs."""
    ignored = _ignored_dirs(root)
    names, files = set(), {}
    for p in root.iterdir():
        if p.is_dir() and p.name in ignored:
            continue
        names.add(p.name)
        if p.is_file() and not p.is_symlink():
            st = p.stat()
            files[p.name] = (st.st_size, st.st_mtime_ns)
    return {"names": names, "files": files}


def _touch_later(path):
    """Moves ``path``'s mtime one second on, as a write would."""
    st = path.stat()
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))


def _rewrite_artifact(root):
    (root / "BENCH_pt.json").write_text("{}")
    _touch_later(root / "BENCH_pt.json")


def _fill_jax_cache(root):
    (root / ".jax_cache" / "entry").write_text("x")
    _touch_later(root / ".jax_cache")


def _build_in_package(root):
    (root / "minipath_tpu_torch" / "_build").mkdir()
    _touch_later(root / "minipath_tpu_torch")


# A change at the root, and whether root_state stays equal across it.
ROOT_CHANGES = {
    "artifact rewritten, same size": (_rewrite_artifact, False),
    "file added": (lambda root: (root / "new.json").write_text("{}"), False),
    "unlisted directory added": (lambda root: (root / "build").mkdir(), False),
    "entry added in .jax_cache/": (_fill_jax_cache, True),
    ".hypothesis/ created": (lambda root: (root / ".hypothesis").mkdir(), True),
    "_build/ created in a package": (_build_in_package, True),
}


@pytest.mark.parametrize("case", list(ROOT_CHANGES))
def test_root_state_sees_a_tools_writes_and_not_the_caches(tmp_path, case):
    """On a root laid out as the repository's (its ``.gitignore``, an
    artifact, a package, the JAX compile cache), the check fails for a
    rewritten artifact, a new file and a new unlisted directory, and holds
    while other processes fill the caches."""
    shutil.copy(REPO / ".gitignore", tmp_path / ".gitignore")
    (tmp_path / "BENCH_pt.json").write_text("{}")
    (tmp_path / "minipath_tpu_torch").mkdir()
    (tmp_path / ".jax_cache").mkdir()
    before = root_state(tmp_path)
    change, stays = ROOT_CHANGES[case]
    change(tmp_path)
    assert (root_state(tmp_path) == before) is stays


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_keeps_the_artifact_keys(tiny, tmp_path, name):
    tool, artifact, size, check = TOOLS[name]
    want = json.loads((REPO / artifact).read_text()) if isinstance(artifact, str) else dict.fromkeys(artifact)
    before = root_state()
    out_path = tmp_path / f"{name}.json"
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        rc = tool.main(["--device", "cpu", "--out", str(out_path), *size])
    assert rc == 0
    lines = said.getvalue().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert set(want) <= set(got), set(want) - set(got)
    assert json.loads(out_path.read_text()) == got
    assert got["device"] == "cpu"
    if "device_health" in want:
        assert set(got["device_health"]) >= set(want["device_health"]) - {"device"}
    assert root_state() == before  # no artifact rewritten, no file added at the root
    check(got)


@pytest.mark.parametrize("name", list(TOOLS))
def test_no_card_exits_2(monkeypatch, capsys, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert TOOLS[name][0].main([]) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "no CUDA device" in captured.err


def test_annotations_name_every_phase_of_the_bounce_loop(tmp_path):
    """A NEE frame with compaction, profiled on the CPU through
    ``utils/profiling.py::trace``: every annotated phase shows up, in the
    profiler's table and in the Chrome trace it writes."""
    from minipath_tpu_torch import Camera, TriangleBvh
    from minipath_tpu_torch.render import wavefront as tw
    from minipath_tpu_torch.scene import materials as tm
    from minipath_tpu_torch.scene import procedural
    from minipath_tpu_torch.utils.profiling import span, trace

    mesh = procedural.make_atrium(0)
    ids, dicts = procedural.atrium_materials(mesh)
    bvh = TriangleBvh.build(mesh, materials=ids, leaf_max=24)
    scene = bvh.pt_scene("cpu")
    table = tm.material_table(dicts, "cpu")
    tracer, _ = tw.make_pt_tracer(scene, stack_size=bvh.recommended_stack_size)
    shadow, _ = tw.make_pt_shadow_tracer(scene, stack_size=bvh.recommended_stack_size)
    lights = tm.build_light_table(bvh.host_arrays.tri_packets, bvh.host_arrays.tri_material, table)
    camera = Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(36e-3)
    with trace(tmp_path / "prof") as prof:
        with span("test.frame"):
            img = tw.render_frame_pt(tracer, scene, table, camera.build_sampler((16, 16), "cpu"),
                                     torch.Generator().manual_seed(0), width=16, height=16, spp=2, bounces=2,
                                     samples_per_packet=2, lights=lights, shadow_tracer=shadow)
    assert np.isfinite(img.numpy()).all()
    names = {e.key for e in prof.key_averages()}
    assert set(profile_pt_headline.PHASES) | {"test.frame"} <= names
    text = (tmp_path / "prof" / "trace.json").read_text()
    for name in profile_pt_headline.PHASES:
        assert f'"{name}"' in text, name
    counts = {e.key: e.count for e in prof.key_averages()}
    assert counts["pt.trace"] == 2 and counts["pt.compaction"] == 1
    assert counts["pt.environment_emission"] == counts["pt.hit_emission"] == 2
