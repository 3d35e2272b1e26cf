"""The port's benchmark entry point (``minipath_tpu_torch/bench.py``) on the CPU,
with every rung made tiny: frames of a few hundred pixels, the smallest
atrium ``make_atrium`` makes (about 13k triangles), one timed frame a rung,
and the device-health probe at toy sizes. The rungs then run through the
kernels' plain versions; what is checked is the bench's behaviour, not a
number: each rung's line as it finishes, the time budget, a failing rung,
the smoke test's limits (0.1% hit mismatch, 1% relative t error) and the
JAX bench's keys on the last line.
"""

import contextlib
import io
import json
import re
import time
from pathlib import Path

import pytest
import torch

from minipath_tpu_torch import bench
from minipath_tpu_torch.utils import calibrate, cuda_build

REPO = Path(__file__).resolve().parent.parent
RUNG_NAMES = [name for name, _ in bench.RUNGS]
DEFAULT_CACHE = cuda_build.bench_cache_dir
# The last line of the JAX bench (bench.py:587-611).
JAX_KEYS = [
    "metric", "value", "unit", "vs_baseline",
    "pt_wavefront_mpaths_per_s", "pt_nee_mpaths_per_s", "pt_nee_capped_mpaths_per_s",
    "pt_1080p64_wavefront_s", "pt_1080p64_wavefront_mpaths_per_s",
    "pt_1080p64_nee_capped_s", "pt_1080p64_nee_capped_mpaths_per_s",
    "pt_big_scene_mpaths_per_s",
]


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("bench_cache")


@pytest.fixture
def tiny(monkeypatch, cache_dir):
    monkeypatch.setattr(cuda_build, "bench_cache_dir", lambda: cache_dir)
    monkeypatch.setattr(bench, "WIDTH", 48)
    monkeypatch.setattr(bench, "HEIGHT", 32)
    monkeypatch.setattr(bench, "SPP", 2)
    monkeypatch.setattr(bench, "SAMPLES_PER_PACKET", 2)
    monkeypatch.setattr(bench, "TIMED_FRAMES", 2)
    monkeypatch.setattr(bench, "ATRIUM_TRIANGLES", 2000)
    monkeypatch.setattr(bench, "BIG_TRIANGLES", 16000)
    monkeypatch.setattr(bench, "PT_SIZE", (32, 16, 2))
    monkeypatch.setattr(bench, "PT_1080", (32, 32, 2))
    monkeypatch.setattr(bench, "SMOKE", (32, 16, 2))
    monkeypatch.setattr(bench, "FRAMES", {k: 1 for k in bench.FRAMES})
    monkeypatch.setattr(calibrate, "MATMUL_N", 64)
    monkeypatch.setattr(calibrate, "CHAIN_SHAPE", (8, 128))
    monkeypatch.setattr(calibrate, "CHAIN_ITERS", 16)
    monkeypatch.setattr(calibrate, "FETCH_BYTES", 1 << 16)


def _run(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--device", "cpu", *argv])
    return rc, [json.loads(line) for line in out.getvalue().splitlines()], out


def _watch(monkeypatch, out_of_run, before=None):
    """Wrap every rung so that it records, as it starts, the rung lines
    already on stdout."""
    seen = {}

    def wrap(name, fn):
        def run(ctx):
            seen[name] = [json.loads(line).get("rung") for line in out_of_run().splitlines()]
            if before is not None:
                before(name)
            return fn(ctx)

        return run

    monkeypatch.setattr(bench, "RUNGS", tuple((n, wrap(n, f)) for n, f in bench.RUNGS))
    return seen


def test_every_rung_prints_its_line_as_it_finishes(tiny, monkeypatch):
    out = io.StringIO()
    seen = _watch(monkeypatch, out.getvalue)
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--device", "cpu"])
    assert rc == 0
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    assert [line.get("rung") for line in lines[:-1]] == RUNG_NAMES
    for i, name in enumerate(RUNG_NAMES):
        assert seen[name] == RUNG_NAMES[:i], name  # the earlier rungs' lines were out already
    by_rung = {line["rung"]: line for line in lines[:-1]}
    assert by_rung["smoke"]["hit_mismatch"] == 0.0 and by_rung["smoke"]["hit_rate"] > 0.5
    assert by_rung["f32"]["n"] == 2 and by_rung["f32"]["coverage"] > 0.5
    assert by_rung["big_scene"]["scene_budget_mb"] is None  # no budget on the CPU
    assert set(by_rung["device_health"]) >= {"matmul_8k_bf16_tflops", "vpu_chain_gops", "fetch_mb_s", "roundtrip_ms"}
    assert "error" not in json.dumps(lines)


def test_last_line_has_the_jax_keys(tiny):
    source = (REPO / "bench.py").read_text()
    for key in JAX_KEYS:
        assert re.search(rf'"{key}"|"{key.removeprefix("pt_")}"', source), key
    rc, lines, _ = _run()
    last = lines[-1]
    assert rc == 0 and list(last) == JAX_KEYS
    assert last["metric"] == "atrium_obj_1080p_64spp_throughput" and last["unit"] == "Mrays/s"
    # The bench rounds a rate to two or three decimals, as the JAX bench does,
    # so a few thousand rays on a loaded host can round to 0.0: a rate is held
    # to >= 0, and the seconds behind it, which cannot round away, to > 0.
    by_rung = {line["rung"]: line for line in lines[:-1]}
    assert by_rung["f32"]["mean_s"] > 0 and last["value"] == by_rung["f32"]["mrays_per_s"] >= 0
    assert last["vs_baseline"] == round(last["value"] / bench.TARGET_MRAYS, 3)
    for k in JAX_KEYS[4:]:
        assert isinstance(last[k], float), k
        assert last[k] > 0 if k.endswith("_s") and not k.endswith("_per_s") else last[k] >= 0, k
    for name in ("wavefront", "nee", "nee_capped"):
        assert by_rung[f"pt_{name}"][f"{name}_mean_s"] > 0, name
    assert by_rung["pt_big"]["mean_s"] > 0


def test_budget_stops_the_run_and_names_the_skipped_rungs(tiny, monkeypatch):
    out = io.StringIO()
    _watch(monkeypatch, out.getvalue, before=lambda name: time.sleep(0.3))
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--device", "cpu", "--budget-s", "0.2"])
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    assert rc == 0
    assert lines[0]["rung"] == "smoke" and "error" not in lines[0]
    assert lines[1]["skipped"] == RUNG_NAMES[1:] and lines[1]["budget_s"] == 0.2
    assert list(lines[2]) == JAX_KEYS[:4] and lines[2]["value"] is None


def test_a_failing_rung_leaves_the_later_rungs_running(tiny, monkeypatch, tmp_path):
    """The big scene fails to build: its two rungs print their errors, every
    other rung runs, the extra artifact names the errors, and the run exits
    1."""
    build = bench.build_obj_scene

    def failing(n):
        if n == bench.BIG_TRIANGLES:
            raise OSError("disk full")
        return build(n)

    monkeypatch.setattr(bench, "build_obj_scene", failing)
    extra = tmp_path / "extra.json"
    rc, lines, _ = _run("--out", str(extra))
    assert rc == 1
    by_rung = {line["rung"]: line for line in lines[:-1]}
    assert list(by_rung) == RUNG_NAMES
    for name in RUNG_NAMES:
        assert ("error" in by_rung[name]) == (name in ("big_scene", "pt_big")), name
    assert by_rung["big_scene"]["error"] == "OSError('disk full')"
    assert "pt_big_scene_mpaths_per_s" not in lines[-1] and lines[-1]["value"] >= 0
    artifact = json.loads(extra.read_text())
    assert artifact["big_scene"] == {"error": "OSError('disk full')"}
    assert artifact["pt_big_scene"] == {"error": "OSError('disk full')"}
    assert artifact["f32_kernel"]["n"] == 2 and set(artifact["scene_mb"]) == {"f32", "quantized"}
    assert "vmem_mb" not in json.dumps(artifact) and artifact["pt"]["nee_capped_mpaths_per_s"] >= 0


@pytest.mark.parametrize("fault", ["hits dropped", "t off by 5%"])
def test_smoke_test_fails_on_a_corrupted_kernel(tiny, monkeypatch, fault):
    real = bench.trace_scene

    def corrupted(*args, **kw):
        kh = real(*args, **kw)
        if fault == "hits dropped":
            tri = kh.tri.clone()
            tri.view(-1)[::7] = -1
            return kh._replace(tri=tri)
        return kh._replace(t=kh.t * 1.05)

    ctx = bench.Context(torch.device("cpu"))
    assert bench.smoke_test(ctx)["hit_mismatch"] == 0.0
    monkeypatch.setattr(bench, "trace_scene", corrupted)
    with pytest.raises(SystemExit) as exc:
        bench.smoke_test(ctx)
    assert exc.value.code == 1
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        bench.main(["--device", "cpu"])
    assert out.getvalue() == ""  # the run stops before any rung line


def test_no_card_fails_at_once(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "no CUDA device" in captured.err


def test_the_cache_is_the_ports_own(tiny, cache_dir):
    """Scenes are cached under ``.bench_cache/torch/``, never in the JAX
    bench's files beside it, and a second build reads the cache."""
    assert DEFAULT_CACHE() == REPO / ".bench_cache" / "torch"
    first = bench.build_obj_scene(2000)
    assert (cache_dir / "atrium_obj_2000.npz").exists() and (cache_dir / "atrium_2000.obj").exists()
    again = bench.build_obj_scene(2000)
    assert again.triangle_count == first.triangle_count and again.max_depth == first.max_depth
    for field in first.arrays._fields:
        assert (getattr(again.arrays, field) == getattr(first.arrays, field)).all(), field
