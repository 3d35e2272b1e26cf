"""Whole runs of the tiny cells on the CPU (the look for a card skipped),
with the timed path sound and with it broken underneath."""

from __future__ import annotations

import io
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]

SEED = 2**31 + 12345


def _run(bench_path, workload, seed=SEED, seconds=0.3, trace=False):
    out, err = io.StringIO(), io.StringIO()
    rc = run.run(workload, seed, seconds, trace, device=torch.device("cpu"), bench_path=bench_path, out=out, err=err)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("workload", ["tiny-frame", "tiny-pt"])
def test_a_sound_run_is_correct_and_prints_its_checks_last(tiny_bench, workload):
    rc, out, err = _run(tiny_bench, workload)
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(line)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    assert "setup_s" in line["metrics"]
    assert err.strip().splitlines()[-1].startswith("check ")


def test_the_traced_run_reads_per_layer_metrics(tiny_bench):
    """Off the card no device time is traced: the device readers find
    nothing and their metrics are left out, never read as 0."""
    rc, out, err = _run(tiny_bench, "tiny-frame", trace=True)
    line = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    assert "setup_s" not in line["metrics"] and "k1_roofline" not in line["metrics"]
    assert "setup_s " in err and "window: " in err
    assert line["device"]["window_s"] > 0 and set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result():
    """Without a card (as here) the command exits non-zero and prints nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "parity-1080p64", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_no_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark, a
    run fails before it prints anything."""
    import shutil

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys, torch; sys.argv[1:] = ['--workload', 'parity-1080p64', '--seed', '3', '--seconds', '1'];"
            "torch.cuda.is_available = lambda: True; torch.cuda.device_count = lambda: 1;"
            "import runpy; runpy.run_path('benchmark/run.py', run_name='__main__')")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


# -- the timed path broken underneath: each fault the cells can have ---------


def _unchanged(monkeypatch):
    """A step that returns its state unchanged: every tile stays as it was."""
    from minipath_tpu_torch.render import machinery

    monkeypatch.setattr(machinery, "_finalize_u8", lambda acc, spp: torch.zeros_like(acc, dtype=torch.uint8))


def _half_samples(monkeypatch):
    """Half of the batch left out, the mean taken over the rest: each pass
    traces half its samples and counts them twice."""
    from minipath_tpu_torch.render import integrator

    real = integrator.render_tile_batch_bvh

    def half(*args, spp, **kw):
        return real(*args, spp=max(1, spp // 2), **kw) * (spp / max(1, spp // 2))

    monkeypatch.setattr(integrator, "render_tile_batch_bvh", half)


def _altered_tile(monkeypatch):
    """An answer altered where it is produced: the first tile of every
    dispatch comes back ten levels brighter."""
    from minipath_tpu_torch.render import integrator

    real = integrator.render_tile_batch_bvh

    def altered(*args, spp, **kw):
        out = real(*args, spp=spp, **kw)
        out[0, ..., :3] += 10.0 / 255.0 * spp
        return out

    monkeypatch.setattr(integrator, "render_tile_batch_bvh", altered)


def _dropped_tiles(monkeypatch):
    """Half of the tiles of each dispatch left out (never traced, left black)."""
    from minipath_tpu_torch.render import integrator

    real = integrator.render_tile_batch_bvh

    def dropped(*args, spp, **kw):
        out = real(*args, spp=spp, **kw)
        out[1::2] = 0.0
        return out

    monkeypatch.setattr(integrator, "render_tile_batch_bvh", dropped)


def _pt_unchanged(monkeypatch):
    """A step that returns its state unchanged: each bounce leaves the paths
    as they were, so no radiance is gathered."""
    from minipath_tpu_torch.render import wavefront

    monkeypatch.setattr(wavefront, "_pt_trace", lambda *a, samples, **kw: torch.zeros(
        (a[3].shape[0], a[3].shape[2] // samples, 3), dtype=torch.float32, device=a[3].device))


def _pt_half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest: every other
    packet of each chunk's wavefront is never traced and left black."""
    from minipath_tpu_torch.render import wavefront

    real = wavefront._pt_trace

    def half(*args, **kw):
        out = real(*args, **kw)
        out[1::2] = 0.0
        return out

    monkeypatch.setattr(wavefront, "_pt_trace", half)


def _pt_altered(monkeypatch):
    """An answer altered where it is produced: each chunk's radiance comes
    back a tenth brighter."""
    from minipath_tpu_torch.render import wavefront

    real = wavefront._pt_trace
    monkeypatch.setattr(wavefront, "_pt_trace", lambda *a, **kw: real(*a, **kw) * 1.1)


# The path tracer's half is of its wavefront (leaving out half of its
# samples, each pixel's mean taken over the rest, leaves the estimate's
# expectation as it is: pt_eff's variance shows that one).
FAULTS = [("tiny-frame", f) for f in (_unchanged, _half_samples, _altered_tile, _dropped_tiles)]
FAULTS += [("tiny-pt", f) for f in (_pt_unchanged, _pt_half_batch, _pt_altered)]


@pytest.mark.parametrize("workload, fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(tiny_bench, monkeypatch, workload, fault):
    fault(monkeypatch)
    rc, out, err = _run(tiny_bench, workload)
    line = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is False, err
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


# -- independence ------------------------------------------------------------

FORBIDDEN = ("jax", "jaxlib", "flax", "minipath_tpu")


@pytest.mark.parametrize("workload", ["tiny-frame", "tiny-pt"])
def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_bench, workload):
    """Every module a run loads, by whole top-level name (the port's name
    begins with the JAX package's, so a prefix test would be wrong)."""
    code = f"""
import io, sys, torch
sys.path.insert(0, {str(ROOT)!r})
from benchmark import run
from benchmark.harness import scene
from pathlib import Path
scene.CACHE = Path({str(tiny_bench.parent / 'cache')!r})
for path in sorted((Path({str(ROOT)!r}) / 'benchmark').glob('*/*.py')):
    if path.parent.name in ('metrics', 'drivers'):
        run.load_module(path)
assert run.run({workload!r}, 7, 0.2, True, device=torch.device('cpu'), bench_path=Path({str(tiny_bench)!r}),
               out=io.StringIO(), err=io.StringIO()) == 0
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "minipath_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    code = f"""
import sys
from pathlib import Path
sys.path.insert(0, {str(ROOT)!r})
import numpy as np, torch
from benchmark.reference import atrium, bvh, parity, trace
m = atrium.make_atrium(3000)
s = trace.prepare(bvh.build_tree(m.positions, m.triangles), m.positions, m.triangles, 'cpu')
vn = trace.shading_normals(m.positions, m.normals, m.triangles, 'cpu')
parity.render_pixels(s, vn, parity.look_at((-16, 4, 0), (10, 3, 0.5), 8.0, 0.036), (32, 32), 16, 2, 1,
                     np.array([[3, 4], [30, 31]]))
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert not loaded & {"minipath_tpu_torch", *FORBIDDEN}
