"""The estimator against the JAX package's, and the gates of the large-scene
and estimator tools, on the CPU.

- The two-seed statistic: on a 20k-triangle atrium with its materials at
  32x24 @ 16 spp, 5 bounces, the sky and the benchmark camera, the RMSE
  between the frames of two seeds, averaged over three seed pairs, is
  within 15% of the JAX package's. Both packages use independent random
  streams, so only the statistic can agree; at 16 spp it is near 0.27 on
  both sides. The JAX side traces with ``make_xla_tracer``; the port with
  K2's plain version: its portable engine (``make_portable_tracer``)
  computes the same hits, tests/test_torch_portable.py, but takes over a
  minute a frame on the CPU, where the six frames through K2's plain
  version take seconds.
- Each of ``parity_big``, ``bench_quality``, ``demo_bigscene`` and
  ``demo_hugescene`` exits 1 when its kernel engine is replaced by a wrong
  one (every ray a miss, nothing occluded), after printing its JSON line.
"""

import contextlib
import io
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minipath_tpu import camera as jax_camera
from minipath_tpu.render import wavefront as jw
from minipath_tpu.scene import materials as jm
from minipath_tpu.scene import procedural as jax_procedural
from minipath_tpu.scene.bvh.build import BvhArrays as JaxBvhArrays
from minipath_tpu.scene.bvh.build import build_bvh as jax_build_bvh
from minipath_tpu_torch.camera import CameraSampler
from minipath_tpu_torch.render import kernels, kernels_q
from minipath_tpu_torch.render import wavefront as tw
from minipath_tpu_torch.scene import materials as tm
from minipath_tpu_torch.scene.bvh.build import from_numpy
from minipath_tpu_torch.tools import bench_quality, common, demo_bigscene, demo_hugescene, parity_big
from minipath_tpu_torch.utils import cuda_build
from test_torch_tools import QUALITY_TINY

W, H, SPP, BOUNCES = 32, 24, 16, 5
SEED_PAIRS = ((0, 1), (2, 3), (4, 5))
RMSE_RTOL = 0.15


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rmse(a, b) -> float:
    return float(np.sqrt(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)))


def test_two_seed_rmse_matches_jax():
    mesh = jax_procedural.make_atrium(20_000)
    ids, dicts = jax_procedural.atrium_materials(mesh)
    res = jax_build_bvh(mesh, materials=ids, leaf_max=24)
    stack = res.recommended_stack_size
    kw = dict(width=W, height=H, spp=SPP, bounces=BOUNCES, samples_per_packet=8)
    camera = jax_camera.Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(36e-3)
    jsampler = camera.build_sampler((W, H))
    jarrays = JaxBvhArrays(*(jnp.asarray(a) for a in res.arrays))
    jtracer, _ = jw.make_xla_tracer(jarrays, stack_size=stack)
    jtable = jm.material_table(dicts)

    def jax_frame(seed):
        return np.asarray(jw.render_frame_pt(jtracer, jarrays, jtable, jsampler, jax.random.key(seed),
                                             env=jm.Environment.sky(), **kw))[..., :3]

    scene = kernels.prepare_scene_pt(from_numpy(res.arrays._asdict(), "cpu"))
    tracer, _ = tw.make_pt_tracer(scene, stack_size=stack)
    table = tm.material_table(dicts, "cpu")
    sampler = CameraSampler.from_numpy({k: np.asarray(v) for k, v in jsampler._asdict().items()}, "cpu")

    def port_frame(seed):
        return tw.render_frame_pt(tracer, scene, table, sampler, torch.Generator().manual_seed(seed),
                                  env=tm.Environment.sky("cpu"), **kw).numpy()[..., :3]

    stats = {}
    for name, frame in (("jax", jax_frame), ("port", port_frame)):
        frames = {s: frame(s) for pair in SEED_PAIRS for s in pair}
        assert all(np.isfinite(f).all() and f.mean() > 0.5 for f in frames.values())
        stats[name] = np.mean([_rmse(frames[a], frames[b]) for a, b in SEED_PAIRS])
    assert 0.1 < stats["jax"] < 0.5
    np.testing.assert_allclose(stats["port"], stats["jax"], rtol=RMSE_RTOL)


def _miss(kh):
    return kh._replace(tri=torch.full_like(kh.tri, -1), t=torch.full_like(kh.t, math.inf))


def _wrong_pt_tracers(monkeypatch):
    """Every kernel tracer (not the portable engine) made wrong: all misses,
    nothing occluded."""
    inner = common.pt_tracers

    def wrong(bvh, device, engine):
        tracer, shadow, state = inner(bvh, device, engine)
        if engine == "portable":
            return tracer, shadow, state
        return (lambda *a, **k: _miss(tracer(*a, **k))), (lambda *a, **k: torch.zeros_like(shadow(*a, **k))), state

    monkeypatch.setattr(common, "pt_tracers", wrong)


def _wrong_trace_scene(monkeypatch):
    inner = kernels_q.trace_scene
    monkeypatch.setattr(kernels_q, "trace_scene", lambda *a, **k: _miss(inner(*a, **k)))


WRONG = {
    "parity_big": (parity_big, ["2000", "32", "16", "1"], _wrong_pt_tracers),
    "bench_quality": (bench_quality, ["32", "16", "16"], _wrong_pt_tracers),
    "demo_bigscene": (demo_bigscene, ["2000", "32", "16", "2"], _wrong_trace_scene),
    "demo_hugescene": (demo_hugescene, ["2000", "32", "16", "2"], _wrong_trace_scene),
}


@pytest.mark.parametrize("name", list(WRONG))
def test_gates_fail_on_a_wrong_engine(monkeypatch, tmp_path_factory, name):
    tool, size, break_engine = WRONG[name]
    cache = tmp_path_factory.getbasetemp() / "quality_tools_cache"
    cache.mkdir(exist_ok=True)
    monkeypatch.setattr(cuda_build, "bench_cache_dir", lambda: cache)
    monkeypatch.setattr(demo_bigscene, "TIMED_FRAMES", 1)
    for key, value in QUALITY_TINY.items():
        monkeypatch.setattr(bench_quality, key, value)
    break_engine(monkeypatch)
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        rc = tool.main(["--device", "cpu", *size])
    assert rc == 1
    got = json.loads(said.getvalue().splitlines()[-1])
    assert got["gates_failed"], got
