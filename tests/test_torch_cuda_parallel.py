"""Multi-device rendering and adaptive sampling on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package: ``python -m pytest --noconftest -q
tests/test_torch_cuda_parallel.py``. A mesh repeats ``cuda:0`` four times, so
each test runs four shards on one card, through the kernels.

- The sharded Sobol parity frame (K1) equals ``render_frame``'s bit for bit:
  every ray is a pure function of (pixel, sample, seed), and K1 traces one
  ray per thread, whatever the batch.
- ``render(mesh=)`` makes a dispatch's rays on ``mesh[0]`` and splits the
  trace: its image equals ``render()``'s, in tile and in frame mode.
- ``render_frame_pt_adaptive`` (K2 over a live prefix) keeps its budget:
  every pixel takes the pilot and one chunk, the mean takes the budget
  within one chunk.
"""

import numpy as np
import pytest
import torch

from minipath_tpu_torch import Camera, RenderSettings, Scene, TriangleBvh, render
from minipath_tpu_torch.render import kernels
from minipath_tpu_torch.render import wavefront as tw
from minipath_tpu_torch.render.adaptive import render_frame_pt_adaptive
from minipath_tpu_torch.render.frame import render_frame
from minipath_tpu_torch.scene import materials as tm
from minipath_tpu_torch.scene import procedural

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def bvh():
    return TriangleBvh.build(procedural.make_atrium(3000))


def _camera():
    return Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(36e-3)


def test_sharded_sobol_frame_equals_render_frame(cuda, bvh):
    w, h, spp = 320, 176, 8
    scene = bvh.kernel_scene(cuda)
    sampler = _camera().build_sampler((w, h), cuda)
    kw = dict(width=w, height=h, stack_size=bvh.recommended_stack_size, samples_per_packet=4)
    single = render_frame(scene, sampler, None, spp=spp, sobol=True, strat_seed=2024, **kw)
    kernels.trace_packets.launches = 0
    sharded = render_frame(scene, sampler, None, spp=spp, sobol=True, strat_seed=2024, mesh=(cuda,) * 4, **kw)
    assert kernels.trace_packets.launches == 4 * 2  # four shards, two chunks
    assert torch.equal(sharded, single)
    assert 0.05 < single[..., 3].mean().item()


@pytest.mark.parametrize("mode", ["tile", "frame"])
def test_render_mesh_equals_render(cuda, bvh, mode):
    settings = RenderSettings(tile_size=64, sample_count=4, resolution=(320, 176))
    cb = (lambda t, s: None) if mode == "tile" else None
    single = render(Scene(bvh), _camera(), settings, None, cb, device=cuda, seed=3)
    single.wait()
    sharded = render(Scene(bvh), _camera(), settings, None, cb, seed=3, mesh=(cuda,) * 4)
    sharded.wait()
    np.testing.assert_array_equal(single.image(), sharded.image())


def test_adaptive_budget_holds(cuda):
    mesh = procedural.make_atrium(3000)
    ids, dicts = procedural.atrium_materials(mesh)
    bvh = TriangleBvh.build(mesh, materials=ids, leaf_max=24)
    scene = bvh.pt_scene(cuda)
    table = tm.material_table(dicts, cuda)
    tracer, _ = tw.make_pt_tracer(scene, stack_size=bvh.recommended_stack_size)
    w, h, spp = 320, 176, 26
    kernels.trace_packets_pt.launches["closest"] = 0
    img, spp_map = render_frame_pt_adaptive(
        tracer, scene, table, _camera().build_sampler((w, h), cuda), torch.Generator(device=cuda).manual_seed(1),
        width=w, height=h, spp=spp, bounces=3, return_spp_map=True,
    )
    assert kernels.trace_packets_pt.launches["closest"] > 0
    assert img.shape == (h, w, 4) and torch.isfinite(img).all() and img[..., :3].mean() > 0
    assert spp_map.min().item() >= 10 and spp_map.max() > spp_map.min()
    assert abs(spp_map.mean().item() - spp) <= 8
