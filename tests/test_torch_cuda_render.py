"""``render(backend="portable")`` on the card against ``render()``.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package: ``python -m pytest --noconftest -q
tests/test_torch_cuda_render.py``.

The portable engine (``render/traversal.py``) and K1 share no traversal code
and agree on every triangle, but torch's CUDA ops contract the multiply-adds
that K1, built with ``-fmad=false``, rounds one by one: an RGB value may move
by one 8-bit level, on at most 0.1% of the values; alpha must be equal.
"""

import numpy as np
import pytest
import torch

from minipath_tpu_torch import Camera, RenderSettings, Scene, TriangleBvh, render
from minipath_tpu_torch.scene import procedural

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def atrium():
    return TriangleBvh.build(procedural.make_atrium(20_000))


CAMERA = Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(36e-3)


def _image(bvh, device, backend, callback=None, mesh=None):
    settings = RenderSettings(tile_size=32, sample_count=4, resolution=(128, 72))
    p = render(Scene(bvh), CAMERA, settings, finished_tile_callback=callback, device=None if mesh else device,
               seed=9, backend=backend, mesh=mesh)
    p.wait()
    return p.image()


@pytest.mark.parametrize("mode", ["frame", "tile"])
def test_portable_render_matches_the_kernel(cuda, atrium, mode):
    callback = None if mode == "frame" else (lambda tile, snapshot: None)
    want = _image(atrium, cuda, "kernel", callback)
    got = _image(atrium, cuda, "portable", callback)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert np.array_equal(got[..., 3], want[..., 3])
    assert diff[..., :3].max() <= 1 and (diff[..., :3] > 0).mean() <= 1e-3
    assert (want[..., 3] > 0).mean() > 0.9


def test_portable_render_over_a_mesh_is_bit_for_bit(cuda, atrium):
    meshed = _image(atrium, cuda, "portable", mesh=(cuda, cuda))
    assert np.array_equal(meshed, _image(atrium, cuda, "portable"))
