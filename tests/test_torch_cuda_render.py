"""``render(backend="portable")`` on the card against ``render()``, and
``render()``'s frame mode at a tile size off the packet's 16 pixels.

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


def _image(bvh, device, backend, callback=None, mesh=None, tile_size=32):
    settings = RenderSettings(tile_size=tile_size, sample_count=4, resolution=(128, 72))
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


def test_frame_mode_off_the_packet_size_is_deterministic(cuda, atrium):
    """At ``tile_size`` 40 each tile is traced at 48 px and placed at its own
    extent: the frame's writes are disjoint, so two frame-mode renders with
    one seed are equal bit for bit (a CUDA scatter leaves the winner of a
    duplicate index unspecified), and equal to tile mode's."""
    first = _image(atrium, cuda, "kernel", tile_size=40)
    assert np.array_equal(first, _image(atrium, cuda, "kernel", tile_size=40))
    assert np.array_equal(first, _image(atrium, cuda, "kernel", lambda tile, snapshot: None, tile_size=40))


def test_tile_mode_waits_only_for_its_fetches(cuda, atrium, monkeypatch):
    """A tile-mode ``render()`` never synchronizes the card: its host waits
    are one copy of each dispatch's tiles (``render.fetch``) and nothing
    else. 128x72 at 16-px tiles is 40 tiles, at most 8 a dispatch in the
    test's settings: 5 dispatches, 5 copies."""
    from minipath_tpu_torch.render import machinery

    monkeypatch.setattr(machinery, "MAX_RAYS_PER_DISPATCH", 8 * 16 * 16 * 4)
    settings = RenderSettings(tile_size=16, sample_count=4, resolution=(128, 72))

    def tile_render():
        p = render(Scene(atrium), CAMERA, settings, finished_tile_callback=lambda tile, snapshot: None,
                   device=cuda, seed=9)
        p.wait()
        return p, p.image()

    tile_render()  # the scene's upload and the kernel's build
    calls = {"synchronize": 0, "cpu": 0, "item": 0, "tolist": 0}
    for owner, name in ((torch.cuda, "synchronize"), (torch.Tensor, "cpu"), (torch.Tensor, "item"),
                        (torch.Tensor, "tolist")):
        real = getattr(owner, name)

        def counted(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(owner, name, counted)
    p, image = tile_render()
    assert (image[..., 3] > 0).mean() > 0.9
    assert p.timings().summary()["fetch"]["count"] == 5
    assert calls == {"synchronize": 0, "cpu": 5, "item": 0, "tolist": 0}
