"""The camera-ray kernel (``csrc/camera.cu``) on the card, against the plain
chain it replaces.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package: ``python -m pytest --noconftest -q
tests/test_torch_cuda_camera.py``.

Both versions run on the card from one generator seed: the plain chain
(``camera.py::sample_rays`` with its strata, then
``render/kernels.py::rays_to_rays9``) and ``render/frame.py::packet_rays9``,
which draws the same two ``torch.rand`` tensors and launches the kernel. The
kernel's arithmetic is the plain chain's, op for op, rounded as PyTorch's
CUDA kernels round it (the library is built with ``-fmad=false``), so the
``(B, 9, P)`` rays agree bit for bit (``torch.equal``) in both layouts that
call it: the tile integrator's (``tile_batch_rays9``) and the frame blocks'
(``gen_rays9_blocks``), in every sampling mode.
"""

import pytest
import torch

from minipath_tpu_torch import Camera, RenderSettings, Scene, TriangleBvh, render
from minipath_tpu_torch.render import camera_rays, frame, integrator
from minipath_tpu_torch.render.kernels import rays_to_rays9
from minipath_tpu_torch.scene import procedural
from minipath_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

# A frame whose 64-px tiles and 16-px blocks overhang its right and bottom
# edges.
W, H = 200, 136
TILE_ORIGINS = [[0.0, 0.0], [128.0, 64.0], [192.0, 64.0], [192.0, 128.0]]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _sampler(camera, device, size=(W, H)):
    if camera == "bench":
        return Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(
            36e-3).build_sampler(size, device)
    axis = Camera().look_direction((0.0, 2.0, 0.0), (0.0, 0.0, -1.0)).build_sampler(size, device)
    if camera == "axis":
        return axis
    # A pinhole with its film shrunk to a point, looking down -Z: every ray
    # runs along the axis, its x and y components zero (+inf inverted).
    zero = torch.zeros((), device=device)
    return axis._replace(pixel_scale=zero, lens_radius=zero,
                         film_origin_offset=torch.tensor([0.0, 0.0, 0.05], device=device))


def _plain_blocks(sampler, generator, block_start, **kw):
    with pytest.MonkeyPatch.context() as m:
        m.setattr(frame, "uses_camera_kernel", lambda device: False)
        return frame.gen_rays9_blocks(sampler, generator, block_start, **kw)


def _assert_equal(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype and got.is_contiguous()
    differ = (got != want).any(dim=1)
    assert not differ.any(), f"{int(differ.sum())} of {differ.numel()} lanes differ"
    assert torch.equal(got, want)


@pytest.mark.parametrize("camera", ["bench", "axis", "pinhole-axis"])
@pytest.mark.parametrize("seed", [-1_234_567_891, 7_654_321])
@pytest.mark.parametrize("spp", [1, 7, 32, 64])
def test_tile_layout_matches_plain_chain(cuda, spp, seed, camera):
    """``render()``'s dispatches: 64-px tiles of 16x16-px packets, one of them
    at the frame's right and bottom edges with its padded rows."""
    sampler, origins = _sampler(camera, cuda), torch.tensor(TILE_ORIGINS, device=cuda)
    shape = dict(tile_shape=(64, 64), packet_shape=(16, 16), spp=spp)
    g_kernel, g_plain = torch.Generator(device=cuda).manual_seed(11), torch.Generator(device=cuda).manual_seed(11)
    before = camera_rays.launch.launches
    got = integrator.tile_batch_rays9(sampler, origins, g_kernel, seed, **shape)
    assert camera_rays.launch.launches == before + 1
    want = rays_to_rays9(integrator.tile_batch_rays(sampler, origins, g_plain, seed, **shape))
    _assert_equal(got, want)
    assert torch.equal(g_kernel.get_state(), g_plain.get_state())
    if camera == "pinhole-axis":
        assert torch.isinf(got[:, 6:8]).all() and torch.isfinite(got[:, 8]).all()


BLOCK_CASES = {
    # name: (strat_spp, strat_offset, samples, block_ids)
    "iid": (None, 0, 4, None),
    "strat-1": (1, 0, 1, None),
    "strat-7": (7, 3, 4, None),
    "strat-32": (32, 16, 8, None),
    "strat-64": (64, 56, 8, None),
    "sobol": (-16, 8, 8, None),
    "strat-block-ids": (64, 8, 8, [116, 0, 37, 12, 104, 64]),
    "sobol-block-ids": (-16, 4, 4, [100, 2, 99]),
}


@pytest.mark.parametrize("camera", ["bench", "pinhole-axis"])
@pytest.mark.parametrize("seed", [-99, 2_000_000_011])
@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_layout_matches_plain_chain(cuda, case, seed, camera):
    """The path tracer's and ``render_frame``'s packets: 16x16-px blocks of a
    frame padded to whole blocks, a contiguous range from block 5 or the
    blocks ``block_ids`` names (the adaptive sampler's order), each chunk's
    first sample at ``strat_offset``."""
    strat_spp, offset, samples, ids = BLOCK_CASES[case]
    sampler, wc = _sampler(camera, cuda), -(-W // 16)
    block_ids = None if ids is None else torch.tensor(ids, device=cuda)
    kw = dict(block_count=(-(-H // 16) * wc - 5) if ids is None else len(ids), wc=wc, px_block=(16, 16),
              samples=samples, strat_spp=strat_spp, strat_offset=offset, strat_seed=seed, block_ids=block_ids)
    g_kernel, g_plain = torch.Generator(device=cuda).manual_seed(12), torch.Generator(device=cuda).manual_seed(12)
    got = frame.gen_rays9_blocks(sampler, g_kernel, 5, **kw)
    want = _plain_blocks(sampler, g_plain, 5, **kw)
    _assert_equal(got, want)
    assert torch.equal(g_kernel.get_state(), g_plain.get_state())


def test_dispatch_rays_of_the_traversal_tests_unchanged(cuda):
    """``tests/test_torch_cuda.py::_dispatch``'s rays, which its K1 checks
    trace, are the plain chain's: two 64-px tiles at 32 spp from origins
    that lie on the host."""
    sampler = Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(
        36e-3).build_sampler((256, 256), cuda)
    origins = torch.tensor([[64.0, 64.0], [128.0, 64.0]])
    shape = dict(tile_shape=(64, 64), packet_shape=(16, 16), spp=32)
    got = integrator.tile_batch_rays9(sampler, origins, torch.Generator(device=cuda).manual_seed(5), 7, **shape)
    want = rays_to_rays9(integrator.tile_batch_rays(sampler, origins, torch.Generator(device=cuda).manual_seed(5), 7,
                                                    **shape))
    _assert_equal(got, want)


def test_kernel_lanes_counter_equals_each_launch_and_the_frame(cuda):
    """``camera.kernel_lanes`` adds each launch's ``B x P``; over a
    ``render()`` frame in tile mode it equals the rays traced: every tile's
    64 x 64 pixels (the edge tiles padded) times the samples."""
    sampler = _sampler("bench", cuda)
    profiling.take()
    profiling.enable()
    try:
        rays9 = integrator.tile_batch_rays9(sampler, torch.tensor(TILE_ORIGINS, device=cuda),
                                            torch.Generator(device=cuda).manual_seed(1), 3, tile_shape=(64, 64),
                                            packet_shape=(16, 16), spp=4)
        one = profiling.take().counters
        frame.gen_rays9_blocks(sampler, None, 0, block_count=7, wc=13, px_block=(16, 16), samples=2, strat_spp=-8,
                               strat_seed=1)
        two = profiling.take().counters
        bvh = TriangleBvh.build(procedural.make_atrium(0))
        camera = Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(36e-3)
        before = camera_rays.launch.launches
        profiling.take()
        progress = render(Scene(bvh), camera, RenderSettings(tile_size=64, sample_count=40, resolution=(W, H)),
                          device=cuda, finished_tile_callback=lambda *a: None)
        progress.wait()
        rec = profiling.take()
    finally:
        profiling.disable()
    B, _, P = rays9.shape
    assert one["camera.kernel_lanes"] == B * P == len(TILE_ORIGINS) * 64 * 64 * 4
    assert two["camera.kernel_lanes"] == 7 * 256 * 2
    tiles = -(-W // 64) * -(-H // 64)
    # One launch a pass of each dispatch: 32 and 8 samples.
    assert camera_rays.launch.launches == before + 2
    assert rec.counters["camera.kernel_lanes"] == tiles * 64 * 64 * 40
    assert any(sp.name == "render.ray_gen" for sp in rec.spans)
