"""The CUDA traversal kernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where JAX is not installed:
``python -m pytest --noconftest -q tests/test_torch_cuda.py``.

The kernel and the plain version take the same IEEE steps in the same order
(the library is built with ``-fmad=false``), so ``t``, ``tri`` and the
counters agree exactly, overflow included; the normal within 1e-4
(``rsqrtf`` against ``torch.rsqrt``).
"""

import numpy as np
import pytest
import torch

from minipath_tpu_torch import Camera, RenderSettings, Scene, TriangleBvh, render
from minipath_tpu_torch.camera import sample_rays
from minipath_tpu_torch.geometry.ray import make_rays
from minipath_tpu_torch.render import integrator, kernels
from minipath_tpu_torch.render.frame import render_frame
from minipath_tpu_torch.scene import procedural
from minipath_tpu_torch.scene.obj_loader import MeshData

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def atrium():
    return TriangleBvh.build(procedural.make_atrium(20_000))


def _incoherent(bvh, device, B=32, P=256, seed=0):
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(bvh.host_arrays.bbox_min), np.asarray(bvh.host_arrays.bbox_max)
    o = rng.uniform(lo, hi, (B, P, 3)).astype(np.float32)
    d = rng.normal(size=(B, P, 3)).astype(np.float32)
    return kernels.rays_to_rays9(make_rays(torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)))


def _camera():
    return Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(36e-3)


def _coherent(device, B=16):
    sampler = _camera().build_sampler((256, 256), device)
    pix = integrator.tile_pixel_packets((64, 64), (64, 64), (16, 16), device)[:B]
    return kernels.rays_to_rays9(sample_rays(sampler, pix, torch.Generator(device=device).manual_seed(3)))


def _dispatch(device):
    """Rays as ``render()`` traces them: two 64 px tiles at 32 spp,
    sample-major packets of 16x16 px x 32 samples, (8, 9, 8192)."""
    sampler = _camera().build_sampler((256, 256), device)
    origins = torch.tensor([[64.0, 64.0], [128.0, 64.0]])
    gen = torch.Generator(device=device).manual_seed(5)
    return integrator.tile_batch_rays9(
        sampler, origins, gen, 7, tile_shape=(64, 64), packet_shape=(16, 16), spp=32
    )[:8]


def _assert_same(got, want, min_match=1.0):
    same = got.tri == want.tri
    assert same.float().mean().item() >= min_match
    assert torch.equal(got.t[same], want.t[same])
    torch.testing.assert_close(got.normal, want.normal, rtol=0, atol=1e-4)
    assert torch.equal(got.material, want.material)
    for name in ("overflow", "inner_visits", "leaf_tests"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("rays", ["incoherent", "coherent", "dispatch"])
def test_kernel_matches_plain_version(cuda, atrium, rays):
    scene = atrium.kernel_scene(cuda)
    r9 = {"incoherent": lambda: _incoherent(atrium, cuda), "coherent": lambda: _coherent(cuda),
          "dispatch": lambda: _dispatch(cuda)}[rays]()
    ss = atrium.recommended_stack_size
    before = kernels.trace_packets.launches
    got = kernels.trace_packets(scene, r9, stack_size=ss)
    torch.cuda.synchronize()
    assert kernels.trace_packets.launches == before + 1
    want = kernels.trace_packets_reference(scene, r9, stack_size=ss)
    _assert_same(got, want)
    assert (got.tri >= 0).float().mean().item() > 0.5
    assert int(got.overflow.sum()) == 0


def test_overflow_t_max_and_live_prefix_match(cuda, atrium):
    scene = atrium.kernel_scene(cuda)
    r9 = _incoherent(atrium, cuda, B=8, seed=1)
    for kw in (dict(stack_size=2), dict(stack_size=atrium.recommended_stack_size, t_max=5.0, live_packets=3)):
        got = kernels.trace_packets(scene, r9, **kw)
        want = kernels.trace_packets_reference(scene, r9, **kw)
        _assert_same(got, want)
    assert torch.all(got.tri[3:] == -1) and torch.all(got.t[3:] == 5.0)
    assert int(kernels.trace_packets(scene, r9, stack_size=2).overflow.min()) > 0


# The live count's forms and edge counts, each with the count as an int, for
# B = 8 packets (``tests/test_torch_kernels.py::LIVE_COUNTS`` on the CPU).
LIVE_COUNTS = {
    "none": (lambda dev: None, 8),
    "int": (lambda dev: 3, 3),
    "int32 tensor": (lambda dev: torch.tensor([3], dtype=torch.int32, device=dev), 3),
    "int64 tensor": (lambda dev: torch.tensor(3, dtype=torch.int64, device=dev), 3),
    "zero": (lambda dev: torch.tensor([0], dtype=torch.int32, device=dev), 0),
    "negative": (lambda dev: torch.tensor([-3], dtype=torch.int32, device=dev), -3),
    "above B": (lambda dev: torch.tensor([11], dtype=torch.int32, device=dev), 11),
}


@pytest.mark.parametrize("case", list(LIVE_COUNTS))
def test_live_count_on_the_device_makes_no_host_sync(cuda, atrium, case):
    """K1 reads its live count from device memory: a launch makes no host
    sync, and its hits equal those of the count given as an int bit for bit,
    and the plain version's."""
    make, count = LIVE_COUNTS[case]
    scene = atrium.kernel_scene(cuda)
    r9 = _incoherent(atrium, cuda, B=8, seed=2)
    ss = atrium.recommended_stack_size
    live = make(cuda)
    kernels.trace_packets(scene, r9, stack_size=ss)  # builds and loads the library
    torch.cuda.synchronize()
    before = kernels.trace_packets.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = kernels.trace_packets(scene, r9, stack_size=ss, live_packets=live)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kernels.trace_packets.launches == before + 1
    as_int = kernels.trace_packets(scene, r9, stack_size=ss, live_packets=count)
    for name in ("t", "tri", "normal", "material", "overflow", "inner_visits", "leaf_tests"):
        assert torch.equal(getattr(got, name), getattr(as_int, name)), name
    _assert_same(got, kernels.trace_packets_reference(scene, r9, stack_size=ss, live_packets=live))
    n = max(0, min(8, count))
    assert torch.all(got.tri[n:] == -1) and torch.all(got.inner_visits[n:] == 0)
    assert bool((got.tri[:n] >= 0).any()) == (n > 0)


def _tie_rays9(device, B=8):
    o, d = procedural.tie_lattice_rays(count=B * 256, seed=4)
    rays = make_rays(torch.from_numpy(o).view(B, 256, 3).to(device), torch.from_numpy(d).view(B, 256, 3).to(device))
    return kernels.rays_to_rays9(rays)


@pytest.mark.parametrize("stack_size", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("scene_name", ["ties", "atrium"])
def test_small_stacks_and_exact_ties_match_bit_for_bit(cuda, atrium, scene_name, stack_size):
    """Duplicated boxes, coplanar duplicate triangles and stacks that
    overflow: what the ordered push, the nearest child kept in registers
    and the inner-first loop could break unseen elsewhere."""
    bvh = atrium if scene_name == "atrium" else TriangleBvh.build(procedural.make_tie_lattice(), leaf_max=8)
    scene = bvh.kernel_scene(cuda)
    r9 = _tie_rays9(cuda) if scene_name == "ties" else _incoherent(bvh, cuda, B=8, seed=6)
    for kw in ({}, {"live_packets": 5}, {"t_max": 2.5}):
        got = kernels.trace_packets(scene, r9, stack_size=stack_size, **kw)
        want = kernels.trace_packets_reference(scene, r9, stack_size=stack_size, **kw)
        _assert_same(got, want)
    assert (got.tri >= 0).any()
    if stack_size <= 2:
        assert int(kernels.trace_packets(scene, r9, stack_size=stack_size).overflow.sum()) > 0


def test_empty_scene_and_odd_packet_size(cuda, atrium):
    empty = TriangleBvh.build(MeshData()).kernel_scene(cuda)
    r9 = _incoherent(atrium, cuda, B=3, P=100)
    got = kernels.trace_packets(empty, r9, stack_size=8)
    assert torch.all(got.tri == -1) and torch.all(torch.isinf(got.t))
    assert torch.all(got.inner_visits == 0)
    # P not a multiple of the warp: the counters take the per-thread path.
    scene = atrium.kernel_scene(cuda)
    _assert_same(
        kernels.trace_packets(scene, r9, stack_size=atrium.recommended_stack_size),
        kernels.trace_packets_reference(scene, r9, stack_size=atrium.recommended_stack_size),
    )


def test_frame_on_card_matches_frame_on_cpu(cuda, atrium):
    """Sobol mode: the same rays on both devices, so the frames agree up to
    float32 rounding of the camera math on each device."""
    kw = dict(width=48, height=32, spp=4, stack_size=atrium.recommended_stack_size, sobol=True, strat_seed=99)
    sampler_cpu = _camera().build_sampler((48, 32), "cpu")
    want = render_frame(atrium.kernel_scene("cpu"), sampler_cpu, None, **kw)
    got = render_frame(atrium.kernel_scene(cuda), _camera().build_sampler((48, 32), cuda), None, **kw).cpu()
    close = (got - want).abs().amax(dim=-1) <= 1e-5
    assert close.float().mean().item() >= 0.999
    torch.testing.assert_close(got.mean(dim=(0, 1)), want.mean(dim=(0, 1)), rtol=0, atol=1e-4)


def test_render_on_card_launches_the_kernel(cuda, atrium):
    before = kernels.trace_packets.launches
    p = render(Scene(atrium), _camera(), RenderSettings(32, 8, (96, 64)), device=cuda)
    p.wait()
    img = p.image()
    assert kernels.trace_packets.launches > before
    assert p.progress().finished == p.progress().total == 6
    assert img.shape == (64, 96, 4) and (img[..., 3] > 0).mean() > 0.9
