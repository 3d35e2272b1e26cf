"""The CUDA quantized traversal (K3) against its plain PyTorch version, on
the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package: ``python -m pytest --noconftest -q
tests/test_torch_cuda_q.py``.

K3 and its plain version decompress with the same separately rounded float32
steps and trace with the same rules (the library is built with
``-fmad=false``), so ``t``, ``tri``, ``u``, ``v``, the material and the
counters agree exactly in every mode, overflow included; the normal within
1e-4 (``rsqrtf`` against ``torch.rsqrt``). Frames on the card and on the CPU
agree as the f32 path's do (tests/test_torch_cuda_pt.py).
"""

import numpy as np
import pytest
import torch

from minipath_tpu_torch import Camera, TriangleBvh
from minipath_tpu_torch.geometry.ray import make_rays
from minipath_tpu_torch.render import kernels, kernels_q
from minipath_tpu_torch.render import wavefront as tw
from minipath_tpu_torch.render.frame import gen_frame_rays9, render_frame
from minipath_tpu_torch.scene import materials as tm
from minipath_tpu_torch.scene import procedural

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def atrium():
    mesh = procedural.make_atrium(20_000)
    ids, dicts = procedural.atrium_materials(mesh)
    return TriangleBvh.build(mesh, materials=ids, leaf_max=24), dicts


def _camera():
    return Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(36e-3)


def _camera_rays(device, B=16, P=2048, seed=0):
    w, h = 256, B * P // 256
    gen = torch.Generator(device=device).manual_seed(seed)
    r9, _ = gen_frame_rays9(_camera().build_sampler((w, h), device), gen, width=w, height=h, px_block=(16, 16),
                            samples=P // 256)
    return r9


def _incoherent(bvh, device, B=16, P=1024, seed=1):
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(bvh.host_arrays.bbox_min), np.asarray(bvh.host_arrays.bbox_max)
    o = rng.uniform(lo + 0.5, hi - 0.5, (B, P, 3)).astype(np.float32)
    d = rng.normal(size=(B, P, 3)).astype(np.float32)
    return kernels.rays_to_rays9(make_rays(torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)))


def _assert_same(got, want, fields):
    for name in fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


_COUNTERS = ("overflow", "inner_visits", "leaf_tests")


@pytest.mark.parametrize("rays", ["camera", "incoherent"])
def test_full_mode_matches_plain_version(cuda, atrium, rays):
    bvh, _ = atrium
    scene = bvh.quantized_scene(cuda)
    r9 = _camera_rays(cuda) if rays == "camera" else _incoherent(bvh, cuda)
    ss = bvh.recommended_stack_size
    before = kernels_q.trace_packets_q.launches["full"]
    got = kernels_q.trace_scene(scene, r9, stack_size=ss)
    torch.cuda.synchronize()
    assert kernels_q.trace_packets_q.launches["full"] == before + 1
    want = kernels_q.trace_packets_q_reference(scene, r9, stack_size=ss)
    _assert_same(got, want, ("t", "tri", "material") + _COUNTERS)
    torch.testing.assert_close(got.normal, want.normal, rtol=0, atol=1e-4)
    assert (got.tri >= 0).float().mean().item() > 0.5 and int(got.overflow.sum()) == 0


def test_lean_modes_and_live_count_match_plain_version(cuda, atrium):
    bvh, _ = atrium
    scene = bvh.quantized_pt_scene(cuda)
    r9 = _incoherent(bvh, cuda, B=8, seed=2)
    ss = bvh.recommended_stack_size
    live = torch.tensor([5], dtype=torch.int32, device=cuda)
    before = dict(kernels_q.trace_packets_q.launches)
    got = kernels_q.trace_packets_q(scene, r9, stack_size=ss, lean=True, live_packets=live)
    want = kernels_q.trace_packets_q_reference(scene, r9, stack_size=ss, lean=True, live_packets=live)
    _assert_same(got, want, ("t", "tri", "u", "v") + _COUNTERS)
    assert torch.all(got.tri[5:] == -1) and (got.tri[:5] >= 0).any()
    # Shadow segments of length 4 along the same rays, any-hit.
    s9 = torch.cat([r9[:, 0:3], r9[:, 3:6] * 4.0, r9[:, 6:9] / 4.0], dim=1).contiguous()
    kw = dict(stack_size=ss, lean=True, anyhit=True, t_max=tw._SHADOW_T_MAX)
    got = kernels_q.trace_packets_q(scene, s9, **kw)
    _assert_same(got, kernels_q.trace_packets_q_reference(scene, s9, **kw), ("t", "tri", "u", "v") + _COUNTERS)
    assert 0.05 < (got.tri >= 0).float().mean().item() < 0.95
    after = kernels_q.trace_packets_q.launches
    assert after["closest"] == before["closest"] + 1 and after["anyhit"] == before["anyhit"] + 1


def test_tiny_stack_overflow_matches_plain_version(cuda, atrium):
    bvh, _ = atrium
    scene = bvh.quantized_scene(cuda)
    r9 = _incoherent(bvh, cuda, B=4, seed=3)
    got = kernels_q.trace_packets_q(scene, r9, stack_size=3)
    want = kernels_q.trace_packets_q_reference(scene, r9, stack_size=3)
    _assert_same(got, want, ("t", "tri", "material") + _COUNTERS)
    assert int(got.overflow.sum()) > 0


def _tie_scene_and_rays(device, B=8):
    bvh = TriangleBvh.build(procedural.make_tie_lattice(), leaf_max=8)
    o, d = procedural.tie_lattice_rays(count=B * 256, seed=4)
    rays = make_rays(torch.from_numpy(o).view(B, 256, 3).to(device), torch.from_numpy(d).view(B, 256, 3).to(device))
    return bvh, kernels.rays_to_rays9(rays)


@pytest.mark.parametrize("stack_size", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("mode", ["full", "closest", "anyhit"])
@pytest.mark.parametrize("scene_name", ["ties", "atrium"])
def test_small_stacks_and_exact_ties_match_bit_for_bit(cuda, atrium, scene_name, mode, stack_size):
    """Duplicated boxes, coplanar duplicate triangles and stacks that
    overflow, with a live prefix: what the ordered push, the nearest child
    kept in registers, the frames read from ``node_frame`` and the leaf rows,
    and the inner-first loop could break unseen elsewhere."""
    if scene_name == "ties":
        bvh, r9 = _tie_scene_and_rays(cuda)
    else:
        bvh, r9 = atrium[0], _incoherent(atrium[0], cuda, B=8, P=256, seed=6)
    scene = bvh.quantized_pt_scene(cuda)
    lean, anyhit = mode != "full", mode == "anyhit"
    fields = (("t", "tri", "u", "v") if lean else ("t", "tri", "material")) + _COUNTERS
    live = torch.tensor([5], dtype=torch.int32, device=cuda)
    for kw in ({}, {"live_packets": live}, {"t_max": 2.5}):
        got = kernels_q.trace_packets_q(scene, r9, stack_size=stack_size, lean=lean, anyhit=anyhit, **kw)
        want = kernels_q.trace_packets_q_reference(scene, r9, stack_size=stack_size, lean=lean, anyhit=anyhit, **kw)
        _assert_same(got, want, fields)
        if not lean:
            torch.testing.assert_close(got.normal, want.normal, rtol=0, atol=1e-4)
    if stack_size <= 2:
        assert int(kernels_q.trace_packets_q(scene, r9, stack_size=stack_size).overflow.sum()) > 0


def test_a_leaf_at_the_root_takes_its_frame_from_its_row(cuda):
    """A scene of one leaf has no inner node: the root's frame is the stored
    scene box, riding in the leaf's own row."""
    bvh = TriangleBvh.build(procedural.make_quad(4.0))
    scene = bvh.quantized_scene(cuda)
    rng = np.random.default_rng(8)
    o = np.concatenate([rng.uniform(-3.0, 3.0, (2, 256, 2)), np.full((2, 256, 1), 3.0)], axis=-1).astype(np.float32)
    d = np.concatenate([rng.normal(0.0, 0.3, (2, 256, 2)), np.full((2, 256, 1), -1.0)], axis=-1).astype(np.float32)
    r9 = kernels.rays_to_rays9(make_rays(torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)))
    got = kernels_q.trace_packets_q(scene, r9, stack_size=4)
    _assert_same(got, kernels_q.trace_packets_q_reference(scene, r9, stack_size=4), ("t", "tri", "material") + _COUNTERS)
    assert (got.tri >= 0).any() and int(got.inner_visits.sum()) == 0


def test_frames_on_card_match_cpu(cuda, atrium):
    """The parity frame through ``trace_scene`` and a Sobol path-traced
    frame with NEE through ``make_pt_tracer``, both over the quantized
    layouts, on the card and on the CPU."""
    bvh, dicts = atrium
    ss = bvh.recommended_stack_size

    def parity(device):
        return render_frame(bvh.quantized_scene(device), _camera().build_sampler((64, 48), device), None,
                            width=64, height=48, spp=4, stack_size=ss, sobol=True, strat_seed=9).cpu()

    got, want = parity(cuda), parity("cpu")
    close = ((got - want).abs().amax(dim=-1) <= 1e-4).float().mean().item()
    assert close >= 0.99 and got[..., 3].mean().item() > 0.9

    def pt(device):
        scene = bvh.quantized_pt_scene(device)
        table = tm.material_table(dicts, device)
        tracer, _ = tw.make_pt_tracer(scene, stack_size=ss)
        shadow, _ = tw.make_pt_shadow_tracer(scene, stack_size=ss)
        lights = tm.build_light_table(bvh.host_arrays.tri_packets, bvh.host_arrays.tri_material, table)
        return tw.render_frame_pt(tracer, scene, table, _camera().build_sampler((32, 32), device), None, width=32,
                                  height=32, spp=4, bounces=3, samples_per_packet=4, sobol=True, shadow_rr=False,
                                  strat_seed=77, lights=lights, shadow_tracer=shadow).cpu()

    before = dict(kernels_q.trace_packets_q.launches)
    got = pt(cuda)
    assert all(kernels_q.trace_packets_q.launches[m] > before[m] for m in ("closest", "anyhit"))
    want = pt("cpu")
    assert torch.isfinite(got).all()
    close = ((got - want).abs().amax(dim=-1) <= 1e-3).float().mean().item()
    assert close >= 0.99, close
    torch.testing.assert_close(got[..., :3].mean(), want[..., :3].mean(), rtol=5e-3, atol=0)
