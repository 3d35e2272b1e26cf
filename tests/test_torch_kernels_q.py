"""The port's quantized traversal (K3's plain version) against the JAX
package's ``trace_packets_pallas_q`` in interpret mode, against brute force,
against the port's f32 kernels, and the layout rule.

Tolerances, each with its reason:

- Against the JAX kernel, on the JAX package's own quantized words (fed in
  through ``quantized_scene_from_numpy``): hit masks equal on every ray;
  ``tri`` equal on at least 99.9% of rays (the JAX kernel walks a packet in
  its own child order, the port a ray in K1's, so an exact tie may go
  either way); ``t`` within 1e-5 relative on at least 99% of hits and
  within 1e-4 relative or 1e-6 absolute on all; ``u`` and ``v`` within 1e-5
  on at least 98% of hits and within 1e-3 on all; normals within 1e-4 and
  materials equal where ``tri`` matches. Both sides take the same float32
  steps, but XLA:CPU contracts every multiply-add of the decompression and
  of Möller–Trumbore into one fused step, which the port rounds in two: a
  decompressed vertex moves by an ulp of its coordinate, which a small
  triangle seen from afar, or a grazing hit, magnifies in ``u``, ``v`` and
  ``t``. Any-hit: the occlusion masks are equal on every ray (the JAX kernel
  may report another occluder).
- Against brute force over ``decompress_scene``'s vertices: exact. The plain
  version decompresses with the same steps as that NumPy walk.
- Against the port's f32 K1 and K2: the JAX package's quantization
  tolerances (``tests/test_quantize.py``): hit decisions equal on 99% of
  rays, ``t`` within 2e-3 absolute + 1e-3 relative, normals within 0.04.
- The seed-matched Sobol frames: at least 98% of pixels within 1e-4 per
  channel and the image means within 1e-3 relative, as for the f32 frames.

The CUDA kernel is held to its plain version, bit for bit, on the card in
``tests/test_torch_cuda_q.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minipath_tpu import camera as jax_camera
from minipath_tpu.render import wavefront as jw
from minipath_tpu.render.frame import render_frame_pallas
from minipath_tpu.render.pallas_kernels import prepare_scene_qpt as jax_prepare_scene_qpt
from minipath_tpu.render.pallas_kernels import prepare_scene_quantized as jax_prepare_scene_quantized
from minipath_tpu.render.pallas_kernels import trace_packets_pallas_q
from minipath_tpu.render.stratify import render_seed
from minipath_tpu.scene import materials as jm
from minipath_tpu.scene import procedural as jax_procedural
from minipath_tpu.scene.bvh.build import build_bvh as jax_build_bvh
from minipath_tpu.scene.bvh.quantize import build_quantized_scene as jax_build_quantized_scene
from minipath_tpu.scene.bvh.quantize import decompress_scene
from minipath_tpu_torch import Camera, RenderSettings, Scene, render
from minipath_tpu_torch.camera import CameraSampler
from minipath_tpu_torch.geometry.ray import make_rays
from minipath_tpu_torch.render import kernels, kernels_q
from minipath_tpu_torch.render import wavefront as tw
from minipath_tpu_torch.render.frame import render_frame
from minipath_tpu_torch.scene import materials as tm
from minipath_tpu_torch.scene import procedural
from minipath_tpu_torch.scene import triangle_bvh
from minipath_tpu_torch.scene.bvh import links as L
from minipath_tpu_torch.scene.bvh.build import from_numpy
from minipath_tpu_torch.scene.obj_loader import MeshData
from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh

P = 256  # rays per packet


def _port_scene(words, device="cpu"):
    return kernels_q.quantized_scene_from_numpy({k: np.asarray(v) for k, v in words._asdict().items()}, device)


@pytest.fixture(scope="module")
def atrium():
    """``make_atrium(0)`` with the benchmark materials and leaves of up to 24
    triangles: ``(build, JAX QuantizedPallasScene, the port's
    QuantizedScene of the same words)``."""
    mesh = jax_procedural.make_atrium(0)
    ids, _ = jax_procedural.atrium_materials(mesh)
    res = jax_build_bvh(mesh, materials=ids, leaf_max=24)
    jscene = jax_prepare_scene_quantized(res.arrays)
    return res, jscene, _port_scene(jscene)


def _rays9(o, d, inv=None):
    """(B, P, 3) float32 arrays -> the port's (B, 9, P) and the JAX kernel's
    (B, 9, P/128, 128), the same values. Without ``inv`` the direction is
    normalized (``make_rays``)."""
    if inv is None:
        rays = make_rays(torch.from_numpy(o), torch.from_numpy(d))
        d, inv = rays.direction.numpy(), rays.inv_direction.numpy()
    r9 = np.ascontiguousarray(np.swapaxes(np.concatenate([o, d, inv], -1), 1, 2).astype(np.float32))
    return torch.from_numpy(r9), jnp.asarray(r9.reshape(r9.shape[0], 9, P // 128, 128))


def _ray_sets(res):
    """Random rays in the hall, coherent pinhole rays down the colonnade,
    and shadow segments from points in the hall to its ceiling and walls."""
    rng = np.random.default_rng(7)
    lo, hi = np.asarray(res.arrays.bbox_min), np.asarray(res.arrays.bbox_max)
    random_o = rng.uniform(lo + 0.5, hi - 0.5, (2, P, 3)).astype(np.float32)
    random_d = rng.normal(size=(2, P, 3)).astype(np.float32)
    ys, xs = np.mgrid[0:16, 0:32].astype(np.float32)
    d = np.stack([np.full_like(xs, 1.0), 0.4 - ys / 20.0, xs / 40.0 - 0.4], -1).reshape(2, P, 3)
    coherent_o = np.broadcast_to(np.float32([-16.0, 4.0, 0.0]), d.shape).copy()
    target = rng.uniform(lo + 0.1, hi - 0.1, (2, P, 3)).astype(np.float32)
    target[..., 1] = np.where(rng.uniform(size=(2, P)) < 0.5, hi[1] - 1e-3, target[..., 1])
    seg = (target - random_o).astype(np.float32)
    inv = np.where(seg == 0.0, np.inf, 1.0 / np.where(seg == 0.0, 1.0, seg)).astype(np.float32)
    return {
        "random": _rays9(random_o, random_d),
        "coherent": _rays9(coherent_o, d.astype(np.float32)),
        "shadow": _rays9(random_o, seg, inv),
    }


def _check_hits(got, want, lean):
    tri, wtri = got.tri.numpy(), np.asarray(want.tri)
    np.testing.assert_array_equal(tri >= 0, wtri >= 0)
    same = tri == wtri
    assert same.mean() >= 0.999, same.mean()
    hit = wtri >= 0
    t, wt = got.t.numpy()[hit], np.asarray(want.t)[hit]
    rel = np.abs(t - wt) / wt
    assert (rel <= 1e-5).mean() >= 0.99, (rel <= 1e-5).mean()
    np.testing.assert_allclose(t, wt, rtol=1e-4, atol=1e-6)
    both = same & hit
    if lean:
        for a, b in ((got.u.numpy(), want.u), (got.v.numpy(), want.v)):
            err = np.abs(a - np.asarray(b))[both]
            assert (err <= 1e-5).mean() >= 0.98, (err <= 1e-5).mean()
            assert err.max() <= 1e-3, err.max()
    else:
        np.testing.assert_allclose(got.normal.numpy()[both], np.asarray(want.normal)[both], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(got.material.numpy()[both], np.asarray(want.material)[both])


@pytest.mark.parametrize(
    "mode,rays",
    [("full", "random"), ("full", "coherent"), ("closest", "random"), ("closest", "coherent"), ("anyhit", "shadow")],
)
def test_matches_jax_kernel(atrium, mode, rays):
    res, jscene, scene = atrium
    r9, jr9 = _ray_sets(res)[rays]
    ss = res.recommended_stack_size
    lean, anyhit = mode != "full", mode == "anyhit"
    kw = dict(stack_size=ss, lean=lean, anyhit=anyhit, t_max=(1.0 - 1e-5) if anyhit else np.inf)
    got = kernels_q.trace_packets_q(scene, r9, **kw)
    want = trace_packets_pallas_q(jscene, jr9, interpret=True, **kw)
    assert isinstance(got, kernels.PTHits if lean else kernels.KernelHits)
    assert np.all(got.overflow.numpy() == 0) and np.all(got.inner_visits.numpy() > 0)
    if anyhit:
        occ = got.tri.numpy() >= 0
        np.testing.assert_array_equal(occ, np.asarray(want.tri) >= 0)
        assert 0.1 < occ.mean() < 0.95
        # Any-hit finds a hit exactly where closest-hit finds one under t_max.
        closest = kernels_q.trace_packets_q(scene, r9, **dict(kw, anyhit=False))
        np.testing.assert_array_equal(occ, closest.tri.numpy() >= 0)
        assert np.all(got.leaf_tests.numpy() <= closest.leaf_tests.numpy())
    else:
        _check_hits(got, want, lean)
        assert (got.tri.numpy() >= 0).mean() > 0.5


def _brute_force(verts, r9):
    """Closest hit of every ray against every packet of ``verts`` ``(M, 8, 3,
    3)``, with the plain traversal's Möller–Trumbore steps, packet by
    packet."""
    v = torch.from_numpy(verts)
    v0 = v[:, :, 0]
    rows = torch.cat([v0, v[:, :, 1] - v0, v[:, :, 2] - v0], dim=-1)
    B, _, Pk = r9.shape
    R = B * Pk
    r = r9.permute(0, 2, 1).reshape(R, 9)
    best_t = torch.full((R,), np.inf)
    best_tri = torch.full((R,), -1, dtype=torch.int64)
    best_u, best_v = torch.zeros(R), torch.zeros(R)
    a = torch.arange(R)
    for pk in range(rows.shape[0]):
        kernels._leaf_packet(rows, torch.full((R,), pk), a, r[:, 0:3], r[:, 3:6], best_t, best_tri, best_u, best_v)
    return best_t.view(B, Pk), best_tri.view(B, Pk)


def test_matches_brute_force_over_decompressed_vertices():
    res = jax_build_bvh(jax_procedural.make_random_triangles(700, seed=13))
    words = jax_build_quantized_scene(res.arrays)
    scene = _port_scene(words)
    _, _, verts, _ = decompress_scene(words)
    rng = np.random.default_rng(3)
    o = rng.uniform(-12, 12, (3, P, 3)).astype(np.float32)
    r9, _ = _rays9(o, (rng.uniform(-6, 6, (3, P, 3)) - o).astype(np.float32))
    got = kernels_q.trace_packets_q(scene, r9, stack_size=res.recommended_stack_size)
    t, tri = _brute_force(verts, r9)
    assert (tri >= 0).float().mean() > 0.2
    assert torch.equal(got.tri, tri.to(torch.int32)) and torch.equal(got.t, t)


def test_against_the_f32_kernels():
    """K3 against K1 (full) and K2 (lean) on a UV sphere: the same hits up to
    quantization."""
    mesh = procedural.make_uv_sphere(1.0, rings=14, segments=22)
    bvh = TriangleBvh.build(mesh, materials=np.arange(mesh.triangle_count, dtype=np.int32) % 7)
    ss = bvh.recommended_stack_size
    rng = np.random.default_rng(11)
    o = np.tile(np.float32([0, 0, -4]), (2, P, 1))
    d = (np.float32([0, 0, 1]) + 0.25 * rng.normal(size=(2, P, 3))).astype(np.float32)
    r9, _ = _rays9(o, d)
    pairs = (
        (kernels.trace_packets(bvh.kernel_scene("cpu"), r9, stack_size=ss),
         kernels_q.trace_packets_q(bvh.quantized_scene("cpu"), r9, stack_size=ss)),
        (kernels.trace_packets_pt(bvh.pt_scene("cpu"), r9, stack_size=ss),
         kernels_q.trace_packets_q(bvh.quantized_pt_scene("cpu"), r9, stack_size=ss, lean=True)),
    )
    for a, b in pairs:
        hit_a, hit_b = a.tri.numpy() >= 0, b.tri.numpy() >= 0
        assert (hit_a == hit_b).mean() > 0.99 and hit_a.mean() > 0.3
        both = hit_a & hit_b
        np.testing.assert_allclose(a.t.numpy()[both], b.t.numpy()[both], atol=2e-3, rtol=1e-3)
    full, q = pairs[0]
    both = (full.tri.numpy() >= 0) & (q.tri.numpy() >= 0)
    assert np.abs(full.normal.numpy()[both] - q.normal.numpy()[both]).max() < 0.04
    same = both & (full.tri.numpy() == q.tri.numpy())
    np.testing.assert_array_equal(full.material.numpy()[same], q.material.numpy()[same])


def test_live_packets_overflow_and_empty_scene(atrium):
    res, _, scene = atrium
    r9, _ = _ray_sets(res)["random"]
    ss = res.recommended_stack_size
    for lean in (False, True):
        full = kernels_q.trace_packets_q(scene, r9, stack_size=ss, lean=lean)
        as_int = kernels_q.trace_packets_q(scene, r9, stack_size=ss, lean=lean, live_packets=1)
        as_tensor = kernels_q.trace_packets_q(scene, r9, stack_size=ss, lean=lean, live_packets=torch.tensor([1]))
        assert torch.equal(as_int.tri, as_tensor.tri) and torch.equal(as_int.tri[0], full.tri[0])
        assert torch.all(as_int.tri[1] == -1) and int(as_int.inner_visits[1]) == 0
        # A stack of 2 drops pushes and says so; what it finds is a real hit.
        tiny = kernels_q.trace_packets_q(scene, r9, stack_size=2, lean=lean)
        assert int(tiny.overflow.sum()) > 0 and int(full.overflow.sum()) == 0
        found = tiny.tri >= 0
        assert torch.all(tiny.t[found] >= full.t[found])
    empty = _port_scene(jax_build_quantized_scene(jax_build_bvh(MeshData()).arrays))
    assert empty.root == L.NULL_LINK
    for lean, anyhit in ((False, False), (True, False), (True, True)):
        got = kernels_q.trace_packets_q(empty, r9, stack_size=8, lean=lean, anyhit=anyhit)
        assert torch.all(got.tri == -1) and int(got.inner_visits.sum()) == 0
    with pytest.raises(ValueError, match="anyhit"):
        kernels_q.trace_packets_q(scene, r9, stack_size=ss, anyhit=True)


def test_layout_rule(monkeypatch):
    """The f32 layouts unless their bytes exceed the budget, else the
    quantized ones; material ids are checked before the choice."""
    mesh = procedural.make_random_triangles(2000, seed=1)
    bvh = TriangleBvh.build(mesh)
    assert isinstance(bvh.kernel_scene("cpu"), kernels.KernelScene)  # no budget on the CPU
    assert isinstance(bvh.pt_scene("cpu"), kernels.PTScene)
    small = TriangleBvh.build(mesh)
    f32 = small.f32_scene_bytes()
    q = small.quantized_scene("cpu")
    assert q.node_q.numel() * 4 + q.tri_q.numel() * 4 <= f32 // 2
    monkeypatch.setattr(triangle_bvh, "SCENE_BUDGET_BYTES", f32 - 1)
    assert isinstance(small.kernel_scene("cpu"), kernels_q.QuantizedScene)
    assert isinstance(small.pt_scene("cpu"), kernels_q.QPTScene)
    # render() traces whatever kernel_scene gives it.
    cam = Camera().look_at((0, 0, 25), (0, 0, 0))
    p = render(Scene(small), cam, RenderSettings(16, 2, (32, 24)), device="cpu")
    p.wait()
    assert (p.image()[..., 3] > 0).any()

    ids = np.zeros(mesh.triangle_count, np.int32)
    ids[3] = 2048
    bad = TriangleBvh.build(mesh, materials=ids)
    with pytest.raises(ValueError, match="material ids"):
        bad.pt_scene("cpu")
    assert not bad._quantized_scenes  # raised before quantizing
    ids[3] = 70000
    wide = TriangleBvh.build(mesh, materials=ids)
    with pytest.raises(ValueError, match="65536 material ids"):
        wide.kernel_scene("cpu")


# ---- frames -----------------------------------------------------------------


def _bench_camera(cls):
    return cls().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(36e-3)


def _close_frames(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    close = np.all(np.abs(got - want) <= 1e-4, axis=-1)
    assert close.mean() >= 0.98, close.mean()
    np.testing.assert_allclose(got[..., :3].mean(), want[..., :3].mean(), rtol=1e-3)
    assert got[..., :3].mean() > 0.05


def test_seed_matched_sobol_parity_frame(atrium):
    res, jscene, scene = atrium
    W = H = 16
    key = jax.random.key(5)
    jsampler = _bench_camera(jax_camera.Camera).build_sampler((W, H))
    want = np.asarray(render_frame_pallas(
        res.as_device(), jsampler, key, width=W, height=H, spp=2, stack_size=res.recommended_stack_size,
        scene=jscene, sobol=True, interpret=True,
    ))
    sampler = CameraSampler.from_numpy({k: np.asarray(v) for k, v in jsampler._asdict().items()}, "cpu")
    got = render_frame(scene, sampler, None, width=W, height=H, spp=2, stack_size=res.recommended_stack_size,
                       sobol=True, strat_seed=int(render_seed(key))).numpy()
    _close_frames(got, want)
    assert np.all(got[..., 3] == 1.0)  # inside the hall every ray hits


def test_seed_matched_sobol_pt_frame_with_nee():
    mesh = jax_procedural.make_atrium(0)
    ids, dicts = jax_procedural.atrium_materials(mesh)
    res = jax_build_bvh(mesh, materials=ids, leaf_max=24)
    W = H = 16
    kw = dict(width=W, height=H, spp=2, bounces=3, samples_per_packet=2, sobol=True, shadow_rr=False)
    seed, ss = 1234567, res.recommended_stack_size
    jscene = jax_prepare_scene_qpt(res.arrays)
    jtable = jm.material_table(dicts)
    jtracer, _ = jw.make_pt_tracer(jscene, stack_size=ss, interpret=True)
    jshadow, _ = jw.make_pt_shadow_tracer(jscene, stack_size=ss, interpret=True)
    jlights = jm.build_light_table(res.arrays.tri_packets, res.arrays.tri_material, jtable)
    jsampler = _bench_camera(jax_camera.Camera).build_sampler((W, H))
    want = np.asarray(jw.render_frame_pt(jtracer, jscene, jtable, jsampler, jax.random.key(0), strat_seed=seed,
                                         lights=jlights, shadow_tracer=jshadow, **kw))
    scene = kernels_q.QPTScene(*_port_scene(jscene)[:4], shade_flat=kernels.build_shade_flat(
        from_numpy(res.arrays._asdict(), "cpu")))
    table = tm.material_table(dicts, "cpu")
    tracer, _ = tw.make_pt_tracer(scene, stack_size=ss)
    shadow, _ = tw.make_pt_shadow_tracer(scene, stack_size=ss)
    lights = tm.build_light_table(res.arrays.tri_packets, res.arrays.tri_material, table)
    sampler = CameraSampler.from_numpy({k: np.asarray(v) for k, v in jsampler._asdict().items()}, "cpu")
    got = tw.render_frame_pt(tracer, scene, table, sampler, None, strat_seed=seed, lights=lights,
                             shadow_tracer=shadow, **kw).numpy()
    _close_frames(got, want)
