"""The port's à-trous denoiser and guide buffers against the JAX package's.

Tolerances, each with its reason:

- ``_shifted`` and ``_blur3``: a shift is a copy, so it is equal exactly; the
  blur sums nine products in the same order with the same float32 weights,
  also equal exactly.
- ``atrous_denoise``: ``rtol=1e-4, atol=1e-5`` on a ``[0, 1]`` image. Both
  sides take the same float32 steps, but ``ndot ** 128`` and ``exp`` come
  from different math libraries (last-bit differences, which the power of 128
  scales up), XLA fuses multiply-adds under ``jit``, and the three-channel
  sums may associate differently; four iterations compound them.
- ``render_aux`` against the port's own full kernel on the same rays (one
  generator seed): the hit mask is ``tri >= 0`` exactly and the depth is
  ``t`` exactly; normals within 2e-3 through ``make_pt_tracer`` (they come
  from the f16 shading table) and within 1e-5 through ``make_full_tracer``
  (the kernel's own f32 normals, only reshaped).
- ``render_aux`` against the JAX one: the film jitter is iid on both sides
  (threefry there, a ``torch.Generator`` here) and cannot be matched, so the
  comparison is by share of pixels: hit masks agree on >= 97% (they differ
  only along silhouettes), depth within 5% on >= 97% of the commonly hit
  pixels. The jitter alone moves the floor's depth: two JAX buffers from
  different keys agree within 1% on 79% of their pixels, within 2% on 94%
  and within 5% on 98.8%, and so do two of the port's, so 1% cannot be
  asked here.
- End to end (the JAX package's own ``test_denoise.py`` cases at their
  sizes): the filtered 4-spp frame's RMSE against a 96-spp frame under 0.6x
  (fixed-sigma) and 0.65x (variance-guided) of the raw frame's, the mean
  within 5%, and no harm at 32 spp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minipath_tpu import camera as jax_camera
from minipath_tpu.render import denoise as jd
from minipath_tpu.render import wavefront as jw
from minipath_tpu.scene import procedural as jax_procedural
from minipath_tpu.scene.triangle_bvh import TriangleBvh as JaxTriangleBvh
from minipath_tpu_torch import Camera, TriangleBvh
from minipath_tpu_torch.render import denoise as td
from minipath_tpu_torch.render import kernels
from minipath_tpu_torch.render import wavefront as tw
from minipath_tpu_torch.render.frame import gen_frame_rays9, unpack_frame
from minipath_tpu_torch.scene import materials as tm
from minipath_tpu_torch.scene import procedural

H, W = 48, 40
# One iteration schedule's shifts (+-2 * 2^i for i < 4), one beyond the image.
SHIFTS = [(dy, dx) for d in (1, 2, 4, 8) for dy in (-2 * d, 0, 2 * d) for dx in (-2 * d, 0, 2 * d)] + [
    (1, -1), (-60, 3), (5, 70), (-48, -40)
]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """The plain traversal is thousands of small ops, which gain nothing from
    many threads and lose a lot when several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class TestShifted:
    def test_translation_and_edge_clamp(self):
        img = torch.arange(12.0).reshape(3, 4)
        s = td._shifted(img, 1, 0)  # content moves down
        assert torch.equal(s[1:], img[:2])
        assert torch.equal(s[0], img[0])  # clamped
        s = td._shifted(img, 0, -2)  # content moves left
        assert torch.equal(s[:, :2], img[:, 2:])
        assert torch.equal(s[:, 2], img[:, 3])

    def test_channels_preserved(self):
        assert td._shifted(torch.ones((4, 4, 3)), 2, 2).shape == (4, 4, 3)

    @pytest.mark.parametrize("shape", [(H, W), (H, W, 3)], ids=["hw", "hwc"])
    def test_shifts_equal_jax(self, shape):
        img = np.random.default_rng(0).uniform(size=shape).astype(np.float32)
        for dy, dx in SHIFTS:
            got = td._shifted(torch.from_numpy(img), dy, dx).numpy()
            np.testing.assert_array_equal(got, np.asarray(jd._shifted(jnp.asarray(img), dy, dx)), err_msg=str((dy, dx)))

    @pytest.mark.parametrize("shape", [(H, W), (H, W, 3)], ids=["hw", "hwc"])
    def test_blur3_equals_jax(self, shape):
        img = np.random.default_rng(1).uniform(size=shape).astype(np.float32)
        got = td._blur3(torch.from_numpy(img)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jd._blur3(jnp.asarray(img))))


def _guides(rng, miss):
    """A two-plane image: noisy colour around a step edge, unit normals that
    turn at the edge, a depth ramp; ``miss`` zeroes some normals."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    left = xx < W // 2
    base = np.where(left[..., None], np.float32([0.8, 0.3, 0.2]), np.float32([0.2, 0.5, 0.7]))
    rgb = np.clip(base + rng.normal(0.0, 0.08, (H, W, 3)), 0.0, 1.0).astype(np.float32)
    normal = np.where(left[..., None], np.float32([0.0, 0.0, 1.0]), np.float32([0.6, 0.0, 0.8]))
    normal = (normal + rng.normal(0.0, 0.01, (H, W, 3))).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    depth = (3.0 + 0.05 * xx + 0.02 * yy + np.where(left, 0.0, 1.5)).astype(np.float32)
    variance = (rng.uniform(0.0, 0.01, (H, W)) * (1.0 + left)).astype(np.float32)
    mask = np.zeros((H, W), bool)
    if miss == "block":
        mask[:12, 25:] = True
    elif miss == "scattered":
        mask = rng.uniform(size=(H, W)) < 0.15
    normal[mask] = 0.0
    return rgb, normal, depth, variance, mask


CASES = {
    # name: (miss pattern, depth of the miss pixels, iterations, constant image)
    "plain_4": (None, None, 4, False),
    "plain_1": (None, None, 1, False),
    "miss_block": ("block", None, 4, False),
    "miss_scattered": ("scattered", None, 4, False),
    "miss_inf_depth": ("block", np.inf, 4, False),
    "miss_nan_depth": ("scattered", np.nan, 4, False),
    "miss_scattered_1": ("scattered", np.inf, 1, False),
    "constant": (None, None, 4, True),
}


@pytest.mark.parametrize("with_variance", [False, True], ids=["fixed_sigma", "variance"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_atrous_denoise_matches_jax(case, with_variance):
    miss, miss_depth, iterations, constant = CASES[case]
    rgb, normal, depth, variance, mask = _guides(np.random.default_rng(5), miss)
    if miss_depth is not None:
        depth[mask] = miss_depth
    if constant:
        rgb[:] = np.float32([0.25, 0.5, 0.75])
    var = variance if with_variance else None
    want = np.asarray(jd.atrous_denoise(
        jnp.asarray(rgb), jnp.asarray(normal), jnp.asarray(depth), None if var is None else jnp.asarray(var),
        iterations=iterations,
    ))
    got = td.atrous_denoise(
        torch.from_numpy(rgb), torch.from_numpy(normal), torch.from_numpy(depth),
        None if var is None else torch.from_numpy(var), iterations=iterations,
    ).numpy()
    assert got.shape == (H, W, 3) and got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    if constant:
        np.testing.assert_allclose(got, rgb, rtol=0, atol=1e-6)  # the filter is the identity
    else:
        assert np.abs(got - rgb).mean() > 1e-3  # and otherwise it filters
        # No colour crosses the normal and depth edge.
        assert got[:, : W // 2 - 1, 0].min() > got[:, W // 2 + 1 :, 0].max()


def test_atrous_denoise_knobs_match_jax():
    rgb, normal, depth, variance, _ = _guides(np.random.default_rng(6), "scattered")
    kw = dict(iterations=3, sigma_color=0.2, sigma_normal=32.0, sigma_depth=0.5, k_variance=4.0)
    for var in (None, variance):
        want = np.asarray(jd.atrous_denoise(jnp.asarray(rgb), jnp.asarray(normal), jnp.asarray(depth),
                                            None if var is None else jnp.asarray(var), **kw))
        got = td.atrous_denoise(torch.from_numpy(rgb), torch.from_numpy(normal), torch.from_numpy(depth),
                                None if var is None else torch.from_numpy(var), **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# ---- guide buffers and the end-to-end gain -------------------------------------


def _scene_mesh(P):
    """The JAX package's denoise test scene: a sphere over a floor."""
    sph = P.make_uv_sphere(1.0, rings=12, segments=20)
    sph.positions[:, 1] += 1.0
    floor = P.make_quad(30.0)
    p = floor.positions.copy()
    floor.positions = np.stack([p[:, 0], p[:, 2], p[:, 1]], axis=-1)
    mats = np.concatenate([np.zeros(len(sph.triangles), np.int32), np.ones(len(floor.triangles), np.int32)])
    return P.merge_meshes([sph, floor]), mats


def _camera(cls):
    return cls().look_at((0, 2.2, 6), (0, 1.0, 0)).f_number(32.0)


@pytest.fixture(scope="module")
def scene():
    mesh, mats = _scene_mesh(procedural)
    bvh = TriangleBvh.build(mesh, materials=mats)
    table = tm.material_table([tm.metal((0.9, 0.7, 0.4), fuzz=0.3), tm.lambertian((0.5, 0.55, 0.6))], "cpu")
    sampler = _camera(Camera).build_sampler((64, 64), "cpu")
    tracer, state = tw.make_pt_tracer(bvh.pt_scene("cpu"), stack_size=bvh.recommended_stack_size, packet_size=256)
    return bvh, tracer, state, table, sampler, tm.Environment.sky("cpu")


def _aux(scene, seed=1):
    _, tracer, state, _, sampler, _ = scene
    return td.render_aux(tracer, state, sampler, torch.Generator().manual_seed(seed), width=64, height=64,
                         px_block=(16, 16))


def _frame(scene, spp, seed=0, **kw):
    _, tracer, state, table, sampler, env = scene
    return tw.render_frame_pt(
        tracer, state, table, sampler, torch.Generator().manual_seed(seed), width=64, height=64, spp=spp,
        bounces=3, env=env, px_block=(16, 16), samples_per_packet=min(8, spp), **kw,
    )


def test_aux_buffers(scene):
    n_img, z_img = _aux(scene)
    assert n_img.shape == (64, 64, 3) and z_img.shape == (64, 64)
    hit = torch.any(n_img != 0, dim=-1).numpy()
    assert 0.05 < hit.mean() < 1.0  # sphere + floor cover part of the frame
    np.testing.assert_allclose(np.linalg.norm(n_img.numpy()[hit], axis=-1), 1.0, atol=1e-3)
    # A miss carries the frame's largest hit depth.
    assert torch.all(z_img[torch.from_numpy(~hit)] == z_img[torch.from_numpy(hit)].max())


@pytest.mark.parametrize("which", ["pt_tracer", "full_tracer", "full_tracer_quantized"])
def test_render_aux_against_the_full_kernel_on_the_same_rays(scene, which):
    bvh, tracer, state, _, sampler, _ = scene
    ss = bvh.recommended_stack_size
    if which == "full_tracer":
        tracer, state = tw.make_full_tracer(bvh.kernel_scene("cpu"), stack_size=ss, packet_size=256)
    elif which == "full_tracer_quantized":
        tracer, state = tw.make_full_tracer(bvh.quantized_scene("cpu"), stack_size=ss, packet_size=256)
    n_img, z_img = td.render_aux(tracer, state, sampler, torch.Generator().manual_seed(3), width=64, height=64)
    # The same rays (the same generator seed) through K1's plain version.
    rays9, counts = gen_frame_rays9(sampler, torch.Generator().manual_seed(3), width=64, height=64,
                                    px_block=(16, 16), samples=1)
    kh = kernels.trace_packets(bvh.kernel_scene("cpu"), rays9, stack_size=ss)
    tri = unpack_frame(kh.tri[..., None], 64, 64, counts, (16, 16))[..., 0]
    t = unpack_frame(kh.t[..., None], 64, 64, counts, (16, 16))[..., 0]
    normal = unpack_frame(kh.normal, 64, 64, counts, (16, 16))
    hit = tri >= 0
    if which == "full_tracer_quantized":
        # Another layout: the same hits up to its 16-bit grid.
        assert (torch.any(n_img != 0, dim=-1) == hit).float().mean() >= 0.99
        both = hit & torch.any(n_img != 0, dim=-1)
        assert torch.allclose(z_img[both], t[both], rtol=1e-3)
        return
    assert torch.equal(torch.any(n_img != 0, dim=-1), hit)
    assert torch.equal(z_img[hit], t[hit])
    assert torch.all(z_img[~hit] == t[hit].max())
    atol = 2e-3 if which == "pt_tracer" else 1e-5
    assert (n_img - normal).abs().max().item() <= atol


def test_render_aux_against_jax_by_share_of_pixels(scene):
    n_img, z_img = _aux(scene)
    mesh, mats = _scene_mesh(jax_procedural)
    obj = JaxTriangleBvh.build(mesh, materials=mats)
    jtracer, jstate = jw.make_xla_tracer(obj.arrays, stack_size=obj.recommended_stack_size, packet_size=256)
    jn, jz = jd.render_aux(jtracer, jstate, _camera(jax_camera.Camera).build_sampler((64, 64)), jax.random.key(1),
                           width=64, height=64, px_block=(16, 16))
    hit, jhit = np.any(n_img.numpy() != 0, axis=-1), np.any(np.asarray(jn) != 0, axis=-1)
    assert (hit == jhit).mean() >= 0.97
    both = hit & jhit
    close = np.abs(z_img.numpy()[both] - np.asarray(jz)[both]) <= 0.05 * np.asarray(jz)[both]
    assert close.mean() >= 0.97
    assert abs(hit.mean() - jhit.mean()) <= 0.01


@pytest.fixture(scope="module")
def reference_frame(scene):
    return _frame(scene, 96, seed=7)[..., :3].numpy()


def _rmse(a, b):
    return np.sqrt(np.mean((a - b) ** 2))


def test_denoise_reduces_error(scene, reference_frame):
    noisy = _frame(scene, 4, seed=0)[..., :3]
    n_img, z_img = _aux(scene)
    den = td.atrous_denoise(noisy, n_img, z_img).numpy()
    noisy = noisy.numpy()
    assert np.isfinite(den).all()
    # The denoiser must clearly beat the raw 4-spp frame.
    assert _rmse(den, reference_frame) < 0.6 * _rmse(noisy, reference_frame)
    # Biased smoothing, but the global mean must not drift.
    np.testing.assert_allclose(den.mean(), noisy.mean(), rtol=0.05)


def test_variance_guided(scene, reference_frame):
    """A clear win at 4 spp and, the property the fixed-sigma filter lacks,
    no harm at 32 spp."""
    n_img, z_img = _aux(scene)

    def run(spp):
        noisy, var = _frame(scene, spp, seed=0, return_variance=True)
        assert var.shape == (64, 64) and bool((var >= 0).all())
        den = td.atrous_denoise(noisy[..., :3], n_img, z_img, var).numpy()
        noisy = noisy[..., :3].numpy()
        return _rmse(noisy, reference_frame), _rmse(den, reference_frame), noisy, den

    e_noisy4, e_den4, noisy4, den4 = run(4)
    assert e_den4 < 0.65 * e_noisy4, (e_den4, e_noisy4)
    np.testing.assert_allclose(den4.mean(), noisy4.mean(), rtol=0.05)
    e_noisy32, e_den32, _, _ = run(32)
    assert e_den32 < e_noisy32, (e_den32, e_noisy32)


# ---- the full-kernel tracer under the bounce loop --------------------------------


@pytest.mark.parametrize("layout", ["f32", "quantized"])
def test_full_tracer_frame_matches_pt_tracer_frame(layout):
    """A seed-matched Sobol frame over ``make_full_tracer`` against the one
    over ``make_pt_tracer`` on the same layout: the same paths up to the
    f16 normals of the lean tracer's shading table (2e-3 on a normal, which
    a bounce or two carry into the radiance), so the means agree within 0.5%
    and >= 95% of pixels within 2e-2."""
    mesh = procedural.make_atrium(0)
    ids, dicts = procedural.atrium_materials(mesh)
    bvh = TriangleBvh.build(mesh, materials=ids, leaf_max=24)
    ss = bvh.recommended_stack_size
    table = tm.material_table(dicts, "cpu")
    sampler = Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(36e-3).build_sampler(
        (16, 16), "cpu")
    if layout == "f32":
        lean, full = bvh.pt_scene("cpu"), bvh.kernel_scene("cpu")
    else:
        lean, full = bvh.quantized_pt_scene("cpu"), bvh.quantized_scene("cpu")
    kw = dict(width=16, height=16, spp=4, bounces=3, samples_per_packet=2, sobol=True, strat_seed=77)
    frames = []
    for make, state in ((tw.make_pt_tracer, lean), (tw.make_full_tracer, full)):
        tracer, _ = make(state, stack_size=ss)
        frames.append(tw.render_frame_pt(tracer, state, table, sampler, None, **kw).numpy())
    want, got = frames
    assert np.isfinite(got).all() and got[..., :3].mean() > 0.05
    np.testing.assert_allclose(got[..., :3].mean(), want[..., :3].mean(), rtol=5e-3)
    assert np.all(np.abs(got - want) <= 2e-2, axis=-1).mean() >= 0.95


def test_full_tracer_hits_are_the_kernels():
    """``make_full_tracer`` only packs and reshapes: its hits are
    ``trace_scene``'s on the same rays, a live prefix included, and it
    returns no texture coordinates."""
    bvh = TriangleBvh.build(procedural.make_uv_sphere(1.0, rings=10, segments=14))
    scene = bvh.kernel_scene("cpu")
    rng = np.random.default_rng(4)
    n = 700  # not a multiple of the packet: the last ray pads it
    o = torch.from_numpy(rng.uniform(-3, 3, (n, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    tracer, state = tw.make_full_tracer(scene, stack_size=bvh.recommended_stack_size, packet_size=256)
    got = tracer(state, o, d, 1.0 / d)
    r9, _, _ = tw._pack_rays9(256, None, o, d, 1.0 / d)
    want = kernels.trace_packets(scene, r9, stack_size=bvh.recommended_stack_size)
    assert torch.equal(got.tri, want.tri.reshape(-1)[:n]) and torch.equal(got.t, want.t.reshape(-1)[:n])
    assert torch.equal(got.normal, want.normal.reshape(-1, 3)[:n])
    assert torch.equal(got.material, want.material.reshape(-1)[:n])
    assert got.texture_coords is None and bool((got.tri >= 0).any())
    live = tracer(state, o, d, 1.0 / d, torch.tensor(300, dtype=torch.int32))
    assert torch.equal(live.tri[:512], got.tri[:512]) and bool((live.tri[512:] == -1).all())
