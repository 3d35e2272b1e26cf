"""The port's multi-device rendering against the JAX package's.

A mesh of the port is a tuple of devices and may repeat one; here it is
``("cpu",) * n``. The JAX sharded renderers run on a one-device JAX mesh,
in-process (the JAX package's own 8-device tests need a subprocess with a
forced host device count).

Tolerances, each with its reason:

- Pixel packets and their inverses hold integer pixel coordinates: bit for
  bit.
- Sobol mode makes every camera, BSDF and light dimension a pure function
  of (pixel, sample, seed), and the port's shards take their strata from
  the whole frame's pixel ids, so the port's sharded frames equal its
  unsharded ones bit for bit, whatever the mesh.
- Against the JAX package the frames carry float32 differences: the parity
  frame is held as ``test_torch_render.py::test_frame_parity_sobol_seed_matched``
  holds it (>= 99.9% of pixels within 1e-5, means within 1e-5), the path
  tracer as ``test_torch_wavefront.py::test_seed_matched_sobol_frame``
  (>= 98% of pixels within 1e-4, means within 1e-3 relative).
- ``render(mesh=)`` makes the rays of a dispatch on ``mesh[0]`` as the
  single-device render does and splits only the trace: equal images.
- The portable engine's sample sums draw iid uniforms, which no two
  generators share: the JAX package's own check, coverage and solid-pixel
  agreement.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minipath_tpu import Camera as JaxCamera
from minipath_tpu import TriangleBvh as JaxTriangleBvh
from minipath_tpu import camera as jax_camera
from minipath_tpu.parallel import mesh as jmesh
from minipath_tpu.render import wavefront as jw
from minipath_tpu.render.frame import make_frame_renderer_sharded as jax_frame_sharded
from minipath_tpu.render.pallas_kernels import prepare_scene as jax_prepare_scene
from minipath_tpu.render.pallas_kernels import prepare_scene_pt as jax_prepare_scene_pt
from minipath_tpu.render.stratify import render_seed as jax_render_seed
from minipath_tpu.scene import materials as jm
from minipath_tpu.scene import procedural as jax_procedural
from minipath_tpu.scene.bvh.build import build_bvh as jax_build_bvh
from minipath_tpu_torch import Camera, RenderSettings, Scene, TriangleBvh, render
from minipath_tpu_torch.camera import CameraSampler
from minipath_tpu_torch.parallel import frame_shards, gather, make_device_mesh, map_shards, replicate, shard_ranges
from minipath_tpu_torch.parallel import mesh as tmesh
from minipath_tpu_torch.render import kernels
from minipath_tpu_torch.render import wavefront as tw
from minipath_tpu_torch.render.frame import render_frame
from minipath_tpu_torch.scene import materials as tm
from minipath_tpu_torch.scene import procedural
from minipath_tpu_torch.scene.bvh.build import from_numpy

W, H = 64, 48


@pytest.fixture(autouse=True)
def two_threads():
    # The plain traversal gains nothing from more, and the suite's other
    # workers share the cores.
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _sampler(jax_sampler):
    return CameraSampler.from_numpy({k: np.asarray(v) for k, v in jax_sampler._asdict().items()}, "cpu")


# ---- the mesh ---------------------------------------------------------------


def test_make_device_mesh(monkeypatch):
    assert make_device_mesh(3, "cpu") == (torch.device("cpu"),) * 3
    assert make_device_mesh(None, "cpu") == (torch.device("cpu"),)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_device_mesh(device="cuda") == (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(ValueError, match="3 CUDA devices asked for, 2 available"):
        make_device_mesh(3)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="1 CUDA devices asked for, 0 available"):
        make_device_mesh(1, "cuda")
    with pytest.raises(ValueError, match="at least one device"):
        make_device_mesh(0, "cpu")


def test_shards_share_one_copy_per_device():
    """A repeated device holds one copy of the scene, the caller's own; one
    device is the one shard of a frame."""
    scene = kernels.prepare_scene(TriangleBvh.build(procedural.make_cube(1.0)).arrays("cpu"))
    copies = replicate(scene, ("cpu",) * 4)
    assert len(copies) == 4 and all(c is scene for c in copies)
    assert shard_ranges(12, 5) == [(0, 3), (3, 6), (6, 9), (9, 12), (12, 12)]
    assert shard_ranges(3, 4) == [(0, 1), (1, 2), (2, 3), (3, 3)]
    x = torch.arange(10.0)
    assert torch.equal(map_shards(lambda a: a * 2, x, ("cpu",) * 4), x * 2)
    # One device is the one shard of every block, on the caller's generator
    # and objects themselves, with no draw; a mesh draws once for its shards.
    g = torch.Generator().manual_seed(1)
    state = g.get_state()
    [(lo, hi, gen, (obj,))] = frame_shards(None, 12, g, scene)
    assert (lo, hi) == (0, 12) and gen is g and obj is scene and torch.equal(g.get_state(), state)
    shards = frame_shards(("cpu",) * 5, 12, g, scene)
    assert [(lo, hi) for lo, hi, _, _ in shards] == [(0, 3), (3, 6), (6, 9), (9, 12)]
    assert all(gen is not g and obj is scene for _, _, gen, (obj,) in shards)
    assert not torch.equal(g.get_state(), state)
    assert torch.equal(gather([x[:4], x[4:]], ("cpu",) * 2), x) and gather([x], None) is x


# ---- pixel packets ------------------------------------------------------------


@pytest.mark.parametrize("w,h,pad", [(100, 70, 1), (100, 70, 4), (64, 48, 5), (17, 3, 8)])
def test_frame_pixel_packets_match_jax(w, h, pad):
    got, counts = tmesh.frame_pixel_packets(w, h, pad_packets_to=pad)
    want, jcounts = jmesh.frame_pixel_packets(w, h, pad_packets_to=pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert counts == jcounts and got.shape[0] % pad == 0
    vals = np.random.default_rng(w).normal(size=got.shape[:-1] + (4,)).astype(np.float32)
    np.testing.assert_array_equal(tmesh.unpack_frame(torch.from_numpy(vals), w, h, counts, tmesh.PACKET_SHAPE).numpy(),
                                  np.asarray(jmesh.unpack_frame(jnp.asarray(vals), w, h, jcounts)))
    got, counts = tmesh.frame_pixel_packets_ms(w, h, (8, 8), samples=3, pad_packets_to=pad)
    want, jcounts = jmesh.frame_pixel_packets_ms(w, h, (8, 8), samples=3, pad_packets_to=pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Integer-valued samples: the sums are exact in either order.
    vals = np.random.default_rng(h).integers(0, 9, got.shape[:-1] + (4,)).astype(np.float32)
    np.testing.assert_array_equal(
        tmesh.unpack_frame_ms(torch.from_numpy(vals), w, h, counts, (8, 8), samples=3).numpy(),
        np.asarray(jmesh.unpack_frame_ms(jnp.asarray(vals), w, h, jcounts, (8, 8), samples=3)),
    )


# ---- the parity frame ---------------------------------------------------------


def _parity_mesh(P):
    return P.merge_meshes(
        [P.make_uv_sphere(1.0, center=(0, 1.5, 0), rings=12, segments=24), P.make_cube(1.0, center=(1.5, 0.5, 0))]
    )


def _camera(cls):
    return cls().look_at((0, 2, 10), (0, 1.5, 0)).f_number(4.8).focus_distance(10)


def test_sharded_parity_frame_matches_jax_and_the_unsharded_frame():
    jb = JaxTriangleBvh.build(_parity_mesh(jax_procedural))
    stack = jb.recommended_stack_size
    js = _camera(JaxCamera).build_sampler((W, H))
    key = jax.random.key(3)
    jax_render = jax_frame_sharded(jmesh.make_device_mesh(1), width=W, height=H, stack_size=stack,
                                   samples_per_packet=2, interpret=True)
    want = np.asarray(jax_render(jax_prepare_scene(jb.arrays), js, key, 4, sobol=True))

    scene = kernels.prepare_scene(from_numpy(jb.host_arrays._asdict(), "cpu"))
    sampler = _sampler(js)
    seed = int(jax_render_seed(key))
    kw = dict(width=W, height=H, spp=4, stack_size=stack, sobol=True, strat_seed=seed, samples_per_packet=2)
    frames = {
        n: render_frame(scene, sampler, None, mesh=("cpu",) * n, **kw)
        for n in (1, 4, 5)  # 12 blocks: 4 shards of 3; 5 shards of 3, 3, 3, 3, 0
    }
    single = render_frame(scene, sampler, None, **kw)
    for n, frame in frames.items():
        assert torch.equal(frame, single), n
    got = frames[4].numpy()
    assert got.shape == want.shape == (H, W, 4)
    close = np.all(np.abs(got - want) <= 1e-5, axis=-1)
    assert close.mean() >= 0.999, close.mean()
    np.testing.assert_allclose(got.mean(axis=(0, 1)), want.mean(axis=(0, 1)), rtol=0, atol=1e-5)
    assert 0.05 < want[..., 3].mean() < 0.95


def test_sharded_parity_frame_draws_per_shard_generators():
    """Jittered strata: each shard draws from a generator of its own, so
    the frame differs from the unsharded one's but has its statistics, and
    one seed reproduces it."""
    bvh = TriangleBvh.build(_parity_mesh(procedural))
    sampler = _camera(Camera).build_sampler((W, H), "cpu")

    def sharded(seed):
        return render_frame(bvh.kernel_scene("cpu"), sampler, torch.Generator().manual_seed(seed), width=W,
                            height=H, spp=4, stack_size=bvh.recommended_stack_size, mesh=("cpu",) * 4)

    a, b = sharded(1), sharded(1)
    single = render_frame(bvh.kernel_scene("cpu"), sampler, torch.Generator().manual_seed(1), width=W, height=H,
                          spp=4, stack_size=bvh.recommended_stack_size)
    assert torch.equal(a, b) and not torch.equal(a, single)
    assert abs(a[..., 3].mean().item() - single[..., 3].mean().item()) < 0.01
    assert abs(a[..., 0].mean().item() - single[..., 0].mean().item()) < 0.02 * single[..., 0].mean().item()


# ---- the path tracer ----------------------------------------------------------


@pytest.fixture(scope="module")
def small_atrium():
    """``make_atrium(0)`` with the benchmark materials (emissive ceiling),
    built once by the JAX builder and handed to both packages."""
    mesh = jax_procedural.make_atrium(0)
    ids, dicts = jax_procedural.atrium_materials(mesh)
    return jax_build_bvh(mesh, materials=ids, leaf_max=24), dicts


@pytest.mark.parametrize("nee", [False, True], ids=["bsdf", "nee"])
def test_sharded_pt_matches_jax(small_atrium, nee):
    res, dicts = small_atrium
    stack = res.recommended_stack_size
    kw = dict(width=W, height=H, samples_per_packet=2, bounces=3, sobol=True, shadow_rr=False)
    js = jax_camera.Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(
        36e-3).build_sampler((W, H))
    key = jax.random.key(0)
    # JAX: the lean kernel in interpret mode, as the JAX package's tests run it.
    jscene = jax_prepare_scene_pt(res.as_device())
    jtable = jm.material_table(dicts)
    jtracer, _ = jw.make_pt_tracer(jscene, stack_size=stack, interpret=True)
    jshadow = jlights = None
    if nee:
        jshadow, _ = jw.make_pt_shadow_tracer(jscene, stack_size=stack, interpret=True)
        jlights = jm.build_light_table(res.arrays.tri_packets, res.arrays.tri_material, jtable)
    jax_render = jw.make_pt_renderer_sharded(jmesh.make_device_mesh(1), jtracer, lights=jlights,
                                             shadow_tracer=jshadow, **kw)
    want = np.asarray(jax_render(jscene, jtable, js, key, 2, env=jm.Environment.sky()))

    scene = kernels.prepare_scene_pt(from_numpy(res.arrays._asdict(), "cpu"))
    table = tm.material_table(dicts, "cpu")
    tracer, _ = tw.make_pt_tracer(scene, stack_size=stack)
    shadow = lights = None
    if nee:
        shadow, _ = tw.make_pt_shadow_tracer(scene, stack_size=stack)
        lights = tm.build_light_table(res.arrays.tri_packets, res.arrays.tri_material, table)
    sampler, env, seed = _sampler(js), tm.Environment.sky("cpu"), int(jax_render_seed(key))
    kw.update(spp=2, env=env, strat_seed=seed, lights=lights, shadow_tracer=shadow)
    frames = [tw.render_frame_pt(tracer, scene, table, sampler, None, mesh=("cpu",) * n, **kw) for n in (1, 4)]
    single = tw.render_frame_pt(tracer, scene, table, sampler, None, **kw)
    assert torch.equal(frames[0], single) and torch.equal(frames[1], single)
    got = frames[1].numpy()
    assert got.shape == want.shape == (H, W, 4) and np.isfinite(got).all()
    close = np.all(np.abs(got - want) <= 1e-4, axis=-1)
    assert close.mean() >= 0.98, close.mean()
    np.testing.assert_allclose(got[..., :3].mean(), want[..., :3].mean(), rtol=1e-3)
    assert got[..., :3].mean() > 0.05


@pytest.mark.parametrize("n", [1, 3])
def test_pt_mesh_keeps_clamp_and_variance(small_atrium, n):
    """Every argument of ``render_frame_pt`` holds over a mesh: in Sobol
    mode with no roulette draw, a mesh of ``n`` renders the one-device
    frame and its variance bit for bit, both clamped."""
    res, dicts = small_atrium
    scene = kernels.prepare_scene_pt(from_numpy(res.arrays._asdict(), "cpu"))
    table = tm.material_table(dicts, "cpu")
    tracer, _ = tw.make_pt_tracer(scene, stack_size=res.recommended_stack_size)
    shadow, _ = tw.make_pt_shadow_tracer(scene, stack_size=res.recommended_stack_size)
    lights = tm.build_light_table(res.arrays.tri_packets, res.arrays.tri_material, table)
    sampler = Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(
        36e-3).build_sampler((W, H), "cpu")
    clamp = 0.25
    kw = dict(width=W, height=H, spp=4, samples_per_packet=2, bounces=3, sobol=True, shadow_rr=False,
              strat_seed=11, lights=lights, shadow_tracer=shadow, clamp=clamp, return_variance=True)
    img, var = tw.render_frame_pt(tracer, scene, table, sampler, None, mesh=("cpu",) * n, **kw)
    single, single_var = tw.render_frame_pt(tracer, scene, table, sampler, None, **kw)
    assert torch.equal(img, single) and torch.equal(var, single_var)
    assert var.shape == (H, W) and var.max() > 0
    assert 0.05 < img[..., :3].mean() and img[..., :3].max() <= clamp


# ---- render(mesh=) --------------------------------------------------------------


@pytest.mark.parametrize("mode", ["tile", "frame"])
def test_render_mesh_is_bit_identical(mode):
    """Fifteen tiles (not a multiple of four) over a mesh of four."""
    bvh = TriangleBvh.build(_parity_mesh(procedural))
    settings = RenderSettings(tile_size=16, sample_count=3, resolution=(80, 48))
    cb = (lambda t, s: None) if mode == "tile" else None
    single = render(Scene(bvh), _camera(Camera), settings, None, cb, device="cpu", seed=5)
    sharded = render(Scene(bvh), _camera(Camera), settings, None, cb, seed=5, mesh=("cpu",) * 4)
    single.wait()
    sharded.wait()
    assert sharded.progress().total == 15 == sharded.progress().finished
    np.testing.assert_array_equal(single.image(), sharded.image())
    assert (single.image()[..., 3] > 0).mean() > 0.05
    with pytest.raises(ValueError, match="mesh's first device"):
        render(Scene(bvh), _camera(Camera), settings, device="cuda", mesh=("cpu",) * 2)


# ---- the portable engine --------------------------------------------------------


def test_render_frame_sum_sharded_matches_jax():
    """The JAX package's own check (``tests/parallel_impl.py``): coverage
    within 5%, and >= 99% of the pixels solid in both frames agree within
    Monte Carlo noise."""
    w = h = 64
    spp = 4
    jb = JaxTriangleBvh.build(jax_procedural.make_uv_sphere(1.0, rings=16, segments=32))
    js = JaxCamera().look_at((0, 0, 4), (0, 0, 0)).f_number(16.0).build_sampler((w, h))
    stack = jb.recommended_stack_size
    want = np.asarray(jmesh.render_frame_sum(jb.arrays, js, jax.random.key(7), width=w, height=h, spp=spp,
                                             stack_size=stack))
    bvh = from_numpy(jb.host_arrays._asdict(), "cpu")
    sampler = _sampler(js)
    single = tmesh.render_frame_sum(bvh, sampler, torch.Generator().manual_seed(7), width=w, height=h, spp=spp,
                                    stack_size=stack).numpy()
    sharded = tmesh.render_frame_sum(bvh, sampler, torch.Generator().manual_seed(7), width=w, height=h, spp=spp,
                                     stack_size=stack, mesh=("cpu",) * 3).numpy()
    for got in (single, sharded):
        assert got.shape == want.shape == (h, w, 4)
        assert abs(want[..., 3].mean() - got[..., 3].mean()) < 0.05 * spp
        solid = (want[..., 3] == spp) & (got[..., 3] == spp)
        assert solid.mean() > 0.2
        a, b = want[..., 0][solid], got[..., 0][solid]
        assert (np.abs(a - b) <= 0.05 * spp + 0.15 * np.abs(b)).mean() > 0.99
    assert not np.array_equal(single, sharded)  # each shard draws from a generator of its own
