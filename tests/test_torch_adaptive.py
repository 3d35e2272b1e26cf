"""The port's adaptive sampler against the JAX package's.

Tolerances, each with its reason:

- ``gen_rays9_blocks(block_ids=)``: within the port, the rays of a permuted
  block list are the contiguous rays permuted, bit for bit (a block's rays
  depend on its id alone). Against the JAX package, origins and directions
  as ``test_torch_camera.py::test_sample_rays_sobol_matches_jax`` holds the
  camera (1e-6), their inverses relative to their size.
- ``_pt_trace(live_rays=)``: seed-matched in Sobol mode with no roulette
  (3 bounces, rr_start 3), against the JAX bounce loop over its portable
  tracer; the live packets as ``test_torch_wavefront.py``'s seed-matched
  frame (>= 98% of pixels within 1e-4), the dead ones exactly zero, and
  ``live_rays`` of every ray equal to None bit for bit.
- The allocation and the combination: both packages' round functions are
  replaced by one seeded table, so both see the same pilot and round sums;
  the spp maps are equal and the images within 1e-6 (float32 arithmetic in
  another order).
- The four contracts of ``tests/test_adaptive.py``, on the port alone, with
  its tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minipath_tpu import camera as jax_camera
from minipath_tpu.parallel.mesh import gen_rays9_blocks as jax_gen_rays9_blocks
from minipath_tpu.render import adaptive as jax_adaptive
from minipath_tpu.render import wavefront as jw
from minipath_tpu.render.stratify import render_seed as jax_render_seed
from minipath_tpu.scene import materials as jm
from minipath_tpu.scene import procedural as jax_procedural
from minipath_tpu.scene.bvh.build import build_bvh as jax_build_bvh
from minipath_tpu_torch import Camera, TriangleBvh
from minipath_tpu_torch.camera import CameraSampler
from minipath_tpu_torch.render import adaptive
from minipath_tpu_torch.render import kernels
from minipath_tpu_torch.render import wavefront as tw
from minipath_tpu_torch.render.frame import gen_rays9_blocks
from minipath_tpu_torch.scene import materials as tm
from minipath_tpu_torch.scene import procedural
from minipath_tpu_torch.scene.bvh.build import from_numpy

W, H = 64, 48
WC, B = 4, 12  # 16x16 blocks of a 64x48 frame


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bench_sampler():
    js = jax_camera.Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(
        36e-3).build_sampler((W, H))
    return js, CameraSampler.from_numpy({k: np.asarray(v) for k, v in js._asdict().items()}, "cpu")


def test_gen_rays9_blocks_block_ids():
    js, sampler = _bench_sampler()
    perm = np.random.default_rng(0).permutation(B).astype(np.int32)
    kw = dict(block_count=B, wc=WC, px_block=(16, 16), samples=2, strat_spp=-8, strat_offset=2, strat_seed=-123457)
    got = gen_rays9_blocks(sampler, None, 0, block_ids=torch.from_numpy(perm), **kw)
    contiguous = gen_rays9_blocks(sampler, None, 0, **kw)
    assert torch.equal(got, contiguous[torch.from_numpy(perm).long()])
    want = np.asarray(jax_gen_rays9_blocks(js, jax.random.key(0), jnp.int32(0), block_ids=jnp.asarray(perm), **kw))
    want = want.reshape(got.shape)
    got = got.numpy()
    np.testing.assert_allclose(got[:, 0:6], want[:, 0:6], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, 6:9], want[:, 6:9], rtol=1e-5)


def test_pt_trace_live_rays_matches_jax():
    mesh = jax_procedural.make_atrium(0)
    ids, dicts = jax_procedural.atrium_materials(mesh)
    res = jax_build_bvh(mesh, materials=ids, leaf_max=24)
    js, sampler = _bench_sampler()
    samples, seed = 2, int(jax_render_seed(jax.random.key(4)))
    strat = dict(strat_spp=-samples, strat_offset=0, strat_seed=seed)
    rays9 = gen_rays9_blocks(sampler, None, 0, block_count=B, wc=WC, samples=samples, px_block=(16, 16), **strat)
    P0 = rays9.shape[2]
    live = 5 * P0 + 256  # five whole packets, then the first sample of the sixth
    kw = dict(samples=samples, bounces=3, compaction=True, **strat)

    jtracer, jstate = jw.make_xla_tracer(res.as_device(), stack_size=res.recommended_stack_size, packet_size=256)
    jtable = jm.material_table(dicts)
    want = np.asarray(jax.jit(lambda r9: jw._pt_trace(
        jstate, jtable, jm.Environment.sky(), r9, jax.random.key(0), tracer=jtracer, live_rays=live, **kw,
    ))(jnp.asarray(rays9.numpy().reshape(B, 9, -1, 128))))

    scene = kernels.prepare_scene_pt(from_numpy(res.arrays._asdict(), "cpu"))
    table = tm.material_table(dicts, "cpu")
    tracer, _ = tw.make_pt_tracer(scene, stack_size=res.recommended_stack_size)

    def trace(live_rays):
        return tw._pt_trace(scene, table, tm.Environment.sky("cpu"), rays9, None, tracer=tracer,
                            live_rays=live_rays, **kw)

    got = trace(live).numpy()
    assert got.shape == want.shape == (B, 256, 3)
    assert not got[6:].any() and not want[6:].any()  # the dead packets add nothing
    close = np.all(np.abs(got[:6] - want[:6]) <= 1e-4, axis=-1)
    assert close.mean() >= 0.98, close.mean()
    assert got[:5].mean() > 0.05
    # The sixth packet holds only its live first sample: about half the others'.
    assert 0.25 < got[5].mean() / got[:5].mean() < 0.75
    assert torch.equal(trace(B * P0), trace(None))


# ---- the allocation, on seeded pilot and round sums -------------------------------


def _fake_rounds(bp=256, max_rounds=64):
    """Round functions for both packages that return one seeded table: the
    pilot's sums and squares, and per round and block fresh sums, zero past
    the live prefix. Noise grows with the block id, so the allocation is
    uneven."""
    rng = np.random.default_rng(11)
    psum = rng.uniform(0.0, 1.0, (B, bp, 3)).astype(np.float32)
    lum = psum @ np.float32([0.2126, 0.7152, 0.0722])
    spread = (np.arange(B, dtype=np.float32) ** 2)[:, None] * rng.uniform(0.0, 0.05, (B, bp)).astype(np.float32)
    psumsq = (lum * lum / 2 + spread).astype(np.float32)
    table = rng.uniform(0.0, 8.0, (max_rounds, B, bp, 3)).astype(np.float32)
    calls = {"jax": 0, "torch": 0}

    def sums(which, block_ids, live_rays, samples, with_sumsq):
        if with_sumsq:
            return psum, psumsq
        r = calls[which]
        calls[which] += 1
        part = table[r][np.asarray(block_ids)]
        part[int(live_rays) // (bp * samples):] = 0.0
        return part

    def fake_jax(state, materials, env, sampler, key, block_ids, live_rays, lights, *, samples, with_sumsq=False,
                 **kw):
        out = sums("jax", block_ids, live_rays, samples, with_sumsq)
        return tuple(map(jnp.asarray, out)) if with_sumsq else jnp.asarray(out)

    def fake_torch(state, materials, env, sampler, generator, block_ids, live_rays, lights, seed, *, samples,
                   with_sumsq=False, **kw):
        out = sums("torch", block_ids.numpy(), live_rays, samples, with_sumsq)
        return tuple(map(torch.from_numpy, out)) if with_sumsq else torch.from_numpy(out)

    return fake_jax, fake_torch, calls


@pytest.mark.parametrize("spp", [18, 42])
def test_allocation_and_combination_match_jax(monkeypatch, spp):
    fake_jax, fake_torch, calls = _fake_rounds()
    monkeypatch.setattr(jax_adaptive, "_chunk_blocks", fake_jax)
    monkeypatch.setattr(adaptive, "_chunk_blocks", fake_torch)
    js, sampler = _bench_sampler()
    kw = dict(width=W, height=H, spp=spp, pilot_spp=2, samples_per_packet=8, return_spp_map=True)
    want, want_map = jax_adaptive.render_frame_pt_adaptive(None, None, None, js, jax.random.key(0), **kw)
    got, got_map = adaptive.render_frame_pt_adaptive(None, None, None, sampler, torch.Generator().manual_seed(0),
                                                     **kw)
    np.testing.assert_array_equal(got_map.numpy(), np.asarray(want_map))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert calls["jax"] == calls["torch"] > 1
    assert got_map.min() >= 10 and got_map.max() > got_map.min()
    assert abs(float(got_map.mean()) - spp) <= 8


def test_allocate_chunks_sums_to_the_budget_with_a_floor_of_one():
    var = np.zeros((6, 4), np.float32)
    var[2] = 9.0
    var[4] = 1.0
    # 16 chunks beyond the floor go 3:1 to sigmas 3 and 1 (not 9:1, the variances).
    np.testing.assert_array_equal(adaptive.allocate_chunks(var, 22), [1, 1, 13, 1, 5, 1])
    # 14 leave two remainders of 0.5: the largest-remainder step gives one of them the last chunk.
    c = adaptive.allocate_chunks(var, 20)
    assert c.sum() == 20 and c.min() == 1 and c[2] + c[4] == 16 and {c[2], c[4]} <= {4, 5, 11, 12}


# ---- tests/test_adaptive.py's contracts, on the port --------------------------------


@pytest.fixture(scope="module")
def scene():
    sph = procedural.make_uv_sphere(1.0, rings=12, segments=20)
    sph.positions[:, 1] += 1.0
    floor = procedural.make_quad(30.0)
    p = floor.positions.copy()
    floor.positions = np.stack([p[:, 0], p[:, 2], p[:, 1]], axis=-1)
    mesh = procedural.merge_meshes([sph, floor])
    mats = np.concatenate([np.zeros(sph.triangle_count, np.int32), np.ones(floor.triangle_count, np.int32)])
    table = tm.material_table([tm.metal((0.9, 0.7, 0.4), fuzz=0.4), tm.lambertian((0.5, 0.55, 0.6))], "cpu")
    bvh = TriangleBvh.build(mesh, materials=mats)
    sampler = Camera().look_at((0, 2.2, 6), (0, 1.0, 0)).f_number(32.0).build_sampler((W, H), "cpu")
    tracer, state = tw.make_pt_tracer(bvh.pt_scene("cpu"), stack_size=bvh.recommended_stack_size, packet_size=256)
    return tracer, state, table, sampler, tm.Environment.sky("cpu")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_mean_matches_uniform(scene):
    tracer, state, table, sampler, env = scene
    kw = dict(width=W, height=H, bounces=3, env=env, px_block=(16, 16))
    a = np.mean([tw.render_frame_pt(tracer, state, table, sampler, _gen(i), spp=16, samples_per_packet=8,
                                    **kw)[..., :3].numpy() for i in range(2)], axis=0)
    b = np.mean([adaptive.render_frame_pt_adaptive(tracer, state, table, sampler, _gen(10 + i), spp=18, pilot_spp=2,
                                                   samples_per_packet=8, **kw)[..., :3].numpy() for i in range(2)],
                axis=0)
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=0.04)


def test_budget_and_allocation(scene):
    tracer, state, table, sampler, env = scene
    img, spp_map = adaptive.render_frame_pt_adaptive(
        tracer, state, table, sampler, _gen(3), width=W, height=H, spp=26, bounces=3, env=env, px_block=(16, 16),
        pilot_spp=2, samples_per_packet=8, return_spp_map=True,
    )
    img, spp_map = img.numpy(), spp_map.numpy()
    assert np.isfinite(img).all() and img.shape == (H, W, 4)
    assert spp_map.min() >= 2 + 8
    assert abs(spp_map.mean() - 26) <= 8
    assert spp_map.max() > spp_map.min()


def test_adaptive_with_nee():
    floor = procedural.make_quad(40.0)
    p = floor.positions.copy()
    floor.positions = np.stack([p[:, 0], p[:, 2], p[:, 1]], axis=-1)
    panel = procedural.make_quad(6.0)
    pp = panel.positions.copy()
    panel.positions = np.stack([pp[:, 0], np.full_like(pp[:, 2], 8.0), pp[:, 1]], axis=-1)
    mesh = procedural.merge_meshes([floor, panel])
    mats = np.concatenate([np.zeros(floor.triangle_count, np.int32), np.ones(panel.triangle_count, np.int32)])
    table = tm.material_table([tm.lambertian((0.6, 0.6, 0.6)), tm.emissive((6.0, 6.0, 6.0))], "cpu")
    bvh = TriangleBvh.build(mesh, materials=mats)
    lights = tm.build_light_table(bvh.host_arrays.tri_packets, bvh.host_arrays.tri_material, table)
    pt_scene = bvh.pt_scene("cpu")
    tracer, _ = tw.make_pt_tracer(pt_scene, stack_size=bvh.recommended_stack_size, packet_size=256)
    shadow, _ = tw.make_pt_shadow_tracer(pt_scene, stack_size=bvh.recommended_stack_size, packet_size=256)
    sampler = Camera().look_at((0, 6, 14), (0, 0, 0)).f_number(32.0).build_sampler((32, 32), "cpu")
    kw = dict(width=32, height=32, bounces=3, env=tm.Environment.uniform((0.0, 0.0, 0.0), "cpu"), px_block=(16, 16),
              lights=lights, shadow_tracer=shadow)
    a = tw.render_frame_pt(tracer, pt_scene, table, sampler, _gen(0), spp=16, samples_per_packet=8, **kw)[..., :3]
    b = adaptive.render_frame_pt_adaptive(tracer, pt_scene, table, sampler, _gen(1), spp=18, pilot_spp=2,
                                          samples_per_packet=8, **kw)[..., :3]
    np.testing.assert_allclose(a.mean().item(), b.mean().item(), rtol=0.06)
    c = adaptive.render_frame_pt_adaptive(tracer, pt_scene, table, sampler, _gen(2), spp=18, pilot_spp=2,
                                          samples_per_packet=8, nee_max_depth=1, **kw)[..., :3]
    np.testing.assert_allclose(a.mean().item(), c.mean().item(), rtol=0.06)


def test_budget_too_small_raises(scene):
    tracer, state, table, sampler, env = scene
    with pytest.raises(ValueError, match="must cover the pilot"):
        adaptive.render_frame_pt_adaptive(tracer, state, table, sampler, _gen(0), width=W, height=H, spp=4,
                                          bounces=3, env=env, pilot_spp=2, samples_per_packet=8)
