"""The port's two-level tracer (``minipath_tpu_torch/render/twolevel.py``)
against the JAX package's, and against the port's flat tracer.

The JAX side runs K2 in interpret mode, as tests/test_twolevel.py does; the
port's runs K2's plain version on the CPU. Tolerances, each with its reason:

- ``build_treelets``, ``broad_phase`` (``tid``, ``valid``, ``overflow``) and
  ``_plan_round`` are equal array for array: the same float32 slab steps,
  ties in entry distance (rays that start inside several treelet boxes all
  enter them at 0) resolved to the lower treelet id as ``jax.lax.top_k``
  does, and a stable sort of the same int32 keys. ``entry`` within 1e-6
  relative.
- The tracer: ``tri`` equal, ``t`` within 1e-5 relative and 1e-6 absolute,
  normals and texture coordinates within 1e-4 relative and 1e-5 absolute
  (tests/test_twolevel.py's tolerances).
- The whole frame: the seed-matched Sobol frame (no roulette fires in 3
  bounces, shadow roulette off) equals the port's flat-tracer frame bit for
  bit, and the JAX frame through the JAX two-level tracer within
  tests/test_torch_wavefront.py's tolerances (98% of pixels within 1e-4, means
  within 1e-3 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minipath_tpu import camera as jax_camera
from minipath_tpu.render import twolevel as jt
from minipath_tpu.render import wavefront as jw
from minipath_tpu.render.pallas_kernels import prepare_scene_pt as jax_prepare_scene_pt
from minipath_tpu.scene import materials as jm
from minipath_tpu.scene import procedural as jax_procedural
from minipath_tpu.scene.bvh.build import build_bvh as jax_build_bvh
from minipath_tpu_torch.camera import CameraSampler
from minipath_tpu_torch.render import kernels
from minipath_tpu_torch.render import twolevel as tt
from minipath_tpu_torch.render import wavefront as tw
from minipath_tpu_torch.render.kernels_q import prepare_scene_qpt
from minipath_tpu_torch.scene import materials as tm
from minipath_tpu_torch.scene.bvh import links as L
from minipath_tpu_torch.scene.bvh.build import from_numpy

P = 256  # rays per packet


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """The plain traversal is thousands of small ops, which gain nothing from
    many threads and lose a lot when several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scenes(res):
    return res, jax_prepare_scene_pt(res.as_device()), kernels.prepare_scene_pt(from_numpy(res.arrays._asdict(), "cpu"))


@pytest.fixture(scope="module")
def sphere():
    """tests/test_twolevel.py's sphere: 960 triangles, every level-2 treelet
    a leaf."""
    return _scenes(jax_build_bvh(jax_procedural.make_uv_sphere(1.0, rings=16, segments=32)))


@pytest.fixture(scope="module")
def atrium():
    """``make_atrium(0)`` (13,412 triangles) with the benchmark materials,
    leaves of up to 24 triangles: 57 treelets at levels 2, 204 at levels 3."""
    mesh = jax_procedural.make_atrium(0)
    ids, dicts = jax_procedural.atrium_materials(mesh)
    res = jax_build_bvh(mesh, materials=ids, leaf_max=24)
    return (*_scenes(res), dicts)


def _rays(rng, n, lo, hi):
    """Origins in the box widened by 1 on each side (many inside several
    treelet boxes, whose entries then tie at 0); half the directions
    random, half aimed at a random point of the box."""
    o = rng.uniform(lo - 1.0, hi + 1.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    aim = rng.uniform(lo, hi, (n, 3)) - o
    d[: n // 2] = aim[: n // 2]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    with np.errstate(divide="ignore"):
        inv = np.where(d == 0, np.inf, 1.0 / d).astype(np.float32)
    return o, d, inv


def _box(res):
    return np.asarray(res.arrays.bbox_min), np.asarray(res.arrays.bbox_max)


@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("scene", ["sphere", "atrium"])
def test_build_treelets_matches_jax(request, scene, levels):
    res = request.getfixturevalue(scene)[0]
    want = jt.build_treelets(res.arrays, levels)
    got = tt.build_treelets(res.arrays, levels, device="cpu")
    for name in want._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    leaves = int(((got.links.numpy() & L.COUNT_MASK) != 0).sum())
    assert leaves > 0  # leaf roots: a leaf met above the cut is a treelet of its own
    if (scene, levels) == ("atrium", 3):
        assert len(got.links) > tt.CHUNK  # the broad phase's chunked merge runs


@pytest.mark.parametrize("levels", [2, 3])
def test_treelet_extraction_covers_tree(atrium, levels):
    """Treelet links partition the frontier: every leaf is reachable from
    exactly one treelet, and treelet boxes sit inside the root box (the
    port of tests/test_twolevel.py's coverage test)."""
    res = atrium[0]
    tl = tt.build_treelets(res.arrays, levels, device="cpu")
    links = tl.links.numpy()
    assert links.size >= 1 and not np.any(links == L.NULL_LINK)
    bmin, bmax = tl.box_min.numpy(), tl.box_max.numpy()
    assert np.all(bmin <= bmax)
    root_min, root_max = _box(res)
    eps = 1e-4 * (1 + np.abs(root_max - root_min))
    assert np.all(bmin >= root_min - eps) and np.all(bmax <= root_max + eps)
    node_links = np.asarray(res.arrays.node_child_links)

    def leaves(link):
        if link == L.NULL_LINK:
            return []
        if L.is_leaf(link):
            return [link]
        return [x for c in node_links[L.decode_index(link)] for x in leaves(int(c))]

    via_treelets = [x for link in links for x in leaves(int(link))]
    assert len(via_treelets) == len(set(via_treelets))
    assert sorted(via_treelets) == sorted(leaves(int(np.asarray(res.arrays.root))))


@pytest.mark.parametrize("K", [4, 8])
@pytest.mark.parametrize("levels", [2, 3])
def test_broad_phase_matches_jax(atrium, levels, K):
    res = atrium[0]
    rng = np.random.default_rng(10 * levels + K)
    n = 3000
    o, d, inv = _rays(rng, n, *_box(res))
    live = rng.uniform(size=n) < 0.9
    want = jt.broad_phase(jt.build_treelets(res.arrays, levels), jnp.asarray(o), jnp.asarray(d), jnp.asarray(inv),
                          jnp.asarray(live), K)
    got = tt.broad_phase(tt.build_treelets(res.arrays, levels, device="cpu"), torch.from_numpy(o),
                         torch.from_numpy(d), torch.from_numpy(inv), torch.from_numpy(live), K)
    tid, entry, valid, overflow = (x.numpy() for x in got)
    np.testing.assert_array_equal(tid, np.asarray(want[0]))
    np.testing.assert_allclose(entry, np.asarray(want[1]), rtol=1e-6)
    np.testing.assert_array_equal(valid, np.asarray(want[2]))
    np.testing.assert_array_equal(overflow, np.asarray(want[3]))
    assert tid.dtype == np.int32 and tid.shape == (n, K)
    assert (entry[:, 1] == 0).sum() > 50  # ties at 0 among a ray's treelets
    assert (overflow.any() or K == 8) and not overflow[~live].any() and not valid[~live].any()


def test_plan_round_matches_jax(atrium):
    """Round 0 and round 1 of a levels-3 tracer, and the leftover round into
    the whole-tree bucket, planned from the same broad phase."""
    res = atrium[0]
    rng = np.random.default_rng(3)
    n = 2000
    o, d, inv = _rays(rng, n, *_box(res))
    live = rng.uniform(size=n) < 0.8
    jtl, ttl = jt.build_treelets(res.arrays, 3), tt.build_treelets(res.arrays, 3, device="cpu")
    T = len(ttl.links)
    tid, entry, valid, overflow = (np.asarray(x) for x in jt.broad_phase(
        jtl, jnp.asarray(o), jnp.asarray(d), jnp.asarray(inv), jnp.asarray(live), 8))
    jlinks = jnp.concatenate([jtl.links, jtl.root_link.reshape(1)])
    tlinks = torch.cat([ttl.links, ttl.root_link.reshape(1)])
    best_t = rng.uniform(0, 30, n).astype(np.float32)  # some rays already occluded
    cases = [(tid[:, r], valid[:, r] & ~overflow & (best_t >= entry[:, r])) for r in (0, 1)]
    cases.append((np.full(n, T, np.int32), (overflow & live) | (valid[:, 2] & (best_t >= entry[:, 2]))))
    for r_tid, need in cases:
        want = jt._plan_round(jnp.asarray(r_tid), jnp.asarray(need), jnp.asarray(o), jnp.asarray(d), jlinks,
                              n_buckets=T + 1, packet_size=P)
        got = tt._plan_round(torch.from_numpy(r_tid.copy()), torch.from_numpy(need.copy()), torch.from_numpy(o),
                             torch.from_numpy(d), tlinks, n_buckets=T + 1, packet_size=P)
        for name in want._fields:
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
        assert need.any() and int(got.live_packets) >= -(-int(need.sum()) // P)
        assert got.roots.dtype == torch.int32 and got.ray_slot.shape == ((-(-n // P) + T + 1) * P,)


@pytest.fixture(scope="module")
def sphere_rays():
    rng = np.random.default_rng(1234)
    o, d, inv = _rays(rng, 768, np.full(3, -2.0), np.full(3, 2.0))
    return o, d, inv, rng.uniform(size=768) < 0.8


def _port_tracer(scene, res, rounds, levels=2, **kw):
    tl = tt.build_treelets(res.arrays, levels, device="cpu")
    return tt.make_pt_tracer_twolevel(scene, tl, stack_size=kw.pop("stack_size", res.recommended_stack_size),
                                      packet_size=P, K=8, rounds=rounds, **kw)[0]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("rounds", [1, 2, 3])
def test_tracer_matches_jax_and_flat(sphere, sphere_rays, rounds):
    res, jscene, scene = sphere
    o, d, inv, live = sphere_rays
    stack = res.recommended_stack_size
    jtracer, _ = jt.make_pt_tracer_twolevel(jscene, jt.build_treelets(res.arrays, 2), stack_size=stack,
                                            packet_size=P, K=8, rounds=rounds, interpret=True)
    want = jtracer(jscene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(inv), jnp.asarray(live))
    got = _port_tracer(scene, res, rounds)(scene, *_t(o, d, inv, live))
    flat = tw.make_pt_tracer(scene, stack_size=stack, packet_size=P)[0](scene, *_t(o, d, inv))
    tri = got.tri.numpy()
    np.testing.assert_array_equal(tri, np.asarray(want.tri))
    assert not (tri[~live] >= 0).any()
    np.testing.assert_array_equal(tri[live], flat.tri.numpy()[live])
    hit = tri >= 0
    assert hit.sum() > 100
    for other in (want, flat):
        a = live & hit
        np.testing.assert_allclose(got.t.numpy()[a], np.asarray(other.t)[a], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.normal.numpy()[a], np.asarray(other.normal)[a], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got.texture_coords.numpy()[a], np.asarray(other.texture_coords)[a], rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_array_equal(got.material.numpy(), np.asarray(want.material))
    assert np.all(np.isinf(got.t.numpy()[~hit]))
    assert got.overflow.shape == (1,) and int(got.overflow) == 0 and int(got.inner_visits) > 0


def test_forms_of_live_agree(sphere, sphere_rays):
    """An int, a one-element tensor and the equivalent mask give the same
    hits; rays past the live prefix miss."""
    res, _, scene = sphere
    o, d, inv, _ = sphere_rays
    tracer = _port_tracer(scene, res, 2)
    n_live = 500
    runs = [tracer(scene, *_t(o, d, inv), live) for live in
            (n_live, torch.tensor([n_live], dtype=torch.int32), torch.arange(768) < n_live)]
    every = tracer(scene, *_t(o, d, inv))
    for r in runs:
        for name in ("t", "tri", "normal", "material", "texture_coords", "overflow", "inner_visits", "leaf_tests"):
            assert torch.equal(getattr(r, name), getattr(runs[0], name)), name
    assert torch.equal(runs[0].tri[:n_live], every.tri[:n_live]) and bool((runs[0].tri[n_live:] == -1).all())
    assert (every.tri[n_live:] >= 0).any()


def test_overflow_is_reported(atrium, monkeypatch):
    """At a stack of 1 the rounds drop pushes: the returned overflow is > 0,
    and every counter is the sum of the rounds' counters."""
    res, _, scene, _ = atrium
    rounds_out = []
    real = tt.trace_packets_pt

    def recording(*args, **kw):
        out = real(*args, **kw)
        rounds_out.append(out)
        return out

    monkeypatch.setattr(tt, "trace_packets_pt", recording)
    rng = np.random.default_rng(5)
    o, d, inv = _rays(rng, 512, *_box(res))
    got = _port_tracer(scene, res, 2, stack_size=1)(scene, *_t(o, d, inv))
    assert len(rounds_out) == 3  # two rounds and the leftover pass
    for name in ("overflow", "inner_visits", "leaf_tests"):
        assert int(getattr(got, name)) == sum(int(getattr(r, name).sum()) for r in rounds_out), name
    assert int(got.overflow) > 0


def test_quantized_layout_raises(atrium):
    res = atrium[0]
    qscene = prepare_scene_qpt(res.arrays, "cpu")
    tl = tt.build_treelets(res.arrays, 2, device="cpu")
    with pytest.raises(TypeError, match="PTScene"):
        tt.make_pt_tracer_twolevel(qscene, tl, stack_size=res.recommended_stack_size)
    tracer, _ = tt.make_pt_tracer_twolevel(atrium[2], tl, stack_size=res.recommended_stack_size)
    o = torch.zeros((4, 3))
    with pytest.raises(TypeError, match="PTScene"):
        tracer(qscene, o, o + 1, o + 1)


@pytest.mark.parametrize("nee", [False, True], ids=["bsdf", "nee"])
def test_seed_matched_sobol_frame(atrium, nee):
    res, jscene, scene, dicts = atrium
    W = H = 16
    seed = 1234567
    kw = dict(width=W, height=H, spp=2, bounces=3, samples_per_packet=2, sobol=True, shadow_rr=False)
    ss = res.recommended_stack_size
    jtable = jm.material_table(dicts)
    jtracer, _ = jt.make_pt_tracer_twolevel(jscene, jt.build_treelets(res.arrays, 2), stack_size=ss, packet_size=P,
                                            interpret=True)
    jshadow = jlights = None
    if nee:
        jshadow, _ = jw.make_pt_shadow_tracer(jscene, stack_size=ss, interpret=True)
        jlights = jm.build_light_table(res.arrays.tri_packets, res.arrays.tri_material, jtable)
    camera = jax_camera.Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(36e-3)
    jsampler = camera.build_sampler((W, H))
    want = np.asarray(jw.render_frame_pt(jtracer, jscene, jtable, jsampler, jax.random.key(0), strat_seed=seed,
                                         lights=jlights, shadow_tracer=jshadow, **kw))

    table = tm.material_table(dicts, "cpu")
    shadow = lights = None
    if nee:
        shadow, _ = tw.make_pt_shadow_tracer(scene, stack_size=ss)
        lights = tm.build_light_table(res.arrays.tri_packets, res.arrays.tri_material, table)
    sampler = CameraSampler.from_numpy({k: np.asarray(v) for k, v in jsampler._asdict().items()}, "cpu")

    def frame(tracer):
        return tw.render_frame_pt(tracer, scene, table, sampler, None, strat_seed=seed, lights=lights,
                                  shadow_tracer=shadow, **kw).numpy()

    got = frame(_port_tracer(scene, res, 2))
    np.testing.assert_array_equal(got, frame(tw.make_pt_tracer(scene, stack_size=ss)[0]))
    assert got.shape == want.shape == (H, W, 4) and np.isfinite(got).all()
    close = np.all(np.abs(got - want) <= 1e-4, axis=-1)
    assert close.mean() >= 0.98, close.mean()
    np.testing.assert_allclose(got[..., :3].mean(), want[..., :3].mean(), rtol=1e-3)
    assert got[..., :3].mean() > 0.05
