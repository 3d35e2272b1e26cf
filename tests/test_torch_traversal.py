"""The port's portable traversal engine (``render/traversal.py``) against the
JAX package's, on the CPU.

Both engines get the same BVH arrays (the port's builder equals the JAX
package's bit for bit, tests/test_torch_package.py) and the same rays, made
with numpy. Tolerances: the triangle ids are equal; ``t`` within 1e-5
relative, because XLA:CPU fuses the dot products' multiply-adds where torch
rounds each step; normals and texture coordinates within 1e-5 absolute for
the same reason. Against the port's own brute force the BVH trace keeps the
JAX test's rule (tests/test_bvh.py): the same hits, ``t`` within 1e-5, and
the same triangle up to an exact t-tie between adjacent triangles.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minipath_tpu.geometry import make_rays as jax_make_rays
from minipath_tpu.geometry.aabb import slab_test as jax_slab_test
from minipath_tpu.render import traversal as jt
from minipath_tpu.scene.bvh.build import BvhArrays as JaxBvhArrays
from minipath_tpu.scene.triangle_bvh import TriangleBvh as JaxTriangleBvh
from minipath_tpu_torch import TriangleBvh
from minipath_tpu_torch.geometry.aabb import slab_test
from minipath_tpu_torch.geometry.ray import Rays
from minipath_tpu_torch.render import traversal as tt
from minipath_tpu_torch.render.hit import miss_records
from minipath_tpu_torch.scene import procedural
from minipath_tpu_torch.scene.bvh.build import build_bvh
from minipath_tpu_torch.scene.obj_loader import MeshData

T_RTOL, ATTR_ATOL = 1e-5, 1e-5


def _sphere_rays(rng):
    """Coherent packets: from outside the sphere, perturbed directions at
    it, with a few misses at the rim."""
    origin = np.tile(np.array([0.2, 0.1, -5.0], np.float32), (6, 96, 1))
    direction = np.array([0, 0, 1], np.float32) + 0.25 * rng.normal(size=(6, 96, 3)).astype(np.float32)
    return origin, direction


def _random_rays(rng, B=8, P=64, extent=11.0):
    origin = rng.uniform(-extent, extent, (B, P, 3)).astype(np.float32)
    direction = rng.normal(size=(B, P, 3)).astype(np.float32)
    return origin, direction


SCENES = {
    "uv_sphere": (lambda P: P.make_uv_sphere(1.0, rings=14, segments=22), _sphere_rays),
    "random_triangles": (lambda P: P.make_random_triangles(1500, seed=3), _random_rays),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    make_mesh, make_ray_arrays = SCENES[request.param]
    build = build_bvh(make_mesh(procedural))
    origin, direction = make_ray_arrays(np.random.default_rng(7))
    jrays = jax_make_rays(origin, direction)
    # The same rays on both sides, bit for bit.
    trays = Rays(*(torch.from_numpy(np.array(f)) for f in jrays))
    return build, jrays, trays


def _jax_bvh(build):
    """The build's arrays as the JAX engine takes them."""
    return JaxBvhArrays(*(jnp.asarray(a) for a in build.arrays))


def test_trace_packets_matches_jax(case):
    build, jrays, trays = case
    stack = build.recommended_stack_size
    want = jt.trace_packets(_jax_bvh(build), jrays, stack_size=stack)
    got = tt.trace_packets(build.as_device("cpu"), trays, stack_size=stack)
    want_tri, want_t = np.asarray(want.tri), np.asarray(want.t)
    assert np.array_equal(got.tri.numpy(), want_tri)
    hits = want_tri >= 0
    assert 0.2 < hits.mean() < 1.0
    np.testing.assert_allclose(got.t.numpy()[hits], want_t[hits], rtol=T_RTOL)
    assert np.isinf(got.t.numpy()[~hits]).all()
    assert int(got.overflow) == int(want.overflow) == 0
    assert int(got.steps) == int(want.steps)


def test_finalize_hits_matches_jax(case):
    build, jrays, trays = case
    stack = build.recommended_stack_size
    want = jt.intersect_bvh(_jax_bvh(build), jrays, stack_size=stack)
    tbvh = build.as_device("cpu")
    got = tt.finalize_hits(tbvh, trays, tt.trace_packets(tbvh, trays, stack_size=stack))
    assert torch.equal(got.hit, torch.from_numpy(np.asarray(want.hit)))
    assert np.array_equal(got.material.numpy(), np.asarray(want.material))
    hit = np.asarray(want.hit)
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=T_RTOL)
    for field in ("point", "normal", "texture_coords"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)), atol=ATTR_ATOL,
                                   err_msg=field)
    np.testing.assert_allclose(np.linalg.norm(got.normal.numpy()[hit], axis=-1), 1.0, atol=1e-5)
    again = tt.intersect_bvh(tbvh, trays, stack_size=stack)
    for a, b in zip(again, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("t_max", [math.inf, 6.0])
def test_brute_force_matches_jax(case, t_max):
    build, jrays, trays = case
    want = jt.trace_brute_force(jnp.asarray(build.arrays.tri_packets), jrays, t_max=t_max)
    got = tt.trace_brute_force(torch.from_numpy(build.arrays.tri_packets), trays, t_max=t_max)
    want_tri = np.asarray(want.tri)
    assert np.array_equal(got.tri.numpy(), want_tri)
    hits = want_tri >= 0
    np.testing.assert_allclose(got.t.numpy()[hits], np.asarray(want.t)[hits], rtol=T_RTOL)
    assert np.isinf(got.t.numpy()[~hits]).all()


@pytest.mark.parametrize("t_max", [math.inf, 6.0])
def test_bvh_trace_equals_brute_force(case, t_max):
    build, _, trays = case
    bvh = build.as_device("cpu")
    got = tt.trace_packets(bvh, trays, t_max=t_max, stack_size=build.recommended_stack_size)
    want = tt.trace_brute_force(bvh.tri_packets, trays, t_max=t_max)
    hits = want.tri >= 0
    assert torch.equal(got.tri >= 0, hits)
    torch.testing.assert_close(got.t[hits], want.t[hits], rtol=T_RTOL, atol=0)
    tie = (got.t - want.t).abs() <= T_RTOL * want.t.abs()
    assert bool(((got.tri == want.tri) | tie)[hits].all())


@pytest.mark.parametrize("stack_size", [1, 2, 4])
def test_overflow_is_reported_with_a_tiny_stack(case, stack_size):
    """A stack too small drops pushes; both engines count the same drops and
    keep the same (possibly incomplete) hits."""
    build, jrays, trays = case
    want = jt.trace_packets(_jax_bvh(build), jrays, stack_size=stack_size)
    got = tt.trace_packets(build.as_device("cpu"), trays, stack_size=stack_size)
    assert int(got.overflow) == int(want.overflow) > 0
    assert np.array_equal(got.tri.numpy(), np.asarray(want.tri))


def test_slab_test_nan_rule_matches_jax():
    """Origins on a degenerate slab (0 * inf = NaN) take the reference's NaN
    rule: -inf for the near plane, +inf for the far one."""
    rng = np.random.default_rng(3)
    bmin = rng.uniform(-2, 0, (64, 3)).astype(np.float32)
    bmax = bmin + rng.uniform(0, 2, (64, 3)).astype(np.float32)
    bmax[:16, 0] = bmin[:16, 0]  # flat boxes
    origin = rng.uniform(-3, 3, (64, 3)).astype(np.float32)
    origin[:32, 0] = bmin[:32, 0]  # on the slab's plane
    direction = rng.normal(size=(64, 3)).astype(np.float32)
    direction[:48, 0] = 0.0  # parallel to it
    inv = np.where(direction == 0, np.inf, 1.0 / direction).astype(np.float32)
    t_clip = rng.uniform(1, 5, 64).astype(np.float32)
    w1, w2 = (np.asarray(a) for a in jax_slab_test(bmin, bmax, origin, inv, t_clip))
    g1, g2 = slab_test(*(torch.from_numpy(a) for a in (bmin, bmax, origin, inv, t_clip)))
    assert np.array_equal(g1.numpy(), w1) and np.array_equal(g2.numpy(), w2)
    assert not np.isnan(g1.numpy()).any() and not np.isnan(g2.numpy()).any()
    assert ((w1 <= w2) != (g1.numpy() > g2.numpy())).all()


def test_empty_scene_misses_everything():
    build = build_bvh(MeshData())
    rays = Rays(torch.zeros(1, 4, 3), torch.ones(1, 4, 3), torch.ones(1, 4, 3))
    res = tt.trace_packets(build.as_device("cpu"), rays, stack_size=8)
    assert (res.tri == -1).all() and torch.isinf(res.t).all() and int(res.steps) == 0


def test_triangle_bvh_intersect_matches_jax():
    """``TriangleBvh.intersect`` (stack from the build), as the JAX
    package's: rays from inside a sphere all hit, smooth normals."""
    rng = np.random.default_rng(4)
    direction = rng.normal(size=(1, 128, 3)).astype(np.float32)
    origin = np.zeros((1, 128, 3), np.float32)
    jrays = jax_make_rays(origin, direction)
    want = JaxTriangleBvh.build(procedural.make_uv_sphere(rings=16, segments=32)).intersect(jrays)
    got = TriangleBvh.build(procedural.make_uv_sphere(rings=16, segments=32)).intersect(
        Rays(*(torch.from_numpy(np.array(f)) for f in jrays)))
    assert got.hit.all() and np.asarray(want.hit).all()
    np.testing.assert_allclose(got.normal.numpy(), np.asarray(want.normal), atol=ATTR_ATOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=T_RTOL)


def test_miss_records_shape():
    m = miss_records((2, 3))
    assert m.hit.shape == (2, 3) and not m.hit.any() and torch.isinf(m.t).all()
    assert m.normal.shape == (2, 3, 3) and m.material.dtype == torch.int32
