"""The portable-engine tracers (``render/wavefront.py::make_portable_tracer``
and ``make_portable_shadow_tracer``) against the JAX package's
``make_xla_tracer`` and ``make_xla_shadow_tracer``, on the CPU.

Both packages get the same BVH arrays (built once by the JAX builder) and
the same rays, made with numpy from a seed. Tolerances: the triangle ids
and the occlusion bits are equal; ``t`` within 1e-5 relative and normals
within 1e-4, because XLA:CPU fuses the dot products' multiply-adds where
torch rounds each step. Against the port's plain K2 (``make_pt_tracer`` on
the CPU), an engine that shares no code with this one, the triangle ids
are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minipath_tpu.render import wavefront as jw
from minipath_tpu.scene import procedural as jax_procedural
from minipath_tpu.scene.bvh.build import BvhArrays as JaxBvhArrays
from minipath_tpu.scene.bvh.build import build_bvh as jax_build_bvh
from minipath_tpu_torch.render import kernels
from minipath_tpu_torch.render import wavefront as tw
from minipath_tpu_torch.scene.bvh.build import from_numpy

T_RTOL, NORMAL_ATOL = 1e-5, 1e-4
N_RAYS = 2048


def _atrium_rays(rng, n):
    """Half from the benchmark viewpoint into the hall, half from random
    points inside it, as ``tools/parity_big.py`` makes them."""
    o = np.concatenate([
        np.tile(np.float32([-16.0, 4.0, 0.0]), (n // 2, 1)),
        rng.uniform([-18, 0.5, -8], [18, 12, 8], (n // 2, 3)).astype(np.float32),
    ])
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 2] += np.float32([3.0, 0.0, 0.0])
    tgt = rng.uniform([-18, 0.5, -8], [18, 12, 8], (n, 3)).astype(np.float32)
    return o, d, tgt


def _sphere_rays(rng, n):
    """From outside the sphere at it, a few missing at the rim; segments to
    points on both sides of it."""
    o = np.tile(np.float32([0.2, 0.1, -5.0]), (n, 1)) + 0.5 * rng.normal(size=(n, 3)).astype(np.float32)
    d = np.float32([0, 0, 1]) + 0.25 * rng.normal(size=(n, 3)).astype(np.float32)
    tgt = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    return o, d, tgt


SCENES = {
    "atrium": (lambda: jax_procedural.make_atrium(0), _atrium_rays),
    "sphere_mesh": (lambda: jax_procedural.make_uv_sphere(1.0, rings=16, segments=24), _sphere_rays),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    make_mesh, make_rays = SCENES[request.param]
    res = jax_build_bvh(make_mesh(), leaf_max=24)
    o, d, tgt = make_rays(np.random.default_rng(7), N_RAYS)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    inv = np.where(d == 0, np.inf, 1.0 / d).astype(np.float32)
    return res, (o, d, inv), tgt - o


def _jax(res):
    return JaxBvhArrays(*(jnp.asarray(a) for a in res.arrays))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_portable_tracer_matches_xla_tracer(case):
    res, rays, _ = case
    stack = res.recommended_stack_size
    jtr, jstate = jw.make_xla_tracer(_jax(res), stack_size=stack, packet_size=256)
    want = jtr(jstate, *(jnp.asarray(a) for a in rays))
    tr, state = tw.make_portable_tracer(from_numpy(res.arrays._asdict(), "cpu"), stack_size=stack)
    got = tr(state, *(torch.from_numpy(a) for a in rays), live_rays=5)  # live_rays is ignored
    tri = got.tri.numpy()
    np.testing.assert_array_equal(tri, np.asarray(want.tri))
    hit = tri >= 0
    assert 0.2 < hit.mean() < 1.0 or hit.all()
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=T_RTOL)
    assert np.isinf(got.t.numpy()[~hit]).all()
    np.testing.assert_allclose(got.normal.numpy()[hit], np.asarray(want.normal)[hit], rtol=0, atol=NORMAL_ATOL)
    np.testing.assert_array_equal(got.material.numpy()[hit], np.asarray(want.material)[hit])
    assert got.texture_coords.shape == (N_RAYS, 3) and int(got.overflow.sum()) == 0


def test_portable_shadow_tracer_matches_xla_shadow_tracer(case):
    res, (o, _, _), seg = case
    stack = res.recommended_stack_size
    jsh, jstate = jw.make_xla_shadow_tracer(_jax(res), stack_size=stack, packet_size=256)
    want = np.asarray(jsh(jstate, jnp.asarray(o), jnp.asarray(seg)))
    sh, state = tw.make_portable_shadow_tracer(from_numpy(res.arrays._asdict(), "cpu"), stack_size=stack)
    got = sh(state, torch.from_numpy(o), torch.from_numpy(seg)).numpy()
    assert got.dtype == np.bool_ and got.shape == (N_RAYS,)
    np.testing.assert_array_equal(got, want)
    assert 0.0 < got.mean() < 1.0


def test_portable_tracers_match_plain_k2(case):
    """An independent engine: the plain K2 (one ray at a time, a stack of
    its own) finds the same triangles and the same occlusion."""
    res, rays, seg = case
    stack = res.recommended_stack_size
    arrays = from_numpy(res.arrays._asdict(), "cpu")
    scene = kernels.prepare_scene_pt(arrays)
    t_rays = [torch.from_numpy(a) for a in rays]
    want = tw.make_pt_tracer(scene, stack_size=stack)[0](scene, *t_rays)
    got = tw.make_portable_tracer(arrays, stack_size=stack)[0](arrays, *t_rays)
    np.testing.assert_array_equal(got.tri.numpy(), want.tri.numpy())
    o, s = t_rays[0], torch.from_numpy(seg)
    np.testing.assert_array_equal(
        tw.make_portable_shadow_tracer(arrays, stack_size=stack)[0](arrays, o, s).numpy(),
        tw.make_pt_shadow_tracer(scene, stack_size=stack)[0](scene, o, s).numpy(),
    )


def test_portable_tracer_pads_to_whole_packets():
    """A ray count that is not a multiple of the packet: the last ray is
    repeated and the results cut back, equal to a whole-packet trace."""
    res = jax_build_bvh(jax_procedural.make_uv_sphere(1.0, rings=8, segments=12))
    o, d, _ = _sphere_rays(np.random.default_rng(3), 512)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = [torch.from_numpy(a) for a in (o, d, 1.0 / d)]
    arrays = from_numpy(res.arrays._asdict(), "cpu")
    tr, _ = tw.make_portable_tracer(arrays, stack_size=res.recommended_stack_size)
    whole = tr(arrays, *rays)
    part = tr(arrays, *(r[:300] for r in rays))
    assert part.tri.shape == (300,) and part.normal.shape == (300, 3)
    np.testing.assert_array_equal(part.tri.numpy(), whole.tri.numpy()[:300])
    np.testing.assert_array_equal(part.t.numpy(), whole.t.numpy()[:300])
