"""The port's traversal (K1) against the JAX package's Pallas kernel.

The plain PyTorch version runs here, on the CPU; the JAX kernel runs in
interpret mode, as tests/test_pallas.py runs it. Tolerances: ``t`` within
1e-5 relative and the normal within 1e-5 absolute (float32 arithmetic in a
different order: the TPU kernel traverses per packet, the port per ray);
``tri`` equal on at least 99.9% of rays, and every mismatch a tie whose two
candidates' ``t`` agree within 1e-5 relative; the material equal wherever
``tri`` matches. The CUDA kernel is compared with the plain version on the
card in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minipath_tpu import camera as jax_camera
from minipath_tpu.geometry.ray import make_rays as jax_make_rays
from minipath_tpu.render.pallas_kernels import prepare_scene as jax_prepare_scene
from minipath_tpu.render.pallas_kernels import trace_packets_pallas
from minipath_tpu.scene.bvh.build import build_bvh as jax_build_bvh
from minipath_tpu.scene.obj_loader import MeshData
from minipath_tpu.scene.procedural import make_cube, make_random_triangles, make_uv_sphere, merge_meshes
from minipath_tpu_torch.render import kernels
from minipath_tpu_torch.scene.bvh.build import from_numpy

RTOL = 1e-5


def _scenes(mesh):
    res = jax_build_bvh(mesh)
    return res, jax_prepare_scene(res.as_device()), kernels.prepare_scene(from_numpy(res.arrays._asdict(), "cpu"))


def _rays9(o, d):
    """Numpy (B, P, 3) origins/directions -> port rays9 (B, 9, P) and the JAX
    kernel's (B, 9, P/128, 128), from the same JAX-made rays."""
    r = jax_make_rays(o, d)
    stacked = np.concatenate([np.asarray(r.origin), np.asarray(r.direction), np.asarray(r.inv_direction)], -1)
    r9 = np.ascontiguousarray(np.swapaxes(stacked, 1, 2))  # (B, 9, P)
    B, _, P = r9.shape
    return torch.from_numpy(r9), jnp.asarray(r9.reshape(B, 9, P // 128, 128))


def _compare(got: kernels.KernelHits, want, min_tri_match=0.999):
    t, tri = got.t.numpy(), got.tri.numpy()
    wt, wtri = np.asarray(want.t), np.asarray(want.tri)
    assert t.shape == wt.shape and tri.dtype == np.int32
    same = tri == wtri
    assert same.mean() >= min_tri_match, same.mean()
    # A mismatch must be a tie: both candidates at the same distance.
    np.testing.assert_allclose(t[~same], wt[~same], rtol=RTOL)
    np.testing.assert_allclose(t[same], wt[same], rtol=RTOL)
    np.testing.assert_allclose(got.normal.numpy()[same], np.asarray(want.normal)[same], rtol=0, atol=1e-5)
    assert np.array_equal(got.material.numpy()[same], np.asarray(want.material)[same])
    miss = tri < 0
    assert np.all(got.normal.numpy()[miss] == 0.0)
    assert np.all(got.material.numpy()[miss] == 0)


@pytest.fixture(scope="module")
def random_scene():
    return _scenes(make_random_triangles(1200, seed=21))


@pytest.fixture(scope="module")
def coherent_scene():
    return _scenes(
        merge_meshes([make_cube(3.0), make_uv_sphere(1.0, center=(2, 0, 0), rings=10, segments=14)])
    )


def _incoherent(rng, B=4):
    o = rng.uniform(-12, 12, (B, 128, 3)).astype(np.float32)
    d = rng.normal(size=(B, 128, 3)).astype(np.float32)
    return o, d


def test_incoherent_rays_match_jax(random_scene, rng):
    res, jscene, tscene = random_scene
    r9, jr9 = _rays9(*_incoherent(rng))
    ss = res.recommended_stack_size
    # t_max and a live_packets of B share one JAX compile with the prefix case.
    got = kernels.trace_packets(tscene, r9, stack_size=ss, t_max=30.0, live_packets=4)
    _compare(got, trace_packets_pallas(jscene, jr9, stack_size=ss, t_max=30.0, interpret=True, live_packets=4))
    assert torch.equal(got.tri, kernels.trace_packets(tscene, r9, stack_size=ss, t_max=30.0).tri)
    assert (got.tri.numpy() >= 0).mean() > 0.1  # the case exercises hits
    assert np.all(got.overflow.numpy() == 0)
    assert np.all(got.inner_visits.numpy() > 0) and np.all(got.leaf_tests.numpy() > 0)


def test_coherent_camera_packets_match_jax(coherent_scene):
    res, jscene, tscene = coherent_scene
    cam = jax_camera.Camera().look_at((0.0, 0.5, -7.0), (0.5, 0.0, 0.0)).f_number(4.0)
    sampler = cam.build_sampler((32, 32))
    ys, xs = np.mgrid[0:32, 0:32]
    pix = np.stack([xs, ys], -1).reshape(4, 256, 2).astype(np.float32)
    s = np.zeros((4, 256), np.int32)
    pid = (ys * 32 + xs).reshape(4, 256).astype(np.int32)
    rays = jax_camera.sample_rays(sampler, pix, jax.random.key(1), strat=(s, pid, -4, 4096))
    r9, jr9 = _rays9(np.asarray(rays.origin), np.asarray(rays.direction))
    got = kernels.trace_packets(tscene, r9, stack_size=res.recommended_stack_size)
    _compare(got, trace_packets_pallas(jscene, jr9, stack_size=res.recommended_stack_size, interpret=True))
    assert (got.tri.numpy() >= 0).mean() > 0.3


def test_empty_root_misses_everything(rng):
    empty = MeshData()
    res, jscene, tscene = _scenes(empty)
    assert tscene.root == kernels.L.NULL_LINK
    r9, jr9 = _rays9(*_incoherent(rng, B=1))
    got = kernels.trace_packets(tscene, r9, stack_size=8, t_max=50.0)
    _compare(got, trace_packets_pallas(jscene, jr9, stack_size=8, t_max=50.0, interpret=True), 1.0)
    assert np.all(got.tri.numpy() == -1) and np.all(got.t.numpy() == 50.0)
    assert np.all(got.inner_visits.numpy() == 0)


def test_tiny_stack_overflows_on_both_sides(random_scene, rng):
    _, jscene, tscene = random_scene
    r9, jr9 = _rays9(*_incoherent(rng, B=2))
    got = kernels.trace_packets(tscene, r9, stack_size=2)
    want = trace_packets_pallas(jscene, jr9, stack_size=2, interpret=True)
    # Results past a dropped push differ by design; only the counter agrees.
    assert np.all(got.overflow.numpy() > 0)
    assert np.all(np.asarray(want.overflow) > 0)


# The forms a live count takes (None, an int, a one-element integer tensor on
# the rays' device) and the counts at its edges, with the count as an int;
# the rays come in B = 4 packets.
LIVE_COUNTS = {
    "none": (None, 4),
    "int": (2, 2),
    "int32 tensor": (torch.tensor([2], dtype=torch.int32), 2),
    "int64 tensor": (torch.tensor(2, dtype=torch.int64), 2),
    "zero": (0, 0),
    "negative": (-3, -3),
    "above B": (7, 7),
}


@pytest.mark.parametrize("case", list(LIVE_COUNTS))
def test_live_packets_prefix(random_scene, rng, case):
    """Packets at index ``>= live_packets`` write misses without traversal,
    whatever form the count takes: each form gives the int path's hits bit
    for bit and the JAX kernel's, whose count is a traced scalar."""
    live, count = LIVE_COUNTS[case]
    res, jscene, tscene = random_scene
    r9, jr9 = _rays9(*_incoherent(rng))
    ss = res.recommended_stack_size
    got = kernels.trace_packets(tscene, r9, stack_size=ss, t_max=30.0, live_packets=live)
    want = trace_packets_pallas(jscene, jr9, stack_size=ss, t_max=30.0, interpret=True, live_packets=count)
    _compare(got, want)
    as_int = kernels.trace_packets(tscene, r9, stack_size=ss, t_max=30.0, live_packets=count)
    for field in ("t", "tri", "normal", "material", "overflow", "inner_visits", "leaf_tests"):
        assert torch.equal(getattr(got, field), getattr(as_int, field)), field
    n = max(0, min(4, count))
    assert np.all(got.tri.numpy()[n:] == -1) and np.all(got.t.numpy()[n:] == 30.0)
    assert np.all(got.inner_visits.numpy()[n:] == 0) and np.all(got.leaf_tests.numpy()[n:] == 0)
    assert (got.tri.numpy()[:n] >= 0).any() == (n > 0)


def test_stack_size_above_capacity_raises(random_scene, rng):
    _, _, tscene = random_scene
    r9, _ = _rays9(*_incoherent(rng, B=1))
    with pytest.raises(ValueError, match="stack_size"):
        kernels.trace_packets(tscene, r9, stack_size=kernels.STACK_CAPACITY + 1)
