"""The port's analytic sphere against the JAX package's, and ``render()`` of
it.

Tolerances, each with its reason:

- ``Sphere.intersect`` on the same float32 rays: the same elementwise steps
  on both sides, so ``hit`` and ``material`` are equal and ``t``, ``point``
  and ``normal`` agree within 1e-6 (a three-term sum may associate
  differently). The grazing rays pass 0.1% of the radius inside or outside
  the silhouette, clear of that rounding.
- ``render()`` of a sphere against the JAX ``render()``: independent film
  jitter on each side (threefry there, a ``torch.Generator`` here), so alpha
  coverage within 1% and mean value within 2% at 16 spp, as
  ``test_torch_render.py`` holds the triangle path.
- Against ``render()`` of a finely tessellated ``make_uv_sphere`` (64 rings,
  128 segments: the mesh lies at most 0.03% inside the sphere and its smooth
  normals equal the sphere's at the vertices): coverage within 0.5% and mean
  value within 1%, the same seed on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minipath_tpu import Camera as JaxCamera
from minipath_tpu import RenderSettings as JaxRenderSettings
from minipath_tpu import Scene as JaxScene
from minipath_tpu import render as jax_render
from minipath_tpu.geometry.ray import Rays as JaxRays
from minipath_tpu.scene.primitives import Sphere as JaxSphere
from minipath_tpu_torch import Camera, RenderSettings, Scene, Sphere, TriangleBvh, render
from minipath_tpu_torch.geometry.ray import Rays
from minipath_tpu_torch.render import kernels
from minipath_tpu_torch.scene import procedural

CENTER, RADIUS = (0.5, -0.25, 1.0), 1.5


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _rays(seed=0, n=400):
    """Seeded rays in five groups: from inside the sphere, from outside
    toward it, grazing its silhouette just inside and just outside, and
    pointing away from it (the sphere behind the ray)."""
    rng = np.random.default_rng(seed)
    c = np.float32(CENTER)
    inside_o = c + _unit(rng.normal(size=(n, 3))) * rng.uniform(0.0, 0.9 * RADIUS, (n, 1)).astype(np.float32)
    inside_d = _unit(rng.normal(size=(n, 3)))
    out_o = c + _unit(rng.normal(size=(n, 3))) * rng.uniform(2.0, 6.0, (n, 1)).astype(np.float32) * RADIUS
    toward = c + _unit(rng.normal(size=(n, 3))) * rng.uniform(0.0, 0.8 * RADIUS, (n, 1)).astype(np.float32)
    out_d = _unit(toward - out_o)
    # Grazing: the line of sight turned by the angle whose sine is rho / D,
    # so that the ray passes the centre at distance rho.
    dist = np.linalg.norm(c - out_o, axis=-1, keepdims=True)
    axis = _unit(c - out_o)
    side = _unit(np.cross(axis, _unit(rng.normal(size=(n, 3)))))

    def graze(rho):
        sin = rho / dist
        return _unit(axis * np.sqrt(1.0 - sin * sin) + side * sin)

    graze_in_d, graze_out_d = graze(RADIUS * 0.999), graze(RADIUS * 1.001)
    origin = np.concatenate([inside_o, out_o, out_o, out_o, out_o]).astype(np.float32)
    direction = np.concatenate([inside_d, out_d, graze_in_d, graze_out_d, -out_d]).astype(np.float32)
    return origin, direction


def _both(origin, direction, t_max=None, material=0):
    with np.errstate(divide="ignore"):
        inv = np.where(direction == 0, np.inf, 1.0 / direction).astype(np.float32)
    kw = {} if t_max is None else {"t_max": t_max}
    want = JaxSphere(CENTER, RADIUS, material).intersect(
        JaxRays(jnp.asarray(origin), jnp.asarray(direction), jnp.asarray(inv)), **kw)
    got = Sphere(CENTER, RADIUS, material).intersect(
        Rays(torch.from_numpy(origin), torch.from_numpy(direction), torch.from_numpy(inv)), **kw)
    return got, want


@pytest.mark.parametrize("t_max", [None, 4.0], ids=["unbounded", "t_max_4"])
def test_sphere_intersect_matches_jax(t_max):
    origin, direction = _rays()
    n = origin.shape[0] // 5
    got, want = _both(origin, direction, t_max, material=3)
    hit = got.hit.numpy()
    np.testing.assert_array_equal(hit, np.asarray(want.hit))
    np.testing.assert_array_equal(got.material.numpy(), np.asarray(want.material))
    assert got.material.dtype == torch.int32 and int(got.material[0]) == 3
    np.testing.assert_array_equal(got.texture_coords.numpy(), np.asarray(want.texture_coords))
    np.testing.assert_array_equal(np.isinf(got.t.numpy()), ~hit)
    for f in ("t", "point", "normal"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        np.testing.assert_allclose(a[hit], b[hit], rtol=0, atol=1e-6, err_msg=f)
    # The groups behave as built (without a t_max): inside and toward hit,
    # the inner grazing rays hit, the outer ones and the rays pointing away
    # miss; from inside the far root is taken, so the normal faces along the
    # ray.
    if t_max is None:
        assert hit[: 3 * n].all() and not hit[3 * n :].any()
        facing = np.sum(got.normal.numpy() * direction, axis=-1)
        assert (facing[:n] > 0).all() and (facing[n : 2 * n] < 0).all()
        np.testing.assert_allclose(np.linalg.norm(got.normal.numpy()[hit], axis=-1), 1.0, atol=1e-5)
    else:
        assert hit.any() and not hit[: 3 * n].all() and (got.t.numpy()[hit] < t_max).all()


def test_sphere_bounding_box_and_fields():
    s, j = Sphere(CENTER, RADIUS), JaxSphere(CENTER, RADIUS)
    box, jbox = s.get_bounding_box(), j.get_bounding_box()
    np.testing.assert_array_equal(box.min, jbox.min)
    np.testing.assert_array_equal(box.max, jbox.max)
    assert Sphere() == Sphere((0.0, 0.0, 0.0), 1.0, 0) and hash(Sphere()) == hash(Sphere())


def _camera(cls):
    return cls().look_at((0, 0.5, 5), (0, 0, 0)).f_number(4.8).focus_distance(5)


def _stats(img):
    img = img.astype(np.float64) / 255
    return img[..., 3].mean(), img[..., 0].mean()


@pytest.fixture(scope="module")
def sphere_frame():
    p = render(Scene(Sphere()), _camera(Camera), RenderSettings(16, 16, (64, 48)), device="cpu", seed=7)
    p.wait()
    return p


def test_render_sphere_launches_no_kernel_and_fills_the_frame(sphere_frame):
    img = sphere_frame.image()
    assert img.shape == (48, 64, 4) and img.dtype == np.uint8
    assert sphere_frame.progress().finished == sphere_frame.progress().total == 12
    cov, mean = _stats(img)
    assert 0.05 < cov < 0.5 and mean > 0.02
    # Grey: r == g == b, and nothing where the alpha is zero.
    assert np.array_equal(img[..., 0], img[..., 1]) and np.array_equal(img[..., 0], img[..., 2])
    assert not img[img[..., 3] == 0].any()


def test_render_sphere_tile_mode_equals_frame_mode(sphere_frame):
    events = []
    p = render(Scene(Sphere()), _camera(Camera), RenderSettings(16, 16, (64, 48)),
               lambda t: events.append("start"), lambda t, s: events.append("finish"), device="cpu", seed=7)
    p.wait()
    assert events.count("start") == events.count("finish") == 12
    np.testing.assert_array_equal(p.image(), sphere_frame.image())


def test_render_sphere_matches_jax_render_statistically(sphere_frame):
    pj = jax_render(JaxScene(JaxSphere()), _camera(JaxCamera), JaxRenderSettings(16, 16, (64, 48)))
    pj.wait()
    (cov, mean), (jcov, jmean) = _stats(sphere_frame.image()), _stats(pj.image())
    assert abs(cov - jcov) <= 0.01
    assert abs(mean - jmean) <= 0.02 * jmean


def test_render_sphere_matches_a_fine_mesh(sphere_frame):
    bvh = TriangleBvh.build(procedural.make_uv_sphere(1.0, rings=64, segments=128))
    launches = kernels.trace_packets.launches
    p = render(Scene(bvh), _camera(Camera), RenderSettings(16, 16, (64, 48)), device="cpu", seed=7)
    p.wait()
    assert kernels.trace_packets.launches == launches  # a CPU tensor launches no kernel either
    (cov, mean), (mcov, mmean) = _stats(sphere_frame.image()), _stats(p.image())
    assert abs(cov - mcov) <= 0.005
    assert abs(mean - mmean) <= 0.01 * mmean


@pytest.mark.parametrize("obj", [object(), "sphere", None], ids=["object", "str", "none"])
def test_render_rejects_any_other_object(obj):
    with pytest.raises(TypeError, match="Unsupported scene object"):
        render(Scene(obj), _camera(Camera), RenderSettings(16, 1, (16, 16)), device="cpu")
