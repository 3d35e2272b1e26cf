"""The port's camera and sample dimensions against the JAX package's: the
integer hashes and Sobol points bit for bit, the strata within one ulp, and
camera rays in Sobol mode within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minipath_tpu import camera as jax_camera
from minipath_tpu.geometry.ray import make_rays as jax_make_rays
from minipath_tpu.render import stratify as jax_stratify
from minipath_tpu_torch import camera
from minipath_tpu_torch.geometry.ray import make_rays
from minipath_tpu_torch.render import stratify


def _ints(rng, n=4096):
    return rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64) & 0xFFFFFFFF


def test_hash_u32_bit_exact(rng):
    x = _ints(rng)
    want = _u32(jax_stratify._hash_u32(jnp.asarray(x)))
    got = stratify._hash_u32(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("spp,salt", [(1, 0), (7, 3), (16, 4096), (100, 4097)])
def test_hash_shift_bit_exact(rng, spp, salt):
    pid = _ints(rng)
    want = np.asarray(jax_stratify.hash_shift(jnp.asarray(pid), spp, salt))
    got = stratify.hash_shift(torch.from_numpy(pid), spp, salt).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("salt", [0, 4096, 4097])
def test_sobol_bit_exact(rng, salt):
    s = rng.integers(0, 1 << 20, 4096).astype(np.int32)
    pid = _ints(rng)
    want1 = np.asarray(jax_stratify.sobol1d(jnp.asarray(s), jnp.asarray(pid), salt))
    got1 = stratify.sobol1d(torch.from_numpy(s), torch.from_numpy(pid), salt).numpy()
    assert np.array_equal(got1, want1)
    wx, wy = jax_stratify.sobol2d(jnp.asarray(s), jnp.asarray(pid), salt)
    gx, gy = stratify.sobol2d(torch.from_numpy(s), torch.from_numpy(pid), salt)
    assert np.array_equal(gx.numpy(), np.asarray(wx))
    assert np.array_equal(gy.numpy(), np.asarray(wy))


@pytest.mark.parametrize("spp", [1, 4, 6, 7, 16])
def test_strata_within_one_ulp(rng, spp):
    n = 4096
    u1 = rng.random(n, dtype=np.float32)
    u2 = rng.random(n, dtype=np.float32)
    s = rng.integers(0, spp, n).astype(np.int32)
    pid = _ints(rng, n)
    ulp = np.spacing(np.float32(1.0))  # values lie in [0, 1)
    w = jax_stratify.strat1d(jnp.asarray(u1), jnp.asarray(s), jnp.asarray(pid), spp, 3)
    g = stratify.strat1d(torch.from_numpy(u1), torch.from_numpy(s), torch.from_numpy(pid), spp, 3)
    assert np.max(np.abs(g.numpy() - np.asarray(w))) <= ulp
    wx, wy = jax_stratify.strat2d(
        jnp.asarray(u1), jnp.asarray(u2), jnp.asarray(s), jnp.asarray(pid), spp, 5
    )
    gx, gy = stratify.strat2d(
        torch.from_numpy(u1), torch.from_numpy(u2), torch.from_numpy(s), torch.from_numpy(pid), spp, 5
    )
    assert np.max(np.abs(gx.numpy() - np.asarray(wx))) <= ulp
    assert np.max(np.abs(gy.numpy() - np.asarray(wy))) <= ulp
    assert stratify.grid_factor(spp) == jax_stratify.grid_factor(spp)


def _camera():
    return (
        jax_camera.Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(2.0).sensor_width(36e-3),
        camera.Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(2.0).sensor_width(36e-3),
    )


def test_sampler_matches_and_from_numpy_carries_it():
    jcam, tcam = _camera()
    js = jcam.build_sampler((64, 48))
    ts = tcam.build_sampler((64, 48), "cpu")
    carried = camera.CameraSampler.from_numpy({k: np.asarray(v) for k, v in js._asdict().items()}, "cpu")
    for name in js._fields:
        assert np.array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name))), name
        assert torch.equal(getattr(carried, name), getattr(ts, name)), name


def test_sample_rays_sobol_matches_jax(rng):
    jcam, tcam = _camera()
    spp, salt = 8, 4096
    js = jcam.build_sampler((64, 48))
    ts = tcam.build_sampler((64, 48), "cpu")
    pix = rng.integers(0, 48, (6, 256, 2)).astype(np.float32)
    s = rng.integers(0, spp, (6, 256)).astype(np.int32)
    pid = _ints(rng, 6 * 256).reshape(6, 256)
    want = jax_camera.sample_rays(
        js, jnp.asarray(pix), jax.random.key(0), strat=(jnp.asarray(s), jnp.asarray(pid), -spp, salt)
    )
    got = camera.sample_rays(
        ts, torch.from_numpy(pix), None, strat=(torch.from_numpy(s), torch.from_numpy(pid), -spp, salt)
    )
    for name in ("origin", "direction"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=0, atol=1e-6)


def test_sample_rays_iid_draws_from_generator():
    _, tcam = _camera()
    ts = tcam.build_sampler((64, 48), "cpu")
    pix = torch.zeros((2, 128, 2))
    a = camera.sample_rays(ts, pix, torch.Generator().manual_seed(1))
    b = camera.sample_rays(ts, pix, torch.Generator().manual_seed(1))
    c = camera.sample_rays(ts, pix, torch.Generator().manual_seed(2))
    assert torch.equal(a.direction, b.direction)
    assert not torch.equal(a.direction, c.direction)
    assert torch.allclose(torch.linalg.norm(a.direction, dim=-1), torch.ones(2, 128), atol=1e-6)


def test_make_rays_zero_components_invert_to_plus_inf():
    o = np.zeros((4, 3), np.float32)
    d = np.array([[0.0, -0.0, 1.0], [-0.0, 1.0, 0.0], [1.0, 0.0, -0.0], [0.3, -0.4, 0.5]], np.float32)
    got = make_rays(torch.from_numpy(o), torch.from_numpy(d))
    want = jax_make_rays(o, d)
    zero = d == 0.0
    assert np.all(got.inv_direction.numpy()[zero] == np.inf)
    np.testing.assert_array_equal(got.inv_direction.numpy(), np.asarray(want.inv_direction))
    np.testing.assert_allclose(got.direction.numpy(), np.asarray(want.direction), rtol=0, atol=1e-7)
