"""The port's small helpers against the JAX package's: ``point_at`` and
``advance_by`` (``geometry/ray.py``) on tests/test_geometry.py's cases and
on seeded batches (within 1e-6: the same float32 multiply and add), and
``bit_iter`` (``utils/__init__.py``) on tests/test_quantize.py's cases."""

import numpy as np
import pytest
import torch

from minipath_tpu.geometry import ray as jax_ray
from minipath_tpu.utils import bit_iter as jax_bit_iter
from minipath_tpu_torch.geometry.ray import advance_by, make_rays, point_at
from minipath_tpu_torch.utils import bit_iter


def _both(origin, direction):
    o, d = np.asarray(origin, np.float32), np.asarray(direction, np.float32)
    return make_rays(torch.from_numpy(o), torch.from_numpy(d)), jax_ray.make_rays(o, d)


def test_point_at_and_advance():
    r, jr = _both([1, 2, 3], [0, 0, 2])
    np.testing.assert_allclose(point_at(r, 5.0).numpy(), [1, 2, 8], atol=1e-6)
    r2 = advance_by(r, 2.0)
    np.testing.assert_allclose(r2.origin.numpy(), [1, 2, 5], atol=1e-6)
    np.testing.assert_allclose(point_at(r, 5.0).numpy(), np.asarray(jax_ray.point_at(jr, 5.0)), atol=1e-6)
    assert torch.equal(r2.direction, r.direction) and torch.equal(r2.inv_direction, r.inv_direction)


def test_point_at_and_advance_batches_match_jax():
    rng = np.random.default_rng(6)
    o, d = rng.normal(size=(2, 64, 3)), rng.normal(size=(2, 64, 3))
    t = rng.uniform(0, 10, (2, 64)).astype(np.float32)
    r, jr = _both(o, d)
    np.testing.assert_allclose(point_at(r, torch.from_numpy(t)).numpy(), np.asarray(jax_ray.point_at(jr, t)),
                               rtol=1e-6, atol=1e-6)
    got, want = advance_by(r, torch.from_numpy(t)), jax_ray.advance_by(jr, t)
    for name in ("origin", "direction", "inv_direction"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mask", [0, 0b1, 0b10110001, 1 << 63, (1 << 64) - 1, 0x8000_0000_0001])
def test_bit_iter_matches_jax(mask):
    assert list(bit_iter(mask)) == list(jax_bit_iter(mask))
    assert list(bit_iter(mask)) == [i for i in range(mask.bit_length()) if mask >> i & 1]


def test_bit_iter_cases():
    assert list(bit_iter(0)) == []
    assert list(bit_iter(0b1)) == [0]
    assert list(bit_iter(0b10110001)) == [0, 4, 5, 7]
    assert list(bit_iter(1 << 63)) == [63]
    with pytest.raises(ValueError):
        list(bit_iter(-1))
