"""``render_frame_pt(shadow_sort=...)``: the order of the NEE shadow
segments, against the JAX package's, on the CPU.

- Each mode's sort key equals the JAX package's key (built from its
  ``_morton16`` and ``_direction_bin`` as its bounce loop builds it) bit
  for bit on the same candidates: the same float32 steps and integer
  operations.
- Frames in Sobol mode with a fixed pairing seed and no shadow roulette:
  occlusion is decided per segment, so the ``"dir"`` and ``"light"`` frames
  equal the ``"pos"`` frame bit for bit. ``"fromlight"`` launches each
  segment reversed, whose rounding can flip a grazing segment: at least 99%
  of pixels within 1e-5 of ``"pos"``, channel means within 0.5%.
- Each mode's frame mean within 1% of the JAX package's frame in that mode
  (32x24 @ 8, 3 bounces, NEE; the JAX side through ``make_xla_tracer``, the
  port through K2's plain version). Both trace the same paths up to float32
  rounding.
- An unknown mode raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minipath_tpu import camera as jax_camera
from minipath_tpu.render import wavefront as jw
from minipath_tpu.scene import materials as jm
from minipath_tpu.scene import procedural as jax_procedural
from minipath_tpu.scene.bvh.build import BvhArrays as JaxBvhArrays
from minipath_tpu.scene.bvh.build import build_bvh as jax_build_bvh
from minipath_tpu_torch.camera import CameraSampler
from minipath_tpu_torch.render import kernels
from minipath_tpu_torch.render import wavefront as tw
from minipath_tpu_torch.scene import materials as tm
from minipath_tpu_torch.scene.bvh.build import from_numpy

MODES = ("pos", "dir", "light", "fromlight")
W, H, SPP, BOUNCES = 32, 24, 8, 3
FROMLIGHT_SHARE, FROMLIGHT_ATOL, FROMLIGHT_MEAN_RTOL = 0.99, 1e-5, 5e-3
JAX_MEAN_RTOL = 0.01


def _jax_key(cand, sh_o, wi, light_i, mode):
    """The JAX bounce loop's shadow sort key (``wavefront.py``'s NEE block),
    step for step."""
    sh_o_safe = jnp.where(cand[..., None], sh_o, 0.0)
    lo = jnp.min(jnp.where(cand[..., None], sh_o_safe, jnp.inf), axis=0)
    hi = jnp.max(jnp.where(cand[..., None], sh_o_safe, -jnp.inf), axis=0)
    scale = 16.0 / jnp.maximum(hi - lo, 1e-6)
    cell = jnp.clip((sh_o_safe - lo) * scale, 0, 15).astype(jnp.int32)
    if mode == "dir":
        skey = (jw._direction_bin(wi) << 12) | jw._morton16(cell)
    elif mode == "light":
        skey = (light_i.astype(jnp.int32) << 12) | jw._morton16(cell)
    elif mode == "fromlight":
        skey = ((jnp.minimum(light_i.astype(jnp.int32), 255) << 19) | (jw._direction_bin(-wi) << 12)
                | jw._morton16(cell))
    else:
        skey = (jw._morton16(cell) << 7) | jw._direction_bin(wi)
    return ((~cand).astype(jnp.int32) << 27) | skey


@pytest.mark.parametrize("mode", MODES)
def test_sort_key_matches_jax_bit_for_bit(mode):
    rng = np.random.default_rng(5)
    n = 5000
    cand = rng.random(n) < 0.7
    sh_o = rng.uniform([-18, 0.5, -8], [18, 12, 8], (n, 3)).astype(np.float32)
    sh_o[~cand] = rng.uniform(-1e3, 1e3, (int((~cand).sum()), 3))  # outside the candidates' box
    wi = rng.normal(size=(n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    light_i = rng.integers(0, 4034, n)
    want = np.asarray(_jax_key(jnp.asarray(cand), jnp.asarray(sh_o), jnp.asarray(wi), jnp.asarray(light_i), mode))
    got = tw.shadow_sort_key(torch.from_numpy(cand), torch.from_numpy(sh_o), torch.from_numpy(wi),
                             torch.from_numpy(light_i), mode).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got[cand] < 1 << 27).all() and (got[~cand] >= 1 << 27).all()


def test_fromlight_launches_the_reversed_interval():
    """Under ``"fromlight"`` a candidate's segment starts at its light end and
    points back; the parked lanes are the same in every mode."""
    rng = np.random.default_rng(6)
    n = 600
    cand = torch.from_numpy(rng.random(n) < 0.5)
    o = torch.from_numpy(rng.uniform(-5, 5, (n, 3)).astype(np.float32))
    seg = torch.from_numpy(rng.uniform(-5, 5, (n, 3)).astype(np.float32))
    wi = seg / seg.norm(dim=1, keepdim=True)
    li = torch.from_numpy(rng.integers(0, 300, n))
    o_f, s_f, n_f, order_f = tw._shadow_batch(cand, o, seg, wi, li, "fromlight")
    k = int(n_f)
    assert k == int(cand.sum())
    torch.testing.assert_close(o_f[:k], (o + seg)[order_f][:k], rtol=0, atol=0)
    torch.testing.assert_close(s_f[:k], -seg[order_f][:k], rtol=0, atol=0)
    o_p, s_p, _, _ = tw._shadow_batch(cand, o, seg, wi, li, "pos")
    assert torch.equal(o_f[k:], o_p[k:]) and torch.equal(s_f[k:], s_p[k:])
    assert (o_f[k:] == 1e9).all()


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="shadow_sort"):
        tw.render_frame_pt(None, None, None, None, None, width=16, height=16, spp=1, shadow_sort="nearest",
                           env=tm.Environment.none("cpu"))
    with pytest.raises(ValueError, match="shadow_sort"):
        tw._pt_trace(None, None, None, torch.zeros(1, 9, 256), None, tracer=None, samples=1, bounces=1,
                     compaction=False, shadow_sort="random")


def _bench_camera(cls):
    return cls().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(36e-3)


@pytest.fixture(scope="module")
def frames():
    """Each mode's frame through both packages, on ``make_atrium(0)`` with
    its benchmark materials (built once by the JAX builder)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    mesh = jax_procedural.make_atrium(0)
    ids, dicts = jax_procedural.atrium_materials(mesh)
    res = jax_build_bvh(mesh, materials=ids, leaf_max=24)
    stack = res.recommended_stack_size
    kw = dict(width=W, height=H, spp=SPP, bounces=BOUNCES, samples_per_packet=SPP, sobol=True, shadow_rr=False,
              strat_seed=24680)
    jarrays = JaxBvhArrays(*(jnp.asarray(a) for a in res.arrays))
    jtracer, _ = jw.make_xla_tracer(jarrays, stack_size=stack)
    jshadow, _ = jw.make_xla_shadow_tracer(jarrays, stack_size=stack)
    jtable = jm.material_table(dicts)
    jlights = jm.build_light_table(res.arrays.tri_packets, res.arrays.tri_material, jtable)
    jsampler = _bench_camera(jax_camera.Camera).build_sampler((W, H))
    scene = kernels.prepare_scene_pt(from_numpy(res.arrays._asdict(), "cpu"))
    tracer, _ = tw.make_pt_tracer(scene, stack_size=stack)
    shadow, _ = tw.make_pt_shadow_tracer(scene, stack_size=stack)
    table = tm.material_table(dicts, "cpu")
    lights = tm.build_light_table(res.arrays.tri_packets, res.arrays.tri_material, table)
    sampler = CameraSampler.from_numpy({k: np.asarray(v) for k, v in jsampler._asdict().items()}, "cpu")
    out = {}
    for mode in MODES:
        want = np.asarray(jw.render_frame_pt(jtracer, jarrays, jtable, jsampler, jax.random.key(0),
                                             lights=jlights, shadow_tracer=jshadow, shadow_sort=mode, **kw))
        got = tw.render_frame_pt(tracer, scene, table, sampler, None, lights=lights, shadow_tracer=shadow,
                                 shadow_sort=mode, **kw).numpy()
        out[mode] = (got, want)
    torch.set_num_threads(n)
    return out


@pytest.mark.parametrize("mode", ["dir", "light"])
def test_reordering_modes_equal_pos_bit_for_bit(frames, mode):
    np.testing.assert_array_equal(frames[mode][0], frames["pos"][0])


def test_fromlight_frame_agrees_with_pos(frames):
    got, pos = frames["fromlight"][0], frames["pos"][0]
    close = np.all(np.abs(got - pos) <= FROMLIGHT_ATOL, axis=-1)
    assert close.mean() >= FROMLIGHT_SHARE, close.mean()
    np.testing.assert_allclose(got[..., :3].mean(axis=(0, 1)), pos[..., :3].mean(axis=(0, 1)),
                               rtol=FROMLIGHT_MEAN_RTOL)


@pytest.mark.parametrize("mode", MODES)
def test_frame_mean_matches_jax(frames, mode):
    got, want = frames[mode]
    assert got.shape == want.shape == (H, W, 4) and np.isfinite(got).all()
    assert got[..., :3].mean() > 0.05
    np.testing.assert_allclose(got[..., :3].mean(), want[..., :3].mean(), rtol=JAX_MEAN_RTOL)
